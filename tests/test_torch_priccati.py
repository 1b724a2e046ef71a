"""The PyTorch port's parallel-in-time Riccati pass
(``solvers.priccati.parallel_backward_pass``) against the JAX package,
float64 on the CPU:

- at tests/test_priccati.py's candidate on iris hover, dt 100 ms (T = 11),
  both ``feasible`` flags, regularization 0 and 1e-3: the port's pass on
  JAX's node derivatives and gaps against JAX's parallel pass and JAX's
  sequential pass (tests/fixtures/torch_port_parallel.npz), Vxx and Vx
  to rtol 1e-8 / atol 1e-8, k, K and Qu to rtol 1e-8 / atol 1e-9;
- at the flagship's offline reference solution (T = 132, its last
  homotopy stage, reg 1e-9), where the scan is ill-conditioned: there
  JAX's own parallel pass lies 3.4e-3 (Vxx) to 5.7e-2 (k) from its
  sequential one, relative to each output's largest entry; the port's
  parallel pass on JAX's derivatives within 1e-5 of JAX's parallel pass
  (1.9e-6 measured on a CPU) and its sequential pass within 1e-6 of JAX's
  (2.0e-7 measured, in k: at a converged state k is a small difference
  of large terms);
- against the port's own sequential pass on seeded random positive
  definite data at T = 550 (B = 2), rtol 1e-6;
- a stage Hessian that is not positive definite in one element: NaN and
  ``ok`` False there only;
- the fixed-depth path refuses ``parallel_riccati``;
- the full FDDP solve with ``parallel_riccati=True`` against JAX's
  (iterations and feasibility equal, cost rtol 1e-8, xs rtol 1e-6 /
  atol 1e-8) and against JAX's sequential solve (test_priccati.py's
  tolerances).
"""

import os

import numpy as np
import pytest
import torch

from eagle_mpc_tpu_torch import config as port_config
from eagle_mpc_tpu_torch.ocp import problem as P
from eagle_mpc_tpu_torch.solvers import fddp, priccati, sbfddp

from torch_port_util import CPU, F64, MISSIONS, t

PARALLEL = os.path.join(os.path.dirname(__file__), "fixtures",
                        "torch_port_parallel.npz")
REGS = (0.0, 1e-3)
TOL = {"Vxx": (1e-8, 1e-8), "Vx": (1e-8, 1e-8), "k": (1e-8, 1e-9),
       "K": (1e-8, 1e-9), "Qu": (1e-8, 1e-9)}


@pytest.fixture(scope="module")
def fx():
    return np.load(PARALLEL)


@pytest.fixture(scope="module")
def hover():
    traj = port_config.load_trajectory("iris/trajectories/hover.yaml",
                                       yaml_dir=MISSIONS)
    spec, params = P.from_trajectory(traj, dt_ms=100, use_squash=True,
                                     integrator="IntegratedActionModelEuler",
                                     dtype=F64, device=CPU)
    return spec, P.expand_params(params, 1)


def _jax_inputs(fx):
    """JAX's node derivatives and terminal terms at the candidate, B = 1."""
    derivs = P.NodeDerivatives(*(t(fx[f"pr_d_{n}"])[None]
                                 for n in P.NodeDerivatives._fields))
    term = tuple(t(fx[f"pr_term_{i}"])[None] for i in range(3))
    return derivs, term


@pytest.mark.parametrize("feasible", [False, True])
@pytest.mark.parametrize("reg", REGS)
def test_backward_pass_matches_jax(hover, fx, feasible, reg):
    spec, _ = hover
    derivs, term = _jax_inputs(fx)
    fs = t(fx[f"pr_fs_{int(feasible)}"])[None]
    r = torch.full((1,), reg, dtype=F64)
    bp = priccati.parallel_backward_pass(spec, derivs, term, fs, r, r,
                                         torch.tensor([feasible]))
    assert bp.ok.shape == (1,) and bool(bp.ok[0])
    for kind in ("par", "seq"):
        key = f"pr_{kind}_{int(feasible)}_{reg:g}"
        assert bool(fx[f"{key}_ok"])
        for n, (rtol, atol) in TOL.items():
            np.testing.assert_allclose(getattr(bp, n)[0].numpy(),
                                       fx[f"{key}_{n}"], rtol=rtol, atol=atol,
                                       err_msg=f"{kind} {n}")
    np.testing.assert_allclose(bp.Quuk[0].numpy(),
                               fx[f"pr_par_{int(feasible)}_{reg:g}_Quuk"],
                               rtol=1e-8, atol=1e-9)


def test_flagship_solution_matches_jax(fx):
    """The flagship at the offline solution: the port's parallel pass
    follows JAX's parallel pass, not the sequential one, where the two
    algorithms part."""
    derivs = P.NodeDerivatives(*(t(fx[f"flag_d_{n}"])[None]
                                 for n in P.NodeDerivatives._fields))
    term = tuple(t(fx[f"flag_term_{i}"])[None] for i in range(3))
    fs = t(fx["flag_fs"])[None]
    spec = type("Spec", (), {"nu": 9, "state": type("St", (), {"ndx": 18})})
    r = torch.full((1,), 1e-9, dtype=F64)
    feas = torch.tensor([False])
    par = priccati.parallel_backward_pass(spec, derivs, term, fs, r, r, feas)
    seq = fddp._backward_pass(spec, derivs, term, fs, r, r, feas)
    rel = lambda a, b: np.abs(a - b).max() / np.abs(b).max()
    assert bool(par.ok[0]) and bool(seq.ok[0])
    for n in ("k", "K", "Qu", "Vx", "Vxx"):
        jp, js = fx[f"flag_par_{n}"], fx[f"flag_seq_{n}"]
        assert rel(getattr(par, n)[0].numpy(), jp) <= 1e-5, n
        assert rel(getattr(seq, n)[0].numpy(), js) <= 1e-6, n
    assert rel(fx["flag_par_Vxx"], fx["flag_seq_Vxx"]) > 1e-3


def test_long_horizon_matches_sequential():
    """T = 550: the log-depth scan against the port's sequential pass."""
    spec = type("Spec", (), {"nu": 4, "state": type("St", (), {"ndx": 12})})
    derivs, term, fs = priccati.random_lqr(2, 550, 12, 4, seed=3)
    reg = torch.full((2,), 1e-9, dtype=F64)
    feas = torch.tensor([False, True])
    fs[1] = 0.0          # a feasible element has no gaps (fddp._gaps)
    par = priccati.parallel_backward_pass(spec, derivs, term, fs, reg, reg,
                                          feas)
    seq = fddp._backward_pass(spec, derivs, term, fs, reg, reg, feas)
    assert bool(par.ok.all()) and bool(seq.ok.all())
    for n in ("k", "K", "Vx", "Vxx", "Qu"):
        np.testing.assert_allclose(getattr(par, n).numpy(),
                                   getattr(seq, n).numpy(), rtol=1e-6,
                                   atol=1e-9, err_msg=n)


def test_non_pd_stage_hessian_fails_alone():
    """An indefinite Luu in element 1 of 3: NaN gains and ``ok`` False
    there; elements 0 and 2 equal their solo passes."""
    spec = type("Spec", (), {"nu": 4, "state": type("St", (), {"ndx": 12})})
    derivs, term, fs = priccati.random_lqr(3, 20, 12, 4, seed=5)
    Luu = derivs.Luu.clone()
    Luu[1, 7] = -torch.eye(4, dtype=F64)
    derivs = derivs._replace(Luu=Luu)
    reg = torch.zeros(3, dtype=F64)
    feas = torch.zeros(3, dtype=torch.bool)
    bp = priccati.parallel_backward_pass(spec, derivs, term, fs, reg, reg,
                                         feas)
    assert bp.ok.tolist() == [True, False, True]
    assert bool(torch.isnan(bp.k[1]).any())
    for b in (0, 2):
        one = lambda a: a[b:b + 1]
        solo = priccati.parallel_backward_pass(
            spec, P.NodeDerivatives(*map(one, derivs)), tuple(map(one, term)),
            one(fs), one(reg), one(reg), one(feas))
        for n in ("k", "K", "Vx", "Vxx"):
            np.testing.assert_allclose(getattr(bp, n)[b].numpy(),
                                       getattr(solo, n)[0].numpy(),
                                       rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("entry", ["solve_fixed", "solve_while_fixed_body",
                                   "sbfddp.solve_fixed"])
def test_fixed_path_refuses_parallel_riccati(hover, entry):
    spec, params = hover
    st = fddp.SolverSettings(parallel_riccati=True)
    xs, us = fddp.default_init(spec, params)
    with pytest.raises(ValueError, match="parallel_riccati"):
        if entry == "solve_fixed":
            fddp.solve_fixed(spec, st, params, xs, us, 2, 1e-9)
        elif entry == "solve_while_fixed_body":
            fddp.solve_while_fixed_body(spec, st, params, xs, us,
                                        torch.full((1,), 2), 1e-9)
        else:
            sbfddp.solve_fixed(spec, params, xs, us,
                               settings=sbfddp.SbFddpSettings(solver=st))


def test_full_solve_matches_jax(hover, fx):
    spec, params = hover
    xs0, us0 = fddp.default_init(spec, params)
    res = fddp.solve_fddp(spec, fddp.SolverSettings(parallel_riccati=True),
                          params, xs0, us0, 30, 1e-9)
    for n in ("iters", "feasible"):
        assert getattr(res, n).item() == fx[f"full_par_{n}"].item(), n
    np.testing.assert_allclose(res.cost.item(), fx["full_par_cost"], rtol=1e-8)
    np.testing.assert_allclose(res.xs[0].numpy(), fx["full_par_xs"],
                               rtol=1e-6, atol=1e-8)
    # tests/test_priccati.py: the parallel solve against the sequential one
    assert res.feasible.item() == fx["full_seq_feasible"].item()
    np.testing.assert_allclose(res.cost.item(), fx["full_seq_cost"],
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(res.xs[0].numpy(), fx["full_seq_xs"],
                               rtol=1e-4, atol=1e-6)
