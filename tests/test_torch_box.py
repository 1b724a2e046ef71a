"""The PyTorch port's box solvers against the JAX package, float64 on the
CPU (the kernels' plain versions), with the JAX values from
tests/fixtures/torch_port_offline.npz (``tools/make_torch_port_fixtures.py
offline``):

- Box-FDDP and Box-DDP (the while loop) on iris hover at dt 40 ms without
  the squash (T = 27): iterations, feasibility and failure equal, cost to
  rtol 1e-9, states and controls to 1e-8, controls within their bounds;
- the fixed iteration with ``box=True`` against the port's own Box-FDDP
  over their first 5 iterations: controls to 1e-8 (the JAX package's
  tests/test_fixed.py holds the whole solves);
- the plain pieces: ``_boxqp`` on random SPD problems with finite,
  infinite and active bounds (1e-12), and the line search with the clip
  (K2's plain version with the terminal node and the divergence flags)
  against JAX's ``_forward_pass(box=True)`` for the 10 alphas (1e-10
  relative to each output's largest entry, equal flags);
- the deviation switches of the accept rule and the stopping test, and a
  controller whose MPC file names a box solver routing to it.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from eagle_mpc_tpu_torch import config as port_config
from eagle_mpc_tpu_torch.config import specs as cspecs
from eagle_mpc_tpu_torch.ocp import problem as P
from eagle_mpc_tpu_torch.solvers import fddp

from torch_port_util import (CPU, DT_REF, F64, FLAGSHIP, MISSIONS,
                             flagship_ref, load_port, rel_err, t)

OFFLINE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "torch_port_offline.npz")


@pytest.fixture(scope="module")
def fx():
    return np.load(OFFLINE)


@pytest.fixture(scope="module")
def box():
    """iris hover at dt 40 ms on raw controls, B = 1, and its Box-FDDP."""
    traj = port_config.load_trajectory("iris/trajectories/hover.yaml",
                                       yaml_dir=MISSIONS)
    spec, params = P.from_trajectory(traj, dt_ms=40, use_squash=False,
                                     integrator="IntegratedActionModelEuler",
                                     device=CPU)
    pb = P.expand_params(params, 1)
    xs0, us0 = fddp.default_init(spec, pb)
    res = fddp.solve_box_fddp(spec, fddp.SolverSettings(), pb, xs0, us0, 60,
                              1e-9)
    return spec, pb, xs0, us0, res


def _check_solve(fx, name, r, pb):
    for n in ("iters", "feasible", "failed"):
        assert getattr(r, n)[0].item() == fx[f"{name}_{n}"].item(), n
    np.testing.assert_allclose(r.cost[0].item(), fx[f"{name}_cost"],
                               rtol=1e-9)
    for n in ("xs", "us"):
        np.testing.assert_allclose(getattr(r, n)[0].numpy(), fx[f"{name}_{n}"],
                                   rtol=0, atol=1e-8, err_msg=n)
    u = r.us[0]
    assert bool((u >= pb.glob.s_lb[0] - 1e-9).all())
    assert bool((u <= pb.glob.s_ub[0] + 1e-9).all())


def test_box_fddp_matches_jax(box, fx):
    spec, pb, _, _, res = box
    assert spec.T == 27 and not spec.use_squash and spec.model.nj == 0
    assert int(res.iters[0]) == 21
    _check_solve(fx, "boxfddp", res, pb)


def test_box_ddp_matches_jax(box, fx):
    spec, pb, xs0, us0, _ = box
    r = fddp.solve_box_ddp(spec, fddp.SolverSettings(), pb, xs0, us0, 60, 1e-9)
    _check_solve(fx, "boxddp", r, pb)


def test_fixed_box_matches_while(box):
    """The first 5 iterations from the cold start (chip_smoke.py holds the
    whole solve, 21 iterations, on the card)."""
    spec, pb, xs0, us0, _ = box
    settings = fddp.SolverSettings()
    rw = fddp.solve_box_fddp(spec, settings, pb, xs0, us0, 5, 1e-9)
    r = fddp.solve_fixed(spec, settings, pb, xs0, us0, 5, 1e-9, box=True)
    assert int(r.iters[0]) == int(rw.iters[0]) == 5
    np.testing.assert_allclose(r.us.numpy(), rw.us.numpy(), rtol=0,
                               atol=1e-8)


def test_boxqp_matches_jax(fx):
    x, free = fddp._boxqp(*(t(fx[f"boxqp_{n}"]) for n in
                            ("H", "q", "lo", "hi", "x0")), 12)
    np.testing.assert_array_equal(free.numpy(), fx["boxqp_free"])
    assert not free.all() and np.isinf(fx["boxqp_lo"]).any()
    np.testing.assert_allclose(x.numpy(), fx["boxqp_x"], rtol=0, atol=1e-12)


def test_box_line_search_matches_jax(box, fx):
    spec, pb, _, _, _ = box
    settings = fddp.SolverSettings()
    B = 2
    params = P.expand_params(P.map_params(lambda a: a[0], pb), B)
    k, K, fs = (t(fx[f"fpbox_{n}"]) for n in ("k", "K", "fs"))
    bp = fddp.BackwardPassData(k=k, K=K, Qu=k, Quuk=k, Vx=fs, Vxx=None,
                               ok=None)
    alphas = torch.tensor(settings.alphas, dtype=F64)
    got = fddp._forward_pass_multi(
        spec, settings, params, t(fx["fpbox_xs"]), t(fx["fpbox_us"]), bp, fs,
        alphas, torch.as_tensor(fx["fpbox_feasible"]), ddp=False, box=True)
    diverged = fx["fpbox_diverged"]
    assert np.array_equal(diverged, got[3].numpy())
    ok = ~diverged
    assert ok.any()
    clipped = (got[1] == pb.glob.s_lb[0]) | (got[1] == pb.glob.s_ub[0])
    assert bool(clipped.any())
    for name, b in zip(("xs_try", "us_try", "cost_try"), got[:3]):
        assert rel_err(fx[f"fpbox_{name}"][ok], b.numpy()[ok]) < 1e-10, name


@pytest.mark.parametrize("switch", ["crocoddyl_signed_d0",
                                    "crocoddyl_negstep_always",
                                    "crocoddyl_signed_stop"])
def test_deviation_switches(switch):
    """Each switch restores the reference's (Crocoddyl's) semantics in the
    accept rule or the stopping test, as the JAX package's
    tests/test_deviations.py pins them: a strongly negative d0 is
    stationary only when signed; a feasible candidate takes the negative
    step only with negstep_always; a cost increase stops only when
    signed."""
    default = fddp.SolverSettings()
    ref = fddp.SolverSettings(**{switch: True})
    alphas = torch.tensor([1.0], dtype=F64)
    one = lambda v: torch.tensor([[v]], dtype=F64)
    if switch == "crocoddyl_signed_stop":
        run = lambda st: fddp._stop_test(
            st, False, 1e-3, torch.tensor([True]), torch.tensor([1.0], dtype=F64),
            torch.tensor([1.5], dtype=F64), torch.tensor([0.0], dtype=F64),
            torch.tensor([True]), torch.tensor([0.0], dtype=F64))[1]
    elif switch == "crocoddyl_signed_d0":
        # d0 = -5, d1 = 20: dVexp = 5 >= 0; dV = -1 fails th_acceptstep
        run = lambda st: fddp._accept(st, False, torch.tensor([False]), alphas,
                                      one(-5.0), one(20.0), one(-1.0))
    else:
        # feasible, dVexp = -1 < 0, dV = -1.5 > 2 * dVexp
        run = lambda st: fddp._accept(st, False, torch.tensor([True]), alphas,
                                      one(-1.0), one(0.0), one(-1.5))
    assert not bool(run(default).any()) and bool(run(ref).all())


@pytest.mark.parametrize("solver", [cspecs.SOLVER_BOX_FDDP,
                                    cspecs.SOLVER_BOX_DDP])
def test_controller_routes_box_missions(solver):
    """A controller whose MPC file names a box solver builds its problem on
    raw controls and solves it with that solver (one iteration here)."""
    from eagle_mpc_tpu_torch.mpc import RailMpc

    traj, mp = load_port(FLAGSHIP)
    ctrl = RailMpc(mpc_params=dataclasses.replace(mp, solver=solver),
                   state_ref=flagship_ref(traj), dt_ref=DT_REF, device=CPU,
                   dtype=F64)
    assert not ctrl.spec.use_squash
    params = ctrl.update_problem(t([3200.0]), P.expand_params(ctrl.params0, 1))
    xs, us = fddp.default_init(ctrl.spec, params)
    r = ctrl.solve(params, xs, us, maxiter=1)
    fn = (fddp.solve_box_fddp if solver == cspecs.SOLVER_BOX_FDDP
          else fddp.solve_box_ddp)
    want = fn(ctrl.spec, fddp.SolverSettings(), params, xs, us, 1, 1e-9)
    assert r.iters.item() == want.iters.item() == 1
    assert torch.equal(r.us, want.us) and torch.equal(r.us_squash, r.us)
