"""Riccati backward pass (kernel K3's plain version) against the JAX
package's ``fddp._backward_pass`` (XLA scan path), float64 on the CPU.

Both sides get the same arrays: node derivatives of the flagship tick's
inputs from the JAX fixture (element 0 a converged warm-start solution,
element 1 a rough candidate), feasible and infeasible, at the solver's
initial regularization and at a moderate one.

Tolerance: 1e-10 relative to each output's largest entry (measured
<= 6e-12). Inputs matter: at the rougher random candidates of
tests/test_node_pallas.py Quu is ill conditioned (cond ~1e7) and two
correct Cholesky implementations (LAPACK here, unrolled rows there)
differ by ~cond * eps, about 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_mpc_tpu.ocp import problem as JP
from eagle_mpc_tpu.solvers import fddp as Jfddp
from eagle_mpc_tpu_torch.ocp import problem as P
from eagle_mpc_tpu_torch.solvers import fddp

from torch_port_util import FIXTURE, controllers, rel_err, t

B = 2


@pytest.fixture(scope="module")
def state():
    """(JAX ctrl, port ctrl, JAX params, port params, derivatives as numpy,
    xs) at the fixture's tick inputs."""
    jc, tc = controllers()
    fx = np.load(FIXTURE)
    xs, us, x0, t_ms = (fx[k] for k in ("tick_xs_in", "tick_us_in", "x0",
                                        "tick_t"))
    pt = tc.update_problem(t(t_ms), P.expand_params(tc.params0, B)._replace(
        x0=t(x0)))
    derivs, term = P.calc_diff_all(tc.spec, pt, t(xs), t(us))
    pj = jax.vmap(lambda t1, x1: jc.update_problem(
        t1, JP.as_device(jc.params0)._replace(x0=x1)))(jnp.asarray(t_ms),
                                                      jnp.asarray(x0))
    derivs = {k: getattr(derivs, k).contiguous().numpy()
              for k in derivs._fields}
    term = tuple(a.numpy() for a in term)
    return jc, tc, pj, pt, derivs, term, xs


@pytest.fixture(scope="module")
def jax_backward(state):
    """JAX's gaps and backward pass, vmapped and compiled once for every
    case (the regularization and feasibility are data)."""
    jc = state[0]

    def jax_bp(d, tm, xs1, p, f, reg):
        fs = Jfddp._gaps(jc.spec, p, xs1, d, f)
        return Jfddp._backward_pass(jc.spec, d, tm, fs, reg, reg, f), fs

    return jax.jit(jax.vmap(jax_bp))


def _run(state, jax_backward, reg, feasible):
    jc, tc, pj, pt, derivs, term, xs = state
    feas = np.full((B,), feasible)
    jd = JP.NodeDerivatives(**{k: jnp.asarray(v) for k, v in derivs.items()})
    want, fs = jax_backward(jd, tuple(map(jnp.asarray, term)), jnp.asarray(xs),
                            pj, jnp.asarray(feas), jnp.full((B,), reg))
    td = P.NodeDerivatives(**{k: t(v) for k, v in derivs.items()})
    regs = torch.full((B,), reg, dtype=torch.float64)
    got = fddp._backward_pass(tc.spec, td, tuple(map(t, term)), t(fs), regs,
                              regs, torch.as_tensor(feas))
    return want, got


@pytest.mark.parametrize("feasible", [False, True])
@pytest.mark.parametrize("reg", [1e-9, 1e-3])
def test_backward_pass_matches_jax(state, jax_backward, reg, feasible):
    want, got = _run(state, jax_backward, reg, feasible)
    assert np.array_equal(np.asarray(want.ok), got.ok.numpy())
    for name in ("k", "K", "Qu", "Quuk", "Vx", "Vxx"):
        assert rel_err(getattr(want, name), getattr(got, name)) < 1e-10, name


def test_non_pd_quu_fails_on_both_sides(state, jax_backward):
    """A very negative control regularization makes Quu indefinite: both
    packages report a failed pass (ok False) instead of raising."""
    want, got = _run(state, jax_backward, -1e3, False)
    assert not np.asarray(want.ok).any()
    assert not got.ok.any()
