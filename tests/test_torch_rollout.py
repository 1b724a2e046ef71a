"""Line-search rollouts for all 10 alphas (kernel K2's plain version plus
the terminal node and divergence checks of ``fddp._forward_pass_multi``)
against the JAX package's ``fddp._forward_pass`` vmapped over the alphas,
float64 on the CPU.

Both sides get the same arrays: the flagship tick's inputs from the JAX
fixture (element 0 a converged warm-start solution, element 1 a rough
candidate) with gains from one backward pass, gap contraction on
(infeasible) and off (feasible). The diverged flags must be equal; on the
lanes that did not diverge, xs_try, us_try and cost_try agree to 1e-10
relative to each output's largest entry (diverged lanes are chaotic and
the solver reads only their flag).
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
def ctrls():
    return controllers()


@pytest.fixture(scope="module")
def jax_rollouts(ctrls):
    """JAX's forward pass for every alpha, vmapped over the batch and
    compiled once for both cases (the feasibility is data)."""
    jc = ctrls[0]
    settings = fddp.SolverSettings()

    def jax_fp(p, xs1, us1, bp1, fs1, f1):
        return jax.vmap(lambda a: Jfddp._forward_pass(
            jc.spec, p, xs1, us1, bp1, fs1, a, f1, True,
            th_diverge=settings.th_diverge))(jnp.asarray(settings.alphas))

    return jax.jit(jax.vmap(jax_fp))


@pytest.mark.parametrize("feasible", [False, True])
def test_rollouts_match_jax(ctrls, jax_rollouts, feasible):
    jc, tc = ctrls
    fx = np.load(FIXTURE)
    xs, us, x0, t_ms = (fx[k] for k in ("tick_xs_in", "tick_us_in", "x0",
                                        "tick_t"))
    feas = torch.full((B,), feasible)
    pt = tc.update_problem(t(t_ms), P.expand_params(tc.params0, B)._replace(
        x0=t(x0)))
    derivs, term = P.calc_diff_all(tc.spec, pt, t(xs), t(us))
    fs = fddp._gaps(tc.spec, pt, t(xs), derivs.xnext, feas)
    regs = torch.full((B,), 1e-9, dtype=torch.float64)
    bp = fddp._backward_pass(tc.spec, derivs, term, fs, regs, regs, feas)
    settings = fddp.SolverSettings()
    alphas = torch.tensor(settings.alphas, dtype=torch.float64)
    got = fddp._forward_pass_multi(tc.spec, settings, pt, t(xs), t(us), bp,
                                   fs, alphas, feas, ddp=False)

    pj = jax.vmap(lambda t1, x1: jc.update_problem(
        t1, JP.as_device(jc.params0)._replace(x0=x1)))(jnp.asarray(t_ms),
                                                      jnp.asarray(x0))
    jbp = Jfddp.BackwardPassData(*(jnp.asarray(a.numpy()) for a in bp))
    want = jax_rollouts(pj, jnp.asarray(xs), jnp.asarray(us), jbp,
                        jnp.asarray(fs.numpy()), jnp.asarray(feas.numpy()))
    diverged = np.asarray(want[3])
    assert np.array_equal(diverged, got[3].numpy())
    ok = ~diverged
    assert ok.any()
    for a, b, name in zip(want[:3], got[:3], ("xs_try", "us_try", "cost_try")):
        assert rel_err(np.asarray(a)[ok], b.numpy()[ok]) < 1e-10, name
