"""Carrot MPC controller and plant of the PyTorch port against the JAX
package (float64, CPU): the converted parameters, ``update_problem``
across stage transitions and the carrot tail, and the RK4 plant step."""

import numpy as np
import pytest
import torch

from eagle_mpc_tpu_torch import convert
from eagle_mpc_tpu_torch.ocp import problem as P
from eagle_mpc_tpu_torch.sim import AerialSimulator

from torch_port_util import (CL_FIXTURE, CPU, F64, FIXTURE, controllers,
                             load_port, rand_states, t)


@pytest.fixture(scope="module")
def ctrls():
    return controllers()


def _leaves(params):
    out = []
    P.map_params(lambda a: out.append(a), params)
    return out


def test_params_and_spec_convert(ctrls):
    """params_from_jax(jax params0) == the port's own params0, and the
    converted spec equals the port controller's spec."""
    jc, tc = ctrls
    conv = convert.params_from_jax(jc.params0, CPU, F64)
    a, b = _leaves(conv), _leaves(tc.params0)
    assert len(a) == len(b) == 3 + 3 * len(tc.spec.slots) + 3 + len(tc.spec.slots)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert convert.spec_from_jax(jc.spec) == tc.spec


@pytest.mark.parametrize("t_ms", [0.0, 1000.0, 3500.0, 4050.0, 4500.0])
def test_update_problem_matches_jax(ctrls, t_ms):
    """Node activity and carrot references at stage transitions (wp1 at
    2000-2030 ms, wp2 at 4030-4060 ms) and past the trajectory end. The JAX
    values are the fixture's (``up_*`` of
    tests/fixtures/torch_port_closed_loop.npz): evaluating JAX's update
    here cost most of these cases' time."""
    tc = ctrls[1]
    fx = np.load(CL_FIXTURE)
    i = fx["up_t"].tolist().index(t_ms)
    got = tc.update_problem(torch.full((2,), t_ms, dtype=F64),
                            P.expand_params(tc.params0, 2))
    for b in range(2):
        np.testing.assert_array_equal(got.node.active[b].numpy(),
                                      fx["up_active"][i])
        for k, gr in enumerate(got.node.refs):
            np.testing.assert_allclose(gr[b].numpy(), fx[f"up_ref{k}"][i],
                                       rtol=0, atol=1e-12)


def test_sim_step_matches_jax():
    """One 2 ms RK4 step from random states against the JAX plant's
    (``sim_*`` of the flagship fixture)."""
    tmp = load_port("hexacopter370_flying_arm_3")[1]
    tsim = AerialSimulator.from_platform(tmp.model, tmp.platform, 2,
                                         device=CPU, dtype=F64)
    fx = np.load(FIXTURE)
    x = rand_states(tmp.model, 4, 11)
    u = np.random.default_rng(12).uniform(0.0, 5.0, size=(4, tmp.platform.nu))
    assert np.array_equal(x, fx["sim_x"]) and np.array_equal(u, fx["sim_u"])
    got = tsim.step(t(x), t(u))
    np.testing.assert_allclose(got.numpy(), fx["sim_x_next"], rtol=0,
                               atol=1e-12)
