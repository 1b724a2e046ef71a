"""Weighted and Rail MPC of the PyTorch port against the JAX package
(float64, CPU).

- ``update_problem`` against the JAX controllers at times around the stage
  transitions (wp1 ends at 2000 ms, wp2 at 4000 ms, the offline reference
  at 3960 ms) and past the end: activity exactly equal, weights and
  references to 1e-12 absolute;
- ``merge_transition_stages`` and Rail's yaw-only hold;
- on the Weighted spec, the plain node linearization (kernel K1's plain
  version) and the plain line-search rollouts (K2's) against the JAX
  package's XLA path, to 1e-9 relative to each output's largest entry;
- the Weighted and Rail warm start and tick at B=2 against their fixtures
  (equal feasible / iters / failed, cost rtol 1e-8, states rtol 1e-6).

The JAX values of the last two come from tests/fixtures/
torch_port_{weighted,rail}.npz, written by
tools/make_torch_port_fixtures.py (compiling the JAX solvers takes
minutes).
"""

import os
import types

import numpy as np
import pytest
import torch

from eagle_mpc_tpu.mpc import RailMpc as JaxRail
from eagle_mpc_tpu.mpc import WeightedMpc as JaxWeighted
from eagle_mpc_tpu.mpc import base as jbase
from eagle_mpc_tpu.mpc import weighted as jweighted
from eagle_mpc_tpu.ocp import problem as JP
from eagle_mpc_tpu_torch import convert
from eagle_mpc_tpu_torch.mpc import RailMpc, WeightedMpc, base, weighted
from eagle_mpc_tpu_torch.ocp import costs as C
from eagle_mpc_tpu_torch.ocp import problem as P
from eagle_mpc_tpu_torch.ops import node_cuda
from eagle_mpc_tpu_torch.sim import AerialSimulator
from eagle_mpc_tpu_torch.solvers import fddp, sbfddp

from torch_port_util import (CPU, DT_REF, F64, FLAGSHIP, flagship_ref, load,
                             load_port, rel_err, t)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TIMES = (0.0, 1990.0, 2000.0, 3200.0, 3990.0, 4000.0, 4500.0)
B = 2


@pytest.fixture(scope="module")
def ctrls():
    traj, mp = load(FLAGSHIP)
    ttraj, tmp = load_port(FLAGSHIP)
    ref = flagship_ref(ttraj)
    return {
        "weighted": (JaxWeighted(mpc_params=mp, trajectory=traj, dt_ref=DT_REF),
                     WeightedMpc(mpc_params=tmp, trajectory=ttraj,
                                 dt_ref=DT_REF, device=CPU, dtype=F64)),
        "rail": (JaxRail(mpc_params=mp, state_ref=ref, dt_ref=DT_REF),
                 RailMpc(mpc_params=tmp, state_ref=ref, dt_ref=DT_REF,
                         device=CPU, dtype=F64)),
    }


def _fixture(name):
    return np.load(os.path.join(FIXTURES, f"torch_port_{name}.npz"))


def test_specs_convert(ctrls):
    """The JAX controllers' specs convert to the port's own, frame ids
    included; the Weighted spec has 7 mission slots and the barrier."""
    for jc, tc in ctrls.values():
        assert convert.spec_from_jax(jc.spec) == tc.spec
    spec = ctrls["weighted"][1].spec
    assert [s.name for s in spec.slots] == [
        "wp1/pose", "wp1/rest", "wp1/arm_home", "wp2/gripper_pose",
        "wp2/gripper_rest", "wp2/base_level", "wp2/arm_rest", P.BARRIER_SLOT]
    model = spec.model
    assert [model.frames[s.frame_id].name for s in spec.slots
            if s.kind in C.REF_DIMS] == [
        "hexacopter370__base_link", "hexacopter370__base_link",
        "flying_arm_3__gripper", "flying_arm_3__gripper",
        "hexacopter370__base_link"]


@pytest.mark.parametrize("t_ms", TIMES)
@pytest.mark.parametrize("name", ["weighted", "rail"])
def test_update_problem_matches_jax(ctrls, name, t_ms):
    jc, tc = ctrls[name]
    want = jc.update_problem(t_ms, JP.as_device(jc.params0))
    got = tc.update_problem(torch.full((B,), t_ms, dtype=F64),
                            P.expand_params(tc.params0, B))
    for b in range(B):
        np.testing.assert_array_equal(got.node.active[b].numpy(),
                                      np.asarray(want.node.active))
        np.testing.assert_allclose(got.node.weight[b].numpy(),
                                   np.asarray(want.node.weight), rtol=0,
                                   atol=1e-12)
        for wr, gr in zip(want.node.refs, got.node.refs):
            np.testing.assert_allclose(gr[b].numpy(), np.asarray(wr),
                                       rtol=0, atol=1e-12)


def test_update_problem_batches_times(ctrls):
    """Each scenario of a batch gets its own time: a batch of the times
    equals the times one by one."""
    for _, tc in ctrls.values():
        base_p = P.expand_params(tc.params0, len(TIMES))
        got = tc.update_problem(t(TIMES), base_p)
        for i, t_ms in enumerate(TIMES):
            one = tc.update_problem(t([t_ms]), P.expand_params(tc.params0, 1))
            assert torch.equal(got.node.active[i], one.node.active[0])
            assert torch.equal(got.node.weight[i], one.node.weight[0])
            for a, b in zip(got.node.refs, one.node.refs):
                assert torch.equal(a[i], b[0])


def test_merge_transition_stages():
    traj = load(FLAGSHIP)[0]
    ttraj = load_port(FLAGSHIP)[0]
    want = jweighted.merge_transition_stages(traj.stages)
    got = weighted.merge_transition_stages(ttraj.stages)
    assert [(s.name, s.duration, s.t_ini, s.transition) for s in got] == [
        (s.name, s.duration, s.t_ini, s.transition) for s in want] == [
        ("wp1", 2000, 0, False), ("wp2", 2000, 2000, False)]
    assert [[c.name for c in s.costs] for s in got] == [
        ["pose", "rest", "arm_home"],
        ["gripper_pose", "gripper_rest", "base_level", "arm_rest"]]


def test_rail_holds_yaw_only(ctrls):
    """Past the reference's end Rail holds the last configuration with the
    attitude's roll and pitch removed (quaternion (0, 0, z, w) normalized)
    at zero velocity, as the JAX sampler does."""
    ref = flagship_ref(load_port(FLAGSHIP)[0])
    nq = ctrls["rail"][1].spec.model.nq
    state = ctrls["rail"][1].spec.state
    sample = base.make_reference_sampler(state, ref,
                                         np.arange(ref.shape[0]) * DT_REF,
                                         CPU, F64, hold_yaw_only=True)
    jsample = jbase.make_reference_sampler(ctrls["rail"][0].spec.state, ref,
                                           np.arange(ref.shape[0]) * DT_REF,
                                           hold_yaw_only=True)
    times = t([100.0, 3955.0, 3990.0, 5000.0])
    got = sample(times).numpy()
    for i, t_ms in enumerate(times.tolist()):
        np.testing.assert_allclose(got[i], np.asarray(jsample(t_ms)),
                                   rtol=0, atol=1e-12)
    hold = got[-1]
    quat = np.array([0.0, 0.0, ref[-1, 5], ref[-1, 6]])
    np.testing.assert_allclose(hold[3:7], quat / np.linalg.norm(quat),
                               rtol=0, atol=1e-15)
    assert np.all(hold[nq:] == 0.0) and np.all(got[-2] == hold)


def _weighted_inputs(tc, fx, prefix):
    params = tc.update_problem(t(fx[f"{prefix}_t"]), P.expand_params(
        tc.params0, B)._replace(x0=t(fx[f"{prefix}_x0"] if prefix == "cd"
                                     else fx["x0"])))
    return params


def test_weighted_node_linearization_matches_jax(ctrls):
    """Plain K1 (and the terminal node) on the Weighted spec at the tick's
    inputs against the JAX XLA path: every frame kind's Jacobian rows."""
    tc = ctrls["weighted"][1]
    fx = _fixture("weighted")
    params = _weighted_inputs(tc, fx, "cd")
    got, term = P.calc_diff_all(tc.spec, params, t(fx["cd_xs"]), t(fx["cd_us"]))
    for name in got._fields:
        assert rel_err(fx[f"cd_{name}"], getattr(got, name)) < 1e-9, name
    for name, a in zip(("cost", "Lx", "Lxx"), term):
        assert rel_err(fx[f"cd_term_{name}"], a) < 1e-9, name
    # the plain version is what node_cuda takes on the CPU
    again = node_cuda.calc_diff_running(tc.spec, params, t(fx["cd_xs"]),
                                        t(fx["cd_us"]))
    assert torch.equal(again.Lxx, got.Lxx)


def test_weighted_rollouts_match_jax(ctrls):
    """Plain K2 (with the terminal node and divergence checks of
    ``fddp._forward_pass_multi``) on the Weighted spec, all 10 alphas with
    gap contraction, on the JAX package's gaps and gains: the diverged
    flags equal, the other lanes to 1e-9 relative."""
    tc = ctrls["weighted"][1]
    fx = _fixture("weighted")
    params = _weighted_inputs(tc, fx, "tick")
    settings = fddp.SolverSettings()
    bp = types.SimpleNamespace(k=t(fx["fp_k"]), K=t(fx["fp_K"]))
    got = fddp._forward_pass_multi(
        tc.spec, settings, params, t(fx["tick_xs_in"]), t(fx["tick_us_in"]),
        bp, t(fx["fp_fs"]), torch.tensor(settings.alphas, dtype=F64),
        torch.zeros(B, dtype=torch.bool), ddp=False)
    diverged = fx["fp_diverged"]
    assert np.array_equal(diverged, got[3].numpy())
    ok = ~diverged
    assert ok.sum() >= 10
    for name, g in zip(("xs_try", "us_try", "cost_try"), got[:3]):
        assert rel_err(fx[f"fp_{name}"][ok], g.numpy()[ok]) < 1e-9, name


def _check(fx, prefix, res, extra=()):
    for name in ("feasible", "iters", "failed"):
        np.testing.assert_array_equal(
            getattr(res, name).numpy().astype(fx[f"{prefix}_{name}"].dtype),
            fx[f"{prefix}_{name}"], err_msg=name)
    np.testing.assert_allclose(res.cost.numpy(), fx[f"{prefix}_cost"],
                               rtol=1e-8)
    for name, a in (("xs", res.xs), ("us", res.us),
                    ("us_squash", res.us_squash)) + tuple(extra):
        np.testing.assert_allclose(a.numpy(), fx[f"{prefix}_{name}"],
                                   rtol=1e-6, atol=1e-8, err_msg=name)


@pytest.mark.parametrize("name", ["weighted", "rail"])
def test_warm_start_matches_jax(ctrls, name):
    tc = ctrls[name][1]
    fx = _fixture(name)
    base_p = P.expand_params(tc.params0, B)._replace(x0=t(fx["x0"]))
    res = sbfddp.solve_fixed(tc.spec, tc.update_problem(t(fx["warm_t"]), base_p),
                             t(fx["warm_xs_in"]), t(fx["warm_us_in"]), depth=4,
                             polish="fixed")
    _check(fx, "warm", res)


@pytest.mark.parametrize("name", ["weighted", "rail"])
def test_tick_matches_jax(ctrls, name):
    tc = ctrls[name][1]
    fx = _fixture(name)
    mp = load_port(FLAGSHIP)[1]
    sim = AerialSimulator.from_platform(mp.model, mp.platform, 2, device=CPU,
                                        dtype=F64)
    x0 = t(fx["x0"])
    base_p = P.expand_params(tc.params0, B)._replace(x0=x0)
    res = sbfddp.solve_fixed(tc.spec, tc.update_problem(t(fx["tick_t"]), base_p),
                             t(fx["tick_xs_in"]), t(fx["tick_us_in"]),
                             depth=tc.iters, settings=tc.solver_settings(),
                             n_alphas=10, polish="while_fixed", polish_maxiter=1)
    x_next = sim.step(x0, res.us_squash[:, 0])
    _check(fx, "tick", res, (("x_next", x_next),))
