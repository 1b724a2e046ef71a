"""The PyTorch port's offline trajectory generation against the JAX
package, float64 on the CPU (the kernels' plain versions):

- ``problem.from_trajectory`` field by field for every free-flight
  mission at dt 30 ms and iris hover at dt 60 ms (the JAX package's is plain
  numpy and runs here as it is), and for the contact missions (their
  contact slots, activity and references too) at dt 30 and at the dt of
  tests/test_contacts.py; the duration-0 rules of ``stage_knots``;
- against tests/fixtures/torch_port_offline.npz (JAX, made by
  ``tools/make_torch_port_fixtures.py offline``): the smoke solve
  (``sbfddp.solve`` on iris hover at dt 60, maxiter 60, trace recorded:
  iterations, feasibility and the trace's accepted / phase / steplength
  equal, cost and trace cost to rtol 1e-9, states to 1e-8), ``solve_fddp``
  and ``solve_ddp`` alone, the regularization escalation of one batch
  element, and a batch of 3 perturbed solves;
- the batch equals its elements solved one at a time, and the entry point
  ``python3 -m eagle_mpc_tpu_torch.trajectory --cpu`` prints a trace and
  ends feasible.
"""

import glob
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from eagle_mpc_tpu.config import specs as jspecs
from eagle_mpc_tpu.ocp import problem as JP
from eagle_mpc_tpu_torch import config as port_config
from eagle_mpc_tpu_torch import trajectory
from eagle_mpc_tpu_torch.ocp import problem as P
from eagle_mpc_tpu_torch.solvers import fddp, sbfddp

from torch_port_util import CPU, F64, MISSIONS, rel_err, t

OFFLINE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "torch_port_offline.npz")
EULER = "IntegratedActionModelEuler"
CONTACT = ("hexacopter370_flying_arm_3/trajectories/eagle_catch.yaml",
           "hexacopter370_flying_arm_3/trajectories/monkey_bar.yaml")
TRAJECTORIES = sorted(
    os.path.relpath(p, MISSIONS).replace(os.sep, "/")
    for p in glob.glob(os.path.join(MISSIONS, "*", "trajectories", "*.yaml")))
FREE = [(p, 30) for p in TRAJECTORIES if p not in CONTACT] + [
    ("iris/trajectories/hover.yaml", 60)]


def _build(rel, dt_ms, use_squash=True):
    traj = port_config.load_trajectory(rel, yaml_dir=MISSIONS)
    return P.from_trajectory(traj, dt_ms=dt_ms, use_squash=use_squash,
                             integrator=EULER, device=CPU)


@pytest.fixture(scope="module")
def fx():
    return np.load(OFFLINE)


@pytest.fixture(scope="module")
def hover():
    """The smoke problem: iris hover at dt 60 ms, B = 1."""
    spec, params = _build("iris/trajectories/hover.yaml", 60)
    return spec, P.expand_params(params, 1)


@pytest.fixture(scope="module")
def smoke(hover):
    spec, pb = hover
    st = sbfddp.SbFddpSettings(solver=fddp.SolverSettings(record_trace=True))
    return sbfddp.solve(spec, pb, maxiter=60, settings=st)


def _matches_jax(rel, dt_ms):
    """The port's from_trajectory equals the JAX package's field by field."""
    spec, params = _build(rel, dt_ms)
    jspec, jparams = JP.from_trajectory(
        jspecs.load_trajectory(rel, yaml_dir=MISSIONS), dt_ms=dt_ms,
        use_squash=True, integrator=EULER)
    assert (spec.T, spec.dt, spec.use_squash, spec.integrator, spec.nu,
            spec.tau_f, spec.contacts) == (
        jspec.T, jspec.dt, jspec.use_squash, jspec.integrator, jspec.nu,
        jspec.tau_f, jspec.contacts)
    assert [tuple(s) for s in spec.slots] == [tuple(s) for s in jspec.slots]
    assert spec.model.nx == jspec.model.nx and spec.model.nj == jspec.model.nj
    got, want = [], []
    P.map_params(got.append, params)
    node = jparams.node
    contact = ([node.contact_active] if node.contact_active is not None
               else []) + list(node.contact_refs)
    for a in (jparams.x0, node.weight, node.active, *node.refs, *contact,
              *jparams.glob.act_w, *jparams.glob.lb, *jparams.glob.ub,
              jparams.glob.squash_smooth, jparams.glob.s_lb, jparams.glob.s_ub):
        want.append(np.asarray(a))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == F64 and g.device == CPU
        np.testing.assert_array_equal(g.numpy(), w)
    return spec, params


@pytest.mark.parametrize("rel,dt_ms", FREE)
def test_from_trajectory_matches_jax(rel, dt_ms):
    spec, params = _matches_jax(rel, dt_ms)
    assert spec.contacts == () and params.node.contact_active is None


@pytest.mark.parametrize("rel", CONTACT)
def test_contact_missions_raise(rel):
    """The contact missions, which raised before the port took contacts,
    build and match the JAX package at dt 30 and at the dt of
    tests/test_contacts.py (eagle_catch 50, monkey_bar 40): one 3-D contact
    slot on the gripper, active on the contact stage's nodes."""
    for dt_ms in (30, 50 if "eagle_catch" in rel else 40):
        spec, params = _matches_jax(rel, dt_ms)
        assert len(spec.contacts) == 1 and spec.contacts[0].dim == 3
        ca = params.node.contact_active
        assert ca.shape == (spec.T + 1, 1) and 0 < float(ca.sum()) < spec.T


def test_stage_knots_duration_zero_rules():
    """A stage shorter than dt takes one knot from its successor, unless it
    is the last, which only becomes the terminal node; the same as JAX."""
    stages = [SimpleNamespace(duration=d) for d in (100, 0, 50, 20, 60, 0)]
    knots, term = P.stage_knots(stages, 30)
    assert knots.tolist() == [3, 1, 0, 1, 1, 0] and term == 5
    jknots, jterm = JP.stage_knots(stages, 30)
    assert knots.tolist() == jknots.tolist() and term == jterm


def test_smoke_solve_matches_jax(smoke, fx):
    r = smoke
    for name in ("iters", "feasible", "failed"):
        assert getattr(r, name)[0].item() == fx[f"smoke_{name}"].item(), name
    assert int(r.iters[0]) == 8 and bool(r.feasible[0])
    np.testing.assert_allclose(r.cost[0].item(), fx["smoke_cost"], rtol=1e-9)
    for name in ("xs", "us", "us_squash"):
        np.testing.assert_allclose(getattr(r, name)[0].numpy(),
                                   fx[f"smoke_{name}"], rtol=0, atol=1e-8,
                                   err_msg=name)
    tr = fddp.IterTrace(*(a[0].numpy() for a in r.trace))
    for name in ("accepted", "phase", "steplength"):
        np.testing.assert_array_equal(getattr(tr, name),
                                      fx[f"smoke_trace_{name}"], err_msg=name)
    np.testing.assert_allclose(tr.cost, fx["smoke_trace_cost"], rtol=1e-9)
    assert (tr.phase[tr.accepted >= 0] >= 0).all()    # no polish ran
    text = fddp.format_trace(tr)
    assert len(text.splitlines()) == 1 + 8


@pytest.mark.parametrize("name", ["fddp", "ddp"])
def test_single_stage_matches_jax(hover, fx, name):
    spec, pb = hover
    xs0, us0 = fddp.default_init(spec, pb)
    fn = {"fddp": fddp.solve_fddp, "ddp": fddp.solve_ddp}[name]
    r = fn(spec, fddp.SolverSettings(), pb, xs0, us0, 30, 1e-3)
    for n in ("iters", "feasible", "failed"):
        assert getattr(r, n)[0].item() == fx[f"{name}_{n}"].item(), n
    np.testing.assert_allclose(r.cost[0].item(), fx[f"{name}_cost"],
                               rtol=1e-9)
    np.testing.assert_allclose(r.xs[0].numpy(), fx[f"{name}_xs"], rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(r.us[0].numpy(), fx[f"{name}_us"], rtol=0,
                               atol=1e-8)


def test_escalation_is_per_element(hover, fx):
    """Element 1's backward pass fails at the incoming regularization (its
    control regularization weight is -1e3): its xreg escalates as in the
    JAX vmapped direction, and element 0 keeps the gains it has alone."""
    spec, pb = hover
    k = int(fx["esc_slot"])
    p2 = P.map_params(lambda a: torch.cat([a, a]).clone(), pb)
    p2.node.weight[1, :, k] = -1e3
    xs, us = fddp.default_init(spec, p2)
    reg = torch.full((2,), 1e-9, dtype=F64)
    false = torch.zeros(2, dtype=torch.bool)
    _, _, bp, xreg, ureg, failed = fddp._compute_direction(
        spec, fddp.SolverSettings(), p2, xs, us, false, reg, reg)
    np.testing.assert_allclose(xreg.numpy(), fx["esc_xreg"], rtol=1e-12)
    np.testing.assert_allclose(ureg.numpy(), fx["esc_ureg"], rtol=1e-12)
    assert failed.tolist() == fx["esc_failed"].tolist()
    assert bp.ok.tolist() == fx["esc_ok"].tolist()
    assert xreg[0].item() == 1e-9 and xreg[1].item() > 1e-3
    for b in range(2):
        assert rel_err(fx["esc_k"][b], bp.k[b]) < 1e-9
        assert rel_err(fx["esc_K"][b], bp.K[b]) < 1e-9
    _, _, bp1, xreg1, _, _ = fddp._compute_direction(
        spec, fddp.SolverSettings(), pb, xs[:1], us[:1], false[:1], reg[:1],
        reg[:1])
    assert xreg1.item() == 1e-9
    assert torch.equal(bp1.k[0], bp.k[0]) and torch.equal(bp1.K[0], bp.K[0])


def test_batch_matches_jax_and_single_solves(hover, smoke, fx):
    """B = 3 in one solve, x0 the mission's and two perturbed ones: each
    element as JAX's vmapped solve, and element 0, which stops first, as
    the smoke solve of the same problem at B = 1 (states to 1e-10: batched
    products round differently from single ones)."""
    spec, pb = hover
    x0 = t(fx["batch_x0"])
    assert torch.equal(x0[0], pb.x0[0])
    params = P.expand_params(P.map_params(lambda a: a[0], pb), 3)
    r = sbfddp.solve(spec, params._replace(x0=x0), maxiter=60)
    for n in ("iters", "feasible", "failed"):
        np.testing.assert_array_equal(getattr(r, n).numpy(),
                                      fx[f"batch_{n}"], err_msg=n)
    np.testing.assert_allclose(r.cost.numpy(), fx["batch_cost"], rtol=1e-9)
    np.testing.assert_allclose(r.xs.numpy(), fx["batch_xs"], rtol=0,
                               atol=1e-8)
    assert smoke.iters.item() == r.iters[0].item() < r.iters.max().item()
    np.testing.assert_allclose(smoke.xs[0].numpy(), r.xs[0].numpy(), rtol=0,
                               atol=1e-10)


def test_entry_point_runs_on_the_cpu(capsys, tmp_path):
    out = tmp_path / "hover.npz"
    rc = trajectory.main(["iris", "hover", "--dt", "60", "--maxiter", "60",
                          "--cpu", "--f64", "--verbose", "--out", str(out)])
    text = capsys.readouterr().out
    assert rc == 0
    assert "phase" in text and "feasible True" in text
    z = np.load(out)
    assert z["xs"].shape == (19, 13) and int(z["iters"]) == 8
    assert set(z.files) == {"xs", "us", "us_squash", "dt_ms", "cost", "iters"}
