"""The PyTorch port's scale-out layer (``eagle_mpc_tpu_torch.parallel``)
against the JAX package, float64 on the CPU (the kernels' plain versions),
at iris hover, dt 100 ms (T = 11):

- against tests/fixtures/torch_port_parallel.npz (JAX, made by
  ``tools/make_torch_port_fixtures.py parallel``): ``perturbed_x0_batch``
  bitwise; ``make_batch_solver(spec, maxiter=20)`` on 8 starts (iterations
  and feasibility equal, xs and us rtol 1e-6 / atol 1e-8, cost rtol
  1e-8); the same with element 3's x0 NaN (it fails alone, the others as
  JAX's); ``convergence_summary``;
- ``shard_batch``'s rules on a mesh that describes rank 1 of 2 (no
  process group is needed to split a batch), a world of one, and the
  batched example's ``--smoke``;
- the new modules import no jax, JAX package or ``tools`` (subprocess).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from eagle_mpc_tpu_torch import config as port_config
from eagle_mpc_tpu_torch.ocp import problem as P
from eagle_mpc_tpu_torch.parallel import (BATCH_AXIS, batch_sharding,
                                          convergence_summary,
                                          make_batch_solver, make_mesh,
                                          perturbed_x0_batch, replicated,
                                          shard_batch)
from eagle_mpc_tpu_torch.parallel import __main__ as entry
from eagle_mpc_tpu_torch.parallel import mesh as mesh_mod
from eagle_mpc_tpu_torch.parallel.batch import perturbed_x0s

from torch_port_util import CPU, F64, MISSIONS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARALLEL = os.path.join(os.path.dirname(__file__), "fixtures",
                        "torch_port_parallel.npz")
SOLVED = ("xs", "us", "iters", "feasible", "failed", "cost")


@pytest.fixture(scope="module")
def fx():
    return np.load(PARALLEL)


@pytest.fixture(scope="module")
def hover():
    traj = port_config.load_trajectory("iris/trajectories/hover.yaml",
                                       yaml_dir=MISSIONS)
    return P.from_trajectory(traj, dt_ms=100, use_squash=True,
                             integrator="IntegratedActionModelEuler",
                             dtype=F64, device=CPU)


@pytest.fixture(scope="module")
def solved(hover):
    """The fixture's batch solve and its NaN twin, through the port."""
    spec, params = hover
    solve = make_batch_solver(spec, maxiter=20)
    bp = perturbed_x0_batch(params, 8, scale=0.02)
    x0 = bp.x0.clone()
    x0[3] = float("nan")
    return bp, solve(bp), solve(bp._replace(x0=x0))


def _check_solve(fx, prefix, res, rows=slice(None)):
    for n in ("iters", "feasible", "failed"):
        np.testing.assert_array_equal(getattr(res, n).numpy()[rows],
                                      fx[f"{prefix}_{n}"][rows], err_msg=n)
    np.testing.assert_allclose(res.cost.numpy()[rows], fx[f"{prefix}_cost"][rows],
                               rtol=1e-8)
    for n in ("xs", "us"):
        np.testing.assert_allclose(getattr(res, n).numpy()[rows],
                                   fx[f"{prefix}_{n}"][rows], rtol=1e-6,
                                   atol=1e-8, err_msg=n)


def test_perturbed_x0_batch_is_bitwise_jax(hover, fx):
    """Unbatched params and a batch of one give JAX's starts bit for bit;
    every other leaf is the mission's; in float32 the noise is still summed
    in float64 and then rounded."""
    spec, params = hover
    np.testing.assert_array_equal(params.x0.numpy(), fx["x0"])
    for base in (params, P.expand_params(params, 1)):
        bp = perturbed_x0_batch(base, 8, scale=0.02)
        assert bp.x0.dtype == F64 and bp.x0.shape == (8, spec.model.nx)
        np.testing.assert_array_equal(bp.x0.numpy(), fx["batch_x0"])
        np.testing.assert_array_equal(bp.node.weight.numpy(), np.broadcast_to(
            params.node.weight.numpy(), (8,) + tuple(params.node.weight.shape)))
    x32 = params.x0.float()
    want = (x32.double().numpy()[None] + (fx["batch_x0"] - fx["x0"][None])
            ).astype(np.float32)
    np.testing.assert_array_equal(perturbed_x0s(x32, 8, 0.02).numpy(), want)
    with pytest.raises(ValueError):
        perturbed_x0_batch(P.expand_params(params, 2), 8)


def test_batch_solve_matches_jax(solved, fx):
    _check_solve(fx, "batch", solved[1])
    assert bool(solved[1].feasible.all())


def test_nan_element_fails_alone(solved, fx):
    """Element 3 starts from a NaN state: it fails and ends infeasible; the
    others converge as JAX's do, feasible and finite."""
    res = solved[2]
    ok = np.ones(8, dtype=bool)
    ok[3] = False
    assert not bool(res.feasible[3]) and bool(res.failed[3])
    assert bool(res.feasible[ok].all())
    assert bool(torch.isfinite(res.cost[ok]).all())
    assert bool(torch.isfinite(res.xs[ok]).all())
    _check_solve(fx, "nan", res, rows=ok)
    for n in ("feasible", "failed"):
        np.testing.assert_array_equal(getattr(res, n).numpy(), fx[f"nan_{n}"])


def test_convergence_summary_matches_jax(solved, fx):
    s = convergence_summary(solved[1])
    assert set(s) == {"n", "feasible_frac", "failed_frac", "iters_mean",
                      "iters_max", "cost_mean"}
    for k, v in s.items():
        want = fx[f"summary_{k}"]
        if k == "cost_mean":
            np.testing.assert_allclose(v, want, rtol=1e-8)
        else:
            assert v == want, k


def test_shard_batch_rules():
    """Rank 1 of 2: the batch leaf's second half, a horizon leaf that
    divides by 2 copied whole (the batch given), the inferred batch (the
    largest leading axis) and an indivisible batch raising."""
    mesh = mesh_mod.Mesh(world_size=2, rank=1, device=CPU)
    assert BATCH_AXIS == "batch"
    tree = {"x0": torch.arange(16.0).reshape(8, 2),
            "horizon": torch.arange(36.0).reshape(12, 3),
            "scalar": torch.tensor(3.0), "none": None}
    out = shard_batch(mesh, tree, batch_size=8)
    assert torch.equal(out["x0"], tree["x0"][4:])
    assert torch.equal(out["horizon"], tree["horizon"])
    assert torch.equal(out["scalar"], tree["scalar"]) and out["none"] is None
    # inferred: 12 is the largest leading axis, so the horizon leaf is the
    # batch there; the explicit contract is what prevents that
    out2 = shard_batch(mesh, tree)
    assert torch.equal(out2["horizon"], tree["horizon"][6:])
    assert torch.equal(out2["x0"], tree["x0"])
    with pytest.raises(ValueError):
        shard_batch(mesh, {"x0": torch.zeros(7, 3)}, batch_size=7)
    assert batch_sharding(mesh).rows(8) == slice(4, 8)
    assert replicated(mesh).device == CPU


def test_world_of_one(hover, solved):
    """Without torch.distributed the mesh is a world of one; the batch
    solver on it and the sharded summary give the unsharded result."""
    spec, _ = hover
    mesh = make_mesh(device=CPU)
    assert (mesh.world_size, mesh.rank, mesh.group) == (1, 0, None)
    bp, res = solved[:2]
    assert shard_batch(mesh, bp, batch_size=8).x0.shape == (8, spec.model.nx)
    want = convergence_summary(res)
    got = mesh_mod.sharded_summary(mesh, res)
    assert {k: v for k, v in got.items() if k != "cost_mean"} == {
        k: v for k, v in want.items() if k != "cost_mean"}
    np.testing.assert_allclose(got["cost_mean"], want["cost_mean"], rtol=1e-12)


def test_entry_point_smoke(capsys):
    """``python3 -m eagle_mpc_tpu_torch.parallel --smoke``: iris hover on
    the CPU, B=8, every element feasible."""
    assert entry.main(["--smoke"]) == 0
    assert "SMOKE OK" in capsys.readouterr().out


def test_port_parallel_runs_without_jax():
    """The scale-out modules and the parallel Riccati pass import no jax,
    JAX package or ``tools``."""
    code = """
import sys, torch
torch.set_num_threads(1)
from eagle_mpc_tpu_torch.parallel import __main__, batch, distributed, mesh, scaling, worker
from eagle_mpc_tpu_torch.solvers import priccati
x = batch.perturbed_x0s(torch.zeros(13, dtype=torch.float64), 4)
m = mesh.make_mesh(device="cpu")
assert mesh.shard_batch(m, {"x": x})["x"].shape == (4, 13)
bad = worker.foreign_modules()
assert not bad, f"the port imported {bad}"
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA")}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
