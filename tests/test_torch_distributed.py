"""The PyTorch port's multi-process batch solve: 2 ranks of
``eagle_mpc_tpu_torch.parallel.worker`` on the CPU, joined by
``torch.distributed`` with the gloo backend over a ``tcp://127.0.0.1``
rendezvous (``parallel.scaling.run_job``).

Each rank materializes only its half of a seeded global batch of 8 iris
hover starts (dt 200 ms, float64), solves it with the while-loop SbFDDP
(maxiter 40) and reduces the summary with ``all_reduce``. As the JAX
package's tests/test_distributed.py: the topology, the summary identical
on both ranks, and equal to the same batch solved in this process
(counts and iterations exactly, the mean cost to rtol 1e-10). Both are
also held to the JAX package's solve of the same 8 starts
(``worker_*`` in tests/fixtures/torch_port_parallel.npz, written by
tools/make_torch_port_fixtures.py): the starts bitwise, each element's
iterations and feasibility exactly and its cost to rtol 1e-7, and the
ranks' summary equal to JAX's ``convergence_summary`` (the mean cost to
rtol 1e-8). Each rank also fails if the port imported jax, the JAX
package or ``tools``. The reference solve runs while the ranks do.
"""

import os

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from eagle_mpc_tpu_torch import config as port_config
from eagle_mpc_tpu_torch.ocp import problem as P
from eagle_mpc_tpu_torch.parallel import convergence_summary, make_batch_solver
from eagle_mpc_tpu_torch.parallel import scaling, worker
from eagle_mpc_tpu_torch.parallel.batch import perturbed_x0s

from torch_port_util import CPU, F64, MISSIONS

B = 8
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "torch_port_parallel.npz")


def _single_process():
    """The same 8 starts solved in this process: (summary, result, x0)."""
    traj = port_config.load_trajectory("iris/trajectories/hover.yaml",
                                       yaml_dir=MISSIONS)
    spec, params = P.from_trajectory(traj, dt_ms=worker.DT_MS,
                                     use_squash=True,
                                     integrator="IntegratedActionModelEuler",
                                     dtype=F64, device=CPU)
    pb = P.expand_params(params, B)._replace(
        x0=perturbed_x0s(params.x0, B, worker.NOISE, 0))
    res = make_batch_solver(spec, maxiter=worker.MAXITER)(pb)
    return convergence_summary(res), res, pb.x0


@pytest.fixture(scope="module")
def runs():
    """(the 2 ranks' results, the single-process reference)."""
    with ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(scaling.run_job, 2, B, device="cpu",
                          dtype="float64", timeout=240)
        single = _single_process()
        return ranks.result(), single


@pytest.fixture(scope="module")
def worker_results(runs):
    return runs[0]


def test_topology(worker_results):
    for rank, r in enumerate(worker_results):
        topo = r["topo"]
        assert (topo["process_index"], topo["process_count"]) == (rank, 2)
        assert topo["device"] == "cpu" and topo["backend"] == "gloo"
        assert r["local_rows"] == B // 2 and r["dtype"] == "torch.float64"


def test_summary_identical_across_ranks(worker_results):
    s0, s1 = (r["summary"] for r in worker_results)
    assert s0 == s1


def test_matches_single_process(runs):
    want, res, _ = runs[1]
    got = runs[0][0]["summary"]
    assert want["n"] == got["n"] == B
    for k in ("feasible_frac", "failed_frac", "iters_mean", "iters_max"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["cost_mean"], want["cost_mean"], rtol=1e-10)
    assert want["feasible_frac"] == 1.0 and bool(torch.isfinite(res.cost).all())


def test_matches_jax(runs):
    fx = np.load(FIXTURE)
    _, res, x0 = runs[1]
    np.testing.assert_array_equal(x0.numpy(), fx["worker_x0"])
    for n in ("iters", "feasible", "failed"):
        np.testing.assert_array_equal(getattr(res, n).numpy(),
                                      fx[f"worker_{n}"], err_msg=n)
    np.testing.assert_allclose(res.cost.numpy(), fx["worker_cost"], rtol=1e-7)
    got = runs[0][0]["summary"]
    for k in ("n", "feasible_frac", "failed_frac", "iters_mean", "iters_max"):
        assert got[k] == fx[f"worker_summary_{k}"], k
    np.testing.assert_allclose(got["cost_mean"], fx["worker_summary_cost_mean"],
                               rtol=1e-8)
