"""Batched scenario solving: many perturbed starts of one problem at once.

PyTorch counterpart of ``eagle_mpc_tpu.parallel.batch``. The batch is
explicit and leading everywhere in the port, so the batched solver is
``sbfddp.solve`` itself (through kernels K1, K2 and K3 on the card); no
vmap. Per-element masks keep a diverged scenario from touching the rest:
each element stops, and is frozen, on its own.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ocp import problem as P
from ..solvers import sbfddp


def perturbed_x0s(x0, n: int, scale: float = 0.05, seed: int = 0):
    """(n, nx) copies of the state x0 (nx,) with seeded normal noise (sd
    ``scale``) off the quaternion block 3:7. The noise is drawn and added
    in float64 numpy, then cast to x0's dtype and device, as the reference
    package does: in float64 the result is bitwise the reference's."""
    rng = np.random.default_rng(seed)
    base = x0.detach().to("cpu", torch.float64).numpy()
    noise = rng.normal(size=(n, base.shape[0])) * scale
    noise[:, 3:7] = 0.0
    return torch.as_tensor(base[None] + noise, dtype=x0.dtype,
                           device=x0.device)


def perturbed_x0_batch(params: P.ProblemParams, n: int, scale: float = 0.05,
                       seed: int = 0) -> P.ProblemParams:
    """An n-batch of problems that differ in x0 only (noise as
    :func:`perturbed_x0s`). ``params`` is unbatched (x0 (nx,)) or a batch
    of one (x0 (1, nx))."""
    if params.x0.ndim == 2:
        if params.x0.shape[0] != 1:
            raise ValueError(f"params must be unbatched or a batch of one, "
                             f"got x0 {tuple(params.x0.shape)}")
        params = P.map_params(lambda a: a[0], params)
    return P.expand_params(params, n)._replace(
        x0=perturbed_x0s(params.x0, n, scale, seed))


def make_batch_solver(spec: P.ProblemSpec, maxiter: int = 100,
                      settings: Optional[sbfddp.SbFddpSettings] = None,
                      mesh=None):
    """Batched SbFDDP solver: ``solve(batch_params) -> SbFddpResult``, every
    leaf of the result batched like the params.

    With a ``mesh`` (``parallel.mesh.make_mesh``) the params are this
    process's rows of the global batch (what ``mesh.shard_batch`` or
    ``distributed.host_local_batch`` give), moved onto the mesh's device,
    and the result holds those rows; ``mesh.sharded_summary`` reduces it
    across the processes. Nothing crosses processes inside the solve. The
    reference's ``donate`` (an XLA buffer-donation flag) has no
    counterpart here: eager PyTorch frees the inputs when the caller drops
    them."""
    settings = settings or sbfddp.SbFddpSettings()

    def solve(batch_params: P.ProblemParams) -> sbfddp.SbFddpResult:
        if mesh is not None:
            batch_params = P.map_params(lambda a: a.to(mesh.device),
                                        batch_params)
        return sbfddp.solve(spec, batch_params, maxiter=maxiter,
                            settings=settings)

    return solve


def convergence_summary(res: sbfddp.SbFddpResult) -> dict:
    """Host-side per-batch stats (feasible fraction, iteration stats)."""
    host = lambda a: a.detach().cpu().numpy()
    feas, iters = host(res.feasible), host(res.iters)
    return {
        "n": int(feas.shape[0]),
        "feasible_frac": float(feas.mean()),
        "failed_frac": float(host(res.failed).mean()),
        "iters_mean": float(iters.mean()),
        "iters_max": int(iters.max()),
        "cost_mean": float(host(res.cost).mean()),
    }
