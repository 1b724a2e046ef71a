"""The 1-D batch mesh over processes: the port's scale-out dimension.

PyTorch counterpart of ``eagle_mpc_tpu.parallel.mesh``. The reference
builds a ``jax.sharding.Mesh`` over devices and lets XLA partition one
program; the torch idiom is one process per device, each solving its own
rows of the scenario batch, joined by ``torch.distributed``:

- :class:`Mesh` describes the world: its size, this process's rank, its
  device and its process group. A world of one, without
  ``torch.distributed``, is a valid mesh;
- :func:`batch_sharding` gives the rows a rank owns; :func:`shard_batch`
  keeps them of every leaf whose leading axis is the batch and copies
  every other leaf whole;
- :func:`make_sharded_summary` reduces the convergence summary with
  ``all_reduce`` (SUM of five sums, MAX of the iterations): only six
  scalars cross processes, no process gathers the batch.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

BATCH_AXIS = "batch"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ``world_size`` processes along the batch axis
    (``BATCH_AXIS``); ``group`` is the process group (None: a world of one
    without torch.distributed)."""

    world_size: int
    rank: int
    device: torch.device
    group: Optional[object] = None


def default_device(rank: int = 0) -> torch.device:
    """The card a rank runs on: ``cuda:(rank mod the host's card count)``
    (several ranks share a card when there are fewer cards than ranks).
    The CPU only when the caller asks for it."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return torch.device("cuda", rank % n if n else 0)


def make_mesh(device=None) -> Mesh:
    """The mesh of the current world: the default ``torch.distributed``
    process group when one is initialized, else a world of one. ``device``
    defaults to :func:`default_device` of the rank."""
    if dist.is_available() and dist.is_initialized():
        world, rank, group = (dist.get_world_size(), dist.get_rank(),
                              dist.group.WORLD)
    else:
        world, rank, group = 1, 0, None
    device = default_device(rank) if device is None else torch.device(device)
    return Mesh(world_size=world, rank=rank, device=device, group=group)


class BatchSharding(NamedTuple):
    """The rows of a leading batch axis that one rank owns: a contiguous
    block, rank r of W holding rows [r B/W, (r+1) B/W)."""

    rank: int
    world_size: int
    device: torch.device

    def rows(self, batch_size: int) -> slice:
        if batch_size % self.world_size:
            raise ValueError(
                f"batch_size {batch_size} is not divisible by the mesh size "
                f"{self.world_size}")
        n = batch_size // self.world_size
        return slice(self.rank * n, (self.rank + 1) * n)


class Replicated(NamedTuple):
    """A leaf every rank holds whole."""

    device: torch.device


def batch_sharding(mesh: Mesh) -> BatchSharding:
    """Sharding for tensors whose LEADING axis is the scenario batch."""
    return BatchSharding(mesh.rank, mesh.world_size, mesh.device)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh.device)


def _tree_map(fn, tree):
    """``fn`` on every tensor leaf of nested dicts, NamedTuples, tuples and
    lists; other leaves (None, numbers) stay as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        leaves = [_tree_map(fn, v) for v in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*leaves)
        return type(tree)(leaves)
    return tree


def shard_batch(mesh: Mesh, tree, batch_size: Optional[int] = None):
    """This rank's rows of every tensor leaf whose leading axis is the
    scenario batch, on the mesh's device; every other leaf copied whole.

    ``batch_size`` is the explicit contract for which leaves are batched:
    exactly those with ``shape[0] == batch_size``. When omitted it is the
    largest leading axis in the tree, and a leaf whose leading axis merely
    divides by the world size but is not the batch (a horizon-length
    leaf) is copied whole, never split. A batch the world size does not
    divide raises ``ValueError``."""
    if batch_size is None:
        dims = []
        _tree_map(lambda x: dims.append(x.shape[0]) if x.ndim else None, tree)
        if not dims:
            return _tree_map(lambda x: x.to(mesh.device), tree)
        batch_size = max(dims)
    rows = batch_sharding(mesh).rows(batch_size)

    def place(x):
        if x.ndim and x.shape[0] == batch_size:
            x = x[rows]
        return x.to(mesh.device)

    return _tree_map(place, tree)


# ---------------------------------------------------------------------------
# Collective reductions (all_reduce over the world, never host gathers)
# ---------------------------------------------------------------------------

def make_sharded_summary(mesh: Mesh):
    """The per-batch convergence summary reduced across processes.

    Each rank reduces its rows to five float64 sums (count, feasible,
    failed, iterations, cost) and the largest iteration count; one
    ``all_reduce(SUM)`` and one ``all_reduce(MAX)`` combine them (on the
    card under NCCL, on the host under gloo). Every rank receives the same
    six numbers; the batched results never leave their process.

    Returns ``summarize(feasible, failed, iters, cost) -> dict``."""

    def summarize(feasible, failed, iters, cost) -> dict:
        f64 = torch.float64
        sums = torch.stack([
            torch.tensor(float(feasible.shape[0]), dtype=f64,
                         device=feasible.device),
            feasible.to(f64).sum(), failed.to(f64).sum(), iters.to(f64).sum(),
            cost.to(f64).sum()])
        it_max = iters.to(torch.int64).max().reshape(1)
        if mesh.group is not None:
            on_card = dist.get_backend(mesh.group) == "nccl"
            sums, it_max = (a if on_card else a.cpu() for a in (sums, it_max))
            dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=mesh.group)
            dist.all_reduce(it_max, op=dist.ReduceOp.MAX, group=mesh.group)
        sums = sums.cpu().numpy()
        n = float(sums[0])
        return {
            "n": int(n),
            "feasible_frac": float(sums[1] / n),
            "failed_frac": float(sums[2] / n),
            "iters_mean": float(sums[3] / n),
            "iters_max": int(it_max.item()),
            "cost_mean": float(sums[4] / n),
        }

    return summarize


def sharded_summary(mesh: Mesh, res) -> dict:
    """One-shot :func:`make_sharded_summary` over an SbFddpResult-like
    object (fields feasible / failed / iters / cost, batch-leading)."""
    return make_sharded_summary(mesh)(res.feasible, res.failed, res.iters,
                                      res.cost)
