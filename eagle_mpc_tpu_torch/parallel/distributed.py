"""Multi-process execution: ``torch.distributed`` plumbing.

PyTorch counterpart of ``eagle_mpc_tpu.parallel.distributed``. A process
owns one device (a card, or the CPU when asked) and a block of rows of
the global scenario batch:

- :func:`initialize` joins the job (``init_process_group`` over a
  ``tcp://`` rendezvous) and returns the world's :class:`mesh.Mesh`;
- :func:`host_local_batch` materializes only this rank's rows, from their
  global indices, so no process holds the global batch;
- ``mesh.sharded_summary`` reduces the results with ``all_reduce``.

The backend defaults to NCCL on a card and gloo on the CPU. NCCL refuses
two ranks on one card; a caller who wants that (several ranks sharing
one card exercise the mechanism, they do not scale it) passes
``backend="gloo"``. A backend that fails raises; nothing switches to
another one.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from . import mesh as mesh_mod


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device=None) -> mesh_mod.Mesh:
    """Join a multi-process job and return its mesh.

    The arguments default to ``EAGLE_MPC_COORDINATOR`` (``host:port`` of
    rank 0's rendezvous), ``EAGLE_MPC_NUM_PROCS`` and ``EAGLE_MPC_PROC_ID``.
    ``device`` defaults to ``mesh.default_device(process_id)`` (a card);
    ``backend`` to ``nccl`` on a card and ``gloo`` on the CPU."""
    coordinator_address = coordinator_address or os.environ.get(
        "EAGLE_MPC_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ["EAGLE_MPC_NUM_PROCS"])
    if process_id is None:
        process_id = int(os.environ["EAGLE_MPC_PROC_ID"])
    if not coordinator_address:
        raise ValueError("no coordinator address: pass one or set "
                         "EAGLE_MPC_COORDINATOR=host:port")
    device = (mesh_mod.default_device(process_id) if device is None
              else torch.device(device))
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id)
    return mesh_mod.make_mesh(device=device)


def shutdown() -> None:
    """Leave the job (``destroy_process_group``) if one was joined."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def host_local_batch(global_batch: int, seed_fn, mesh=None) -> torch.Tensor:
    """This rank's rows of a global batch, on the mesh's device.

    ``seed_fn(global_indices) -> array`` produces the rows from their
    global indices, so every rank materializes ONLY its own block (the
    multi-process data-loading pattern). A batch the world size does not
    divide raises ``ValueError``."""
    if mesh is None:
        mesh = mesh_mod.make_mesh()
    rows = mesh_mod.batch_sharding(mesh).rows(global_batch)
    local = seed_fn(np.arange(rows.start, rows.stop))
    return torch.as_tensor(np.asarray(local), device=mesh.device)


def process_summary(mesh=None) -> dict:
    """Topology facts for logging: rank, world size, this process's device
    and the host's card count."""
    if mesh is None:
        mesh = mesh_mod.make_mesh()
    return {
        "process_index": mesh.rank,
        "process_count": mesh.world_size,
        "device": str(mesh.device),
        "device_count": (torch.cuda.device_count()
                         if torch.cuda.is_available() else 0),
        "backend": (dist.get_backend(mesh.group) if mesh.group is not None
                    else None),
    }
