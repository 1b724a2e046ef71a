"""The scale-out layer: batched scenario solves and batch sharding over
processes (PyTorch counterpart of ``eagle_mpc_tpu.parallel``).

- ``batch``: ``perturbed_x0_batch``, ``make_batch_solver``,
  ``convergence_summary``;
- ``mesh``: the 1-D batch mesh over ``torch.distributed`` processes,
  ``shard_batch`` and the ``all_reduce`` summary;
- ``distributed``: ``initialize``, ``host_local_batch``,
  ``process_summary``;
- ``worker`` / ``scaling``: one rank of a multi-process solve and the
  weak-scaling run that spawns them;
- ``python3 -m eagle_mpc_tpu_torch.parallel``: the batched example.
"""

from .batch import (convergence_summary, make_batch_solver,
                    perturbed_x0_batch)
from .mesh import (BATCH_AXIS, batch_sharding, make_mesh, replicated,
                   shard_batch)

__all__ = ["make_mesh", "batch_sharding", "replicated", "shard_batch",
           "BATCH_AXIS", "perturbed_x0_batch", "make_batch_solver",
           "convergence_summary"]
