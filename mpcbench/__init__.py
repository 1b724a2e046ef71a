"""The benchmark of eagle_mpc_tpu_torch on an NVIDIA H100.

``run.py`` runs one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) and prints one JSON line. Everything that belongs to one
configuration, mix, per-layer metric, kernel work count or cell's limits
sits in a file of its own, found by name:

- ``configs/<config>.json``: the robot and controller as run;
- ``traffic/<traffic>.json``: the parameters of the one generator;
- ``metrics/<metric>.py``: the reader of a per-layer metric (the name with
  its family suffix, such as ``.serve``, or without it);
- ``work/<kernel>.py``: a kernel's operations and bytes from the tick's
  logical shapes;
- ``limits/<cell>.json``: the limits of the numbers compared with the
  reference;
- ``peaks.json``: the published peaks of each card.

``reference/`` is the plain PyTorch tick that decides ``correct``.
"""
