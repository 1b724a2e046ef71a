"""The benchmark's plain reference of the served MPC tick.

A frozen copy of the PyTorch port's plain path (``config``, ``dynamics``,
``ocp``, ``solvers.fddp`` / ``sbfddp``, ``mpc.base`` / ``carrot``,
``sim.plant``), taken so that later changes to the program cannot move the
yardstick. It imports nothing of the port and nothing of JAX; it parses the
robot's YAML and URDF itself. Changes from the copied source:

- ``ops/plain.py`` holds the plain versions of the three kernels (K1, K2,
  K3) under the names the solver calls, so no kernel is ever launched;
- ``config/parser.py`` finds the repository root one level further up;
- the package ``__init__`` files import only what the tick needs.

``tick.py`` is the served tick on top of it (update, the fixed-depth
SbFDDP solve on its eager route, the plant step); ``compare.py`` reads the
gaps between a tick's outputs and the reference's.
"""
