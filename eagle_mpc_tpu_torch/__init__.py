"""eagle_mpc_tpu_torch: the Carrot, Rail and Weighted MPC ticks and the
offline trajectory generation of ``eagle_mpc_tpu`` in PyTorch.

The layout mirrors the JAX package (``dynamics``, ``ocp``, ``ops``,
``solvers``, ``mpc``, ``sim``). Batches are explicit and leading,
``(B, T, ...)``. On CUDA tensors the node linearization, the Riccati
backward pass and the line-search rollout run as hand-written kernels for
Hopper (``csrc/``); on CPU tensors the same functions run their plain
PyTorch versions. The YAML front end (``config``) and the robot model
(``dynamics.model``, ``dynamics.urdf``) are the port's own copies; nothing
here imports the JAX package.
"""

__version__ = "0.1.0"
