"""Shared setup of the PyTorch port's tests: the same seeded numpy inputs go
to the JAX package and to ``eagle_mpc_tpu_torch``, in float64 on the CPU."""

import os

import numpy as np
import torch

from eagle_mpc_tpu.config import specs
from eagle_mpc_tpu_torch import config as port_config

MISSIONS = os.path.join(os.path.dirname(__file__), "..", "missions")
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "torch_port_flagship.npz")
CL_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                          "torch_port_closed_loop.npz")
FLAGSHIP = "hexacopter370_flying_arm_3"
DT_REF = 30
CPU = torch.device("cpu")
F64 = torch.float64

# The port's CPU tests run many tiny batched products; PyTorch's intra-op
# threads cost more than they give there (a batched 3 x 3 product under
# forward-mode AD: 25 ms on 8 threads, 0.5 ms on one), and the suite runs
# in several worker processes at once.
torch.set_num_threads(1)


def load(robot, mission="displacement", loader=specs):
    """(trajectory, mpc params) through ``loader``: the JAX package's
    ``specs`` (default) or the port's ``config``."""
    traj = loader.load_trajectory(f"{robot}/trajectories/{mission}.yaml",
                                  yaml_dir=MISSIONS)
    mp = loader.load_mpc_params(f"{robot}/mpc/mpc.yaml", yaml_dir=MISSIONS)
    return traj, mp


def load_port(robot, mission="displacement"):
    return load(robot, mission, loader=port_config)


def flagship_ref(traj):
    return port_config.load_ref(FLAGSHIP, "displacement", DT_REF, traj=traj)[0]


def controllers(robot=FLAGSHIP, mission="displacement", ref=None):
    """(JAX CarrotMpc, port CarrotMpc) on the same mission and reference."""
    from eagle_mpc_tpu.mpc import CarrotMpc as JaxCarrot
    from eagle_mpc_tpu_torch.mpc import CarrotMpc

    traj, mp = load(robot, mission)
    ttraj, tmp = load_port(robot, mission)
    if ref is None:
        ref = flagship_ref(ttraj)
    jc = JaxCarrot(mpc_params=mp, trajectory=traj, state_ref=ref,
                   dt_ref=DT_REF)
    tc = CarrotMpc(mpc_params=tmp, trajectory=ttraj, state_ref=ref,
                   dt_ref=DT_REF, device=CPU, dtype=F64)
    return jc, tc


def candidates(spec, x_base, B, seed=0):
    """The perturbed candidates of tests/test_node_pallas.py."""
    rng = np.random.default_rng(seed)
    nx, T, nu = spec.model.nx, spec.T, spec.nu
    xs = np.tile(np.asarray(x_base), (B, T + 1, 1))
    xs += rng.normal(size=xs.shape) * 0.03
    xs[..., 3:7] /= np.linalg.norm(xs[..., 3:7], axis=-1, keepdims=True)
    us = rng.normal(size=(B, T, nu)) * 0.5 + 1.0
    return xs, us


def rand_states(model, n, seed=0):
    """n random states (unit quaternions) of a model, (n, nx)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, model.nx))
    x[:, 3:7] /= np.linalg.norm(x[:, 3:7], axis=-1, keepdims=True)
    return x


def t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def rel_err(a, b):
    """max |a - b| relative to max |a| (the measure of test_node_pallas)."""
    a = np.asarray(a, dtype=np.float64)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    scale = max(float(np.max(np.abs(a))), 1e-12) if a.size else 1.0
    return float(np.max(np.abs(a - b))) / scale if a.size else 0.0
