"""Rail MPC: pure reference tracking along the offline trajectory.

PyTorch counterpart of ``eagle_mpc_tpu.mpc.rail``. Two cost slots on every
node (plus the SbFDDP barrier):

  rail_state  WeightedQuad  the state error against the time-interpolated
                            reference, re-aimed by update_problem
  control     Quad          control regularization

Past the end of the reference the held state keeps only the yaw of its
attitude.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..dynamics.state import State
from ..ocp import costs as C
from . import base

RAIL_STATE, CONTROL = range(2)


@dataclasses.dataclass
class RailMpc(base.MpcAbstract):
    """Keys and defaults are the reference's: rail_weight=10,
    rail_activation_weights=1, rail_control_weight=1e-1."""

    state_ref: np.ndarray = None          # (N, nx) offline solution
    dt_ref: int = 0                       # ms between reference samples

    def __post_init__(self):
        mp = self.mpc_params
        state = State(mp.model.nq, mp.model.nv)
        ndx, nu, nx = state.ndx, mp.platform.nu, state.nx
        server = mp.server
        opt = lambda getter, key, default: base._try_param(
            getter, "mpc_controller/" + key, default)
        rail_weight = opt(server.get_double, "rail_weight", 10.0)
        rail_act_w = opt(server.get_vector, "rail_activation_weights",
                         np.ones(ndx))
        control_weight = opt(server.get_double, "rail_control_weight", 1e-1)

        zero_x = np.zeros(nx)
        zero_x[6] = 1.0
        no_bound = np.full(ndx, np.inf)
        self._finalize_problem(
            [C.CostSlot("rail_state", C.STATE, C.WQUAD, ndx, nx),
             C.CostSlot("control", C.CONTROL, C.QUAD, nu, nu)],
            slot_weights=[rail_weight, control_weight],
            slot_active=[1.0, 1.0],
            slot_refs=[zero_x, np.zeros(nu)],
            act_w=[rail_act_w, np.ones(nu)],
            lbs=[-no_bound, -np.full(nu, np.inf)],
            ubs=[no_bound, np.full(nu, np.inf)])
        t_ref = np.arange(self.state_ref.shape[0], dtype=np.int64) * self.dt_ref
        self._sample = base.make_reference_sampler(
            state, self.state_ref, t_ref, self.device, self.dtype,
            hold_yaw_only=True)

    def update_problem(self, t_ms, params):
        """Batched updateProblem: ``t_ms`` (B,), ``params`` batched.
        Re-aims every node's rail reference."""
        node_time = t_ms[:, None] + self.dt * torch.arange(
            self.spec.T + 1, dtype=self.dtype, device=self.device)
        refs = list(params.node.refs)
        refs[RAIL_STATE] = self._sample(node_time)
        return params._replace(node=params.node._replace(refs=tuple(refs)))
