"""Carrot MPC: chase a moving point along the offline trajectory.

PyTorch counterpart of ``eagle_mpc_tpu.mpc.carrot``. Five cost slots on
every node (plus the SbFDDP barrier):

  state_reg     WeightedQuad         always active, zero reference
  control_reg   WeightedQuad         always active
  state_limits  WeightedQuadBarrier  always active
  carrot_state  Quad                 toggled + re-aimed by update_problem
  carrot_tail   WeightedQuad         active past the trajectory end (hold)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import specs as cspecs
from ..dynamics.state import State
from ..ocp import costs as C
from ..ocp import problem as P
from . import base

STATE_REG, CONTROL_REG, STATE_LIMITS, CARROT_STATE, CARROT_TAIL = range(5)


@dataclasses.dataclass
class CarrotMpc(base.MpcAbstract):
    """Cost weight keys and defaults are the reference's (carrot_weight=10,
    carrot_tail_weight=5, control_reg=1e-2, state_reg=1e-3,
    state_limits=100)."""

    trajectory: cspecs.TrajectorySpec = None
    state_ref: np.ndarray = None          # (N, nx) offline solution
    dt_ref: int = 0                       # ms between reference samples

    def __post_init__(self):
        mp = self.mpc_params
        state = State(mp.model.nq, mp.model.nv)
        ndx, nu, nx = state.ndx, mp.platform.nu, state.nx
        server = mp.server
        pre = "mpc_controller/"
        opt = lambda getter, key, default: base._try_param(
            getter, pre + key, default)
        g, gv = server.get_double, server.get_vector
        carrot_weight = opt(g, "carrot_weight", 10.0)
        tail_weight = opt(g, "carrot_tail_weight", 5.0)
        tail_act_w = opt(gv, "carrot_tail_act_weights", np.ones(ndx))
        creg_weight = opt(g, "carrot_control_reg_weight", 1e-2)
        creg_act_w = opt(gv, "carrot_control_reg_act_weights", np.ones(nu))
        sreg_weight = opt(g, "carrot_state_reg_weight", 1e-3)
        sreg_act_w = opt(gv, "carrot_state_ref_act_weights", np.ones(ndx))
        slim_weight = opt(g, "carrot_state_limits_weight", 100.0)
        slim_act_w = opt(gv, "carrot_state_limits_act_weights", np.ones(ndx))
        slim_lb = gv(pre + "carrot_state_limits_l_bound")
        slim_ub = gv(pre + "carrot_state_limits_u_bound")

        zero_x = np.zeros(nx)
        zero_x[6] = 1.0
        no_bound = np.full(ndx, np.inf)
        slots = [
            C.CostSlot("state_reg", C.STATE, C.WQUAD, ndx, nx),
            C.CostSlot("control_reg", C.CONTROL, C.WQUAD, nu, nu),
            C.CostSlot("state_limits", C.STATE, C.WQBARRIER, ndx, nx),
            C.CostSlot("carrot_state", C.STATE, C.QUAD, ndx, nx),
            C.CostSlot("carrot_tail", C.STATE, C.WQUAD, ndx, nx),
        ]
        self._finalize_problem(
            slots,
            slot_weights=[sreg_weight, creg_weight, slim_weight,
                          carrot_weight, tail_weight],
            slot_active=[1.0, 1.0, 1.0, 0.0, 0.0],
            slot_refs=[zero_x, np.zeros(nu), zero_x, zero_x, zero_x],
            act_w=[sreg_act_w, creg_act_w, slim_act_w, np.ones(ndx), tail_act_w],
            lbs=[-no_bound, -np.full(nu, np.inf), slim_lb, -no_bound, -no_bound],
            ubs=[no_bound, np.full(nu, np.inf), slim_ub, no_bound, no_bound],
        )

        t_ref = np.arange(self.state_ref.shape[0], dtype=np.int64) * self.dt_ref
        self._sample = base.make_reference_sampler(
            state, self.state_ref, t_ref, self.device, self.dtype)
        stages = self.trajectory.stages
        self._t_stages = torch.as_tensor(
            base.stage_boundaries(stages, self.dt).astype(np.float64),
            dtype=self.dtype, device=self.device)
        self._transition = torch.as_tensor([bool(s.transition) for s in stages],
                                           device=self.device)
        self._n_stages = len(stages)

    def update_problem(self, t_ms, params: P.ProblemParams) -> P.ProblemParams:
        """Batched updateProblem: ``t_ms`` (B,), ``params`` batched. Toggles
        the carrot / tail activity and re-aims their references."""
        T = self.spec.T
        node_time = t_ms[:, None] + self.dt * torch.arange(
            T + 1, dtype=self.dtype, device=self.device)        # (B, T+1)
        idx_stage = torch.searchsorted(self._t_stages, node_time,
                                       right=True) - 1
        beyond = idx_stage >= self._n_stages
        is_transition = self._transition[torch.clamp(idx_stage, 0,
                                                     self._n_stages - 1)]
        is_last = torch.arange(T + 1, device=self.device) == T
        carrot_active = ~beyond & (~is_transition | is_last)

        refs = self._sample(node_time)                           # (B, T+1, nx)
        active = params.node.active.clone()
        active[..., CARROT_STATE] = carrot_active.to(self.dtype)
        active[..., CARROT_TAIL] = beyond.to(self.dtype)
        new_refs = list(params.node.refs)
        new_refs[CARROT_STATE] = refs
        new_refs[CARROT_TAIL] = refs
        return params._replace(node=params.node._replace(
            active=active, refs=tuple(new_refs)))
