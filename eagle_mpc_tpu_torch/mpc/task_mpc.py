"""Task-activated carrot MPC: the mission's stage costs toggled per node.

PyTorch counterpart of ``eagle_mpc_tpu.mpc.task_mpc``. Every node carries
the mission's own stage costs (one slot per (stage, cost), stages not
merged), and ``update_problem`` activates exactly the slots of each node's
active stage. When the horizon's last node falls in a transition stage, a
terminal carrot state cost is activated there, aimed at the offline
reference at that node's time.
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
from .weighted import mission_cost_slots


@dataclasses.dataclass
class TaskActivatedCarrotMpc(base.MpcAbstract):
    """The carrot's weight key and default are the reference's
    (mpc_controller/carrot_weight, 10)."""

    trajectory: cspecs.TrajectorySpec = None
    state_ref: np.ndarray = None          # (N, nx) offline solution
    dt_ref: int = 0                       # ms between reference samples

    def __post_init__(self):
        mp = self.mpc_params
        state = State(mp.model.nq, mp.model.nv)
        nx, ndx = state.nx, state.ndx
        stages = self.trajectory.stages
        self._n_stages = len(stages)
        (slots, weights, refs, act_w, lbs, ubs, slot_stage,
         _) = mission_cost_slots(stages, mp.model, mp.platform.nu)

        # + the terminal carrot slot
        carrot_weight = base._try_param(
            mp.server.get_double, "mpc_controller/carrot_weight", 10.0)
        zero_x = np.zeros(nx)
        zero_x[6] = 1.0
        no_bound = np.full(ndx, np.inf)
        slots.append(C.CostSlot("task_carrot", C.STATE, C.QUAD, ndx, nx))
        weights.append(carrot_weight)
        refs.append(zero_x)
        act_w.append(np.ones(ndx))
        lbs.append(-no_bound)
        ubs.append(no_bound)
        self._finalize_problem(slots, slot_weights=weights,
                               slot_active=[0.0] * len(slots), slot_refs=refs,
                               act_w=act_w, lbs=lbs, ubs=ubs)
        self._n_mission_slots = len(slot_stage)
        t = lambda a, dtype=self.dtype: torch.as_tensor(
            np.asarray(a), dtype=dtype, device=self.device)
        self._t_stages = t([s.t_ini for s in stages])
        self._transition = t([bool(s.transition) for s in stages], torch.bool)
        self._slot_stage = t(slot_stage, torch.int64)
        t_ref = np.arange(self.state_ref.shape[0], dtype=np.int64) * self.dt_ref
        self._sample = base.make_reference_sampler(
            state, self.state_ref, t_ref, self.device, self.dtype)

    def _active_stages(self, t_ms):
        """(node times (B, T+1), each node's active stage (B, T+1)) with the
        sequential jump clamp (a node lands at most one stage past its
        predecessor's where it would land exactly two ahead), a loop over
        the nodes."""
        T = self.spec.T
        node_time = t_ms[:, None] + self.dt * torch.arange(
            T + 1, dtype=self.dtype, device=self.device)
        raw = base.stage_index(self._t_stages, node_time)
        last = base.stage_index(self._t_stages, t_ms)
        idx = []
        for n in range(T + 1):
            r = raw[:, n]
            last = torch.where(r == last + 2, r - 1, r)
            idx.append(last)
        return node_time, torch.clamp(torch.stack(idx, dim=1), 0,
                                      self._n_stages - 1)

    def update_problem(self, t_ms, params: P.ProblemParams) -> P.ProblemParams:
        """Batched updateProblem: ``t_ms`` (B,), ``params`` batched. Sets the
        mission slots' activity and the terminal carrot's activity and
        reference (the barrier slot is left as it is)."""
        node_time, idx_stage = self._active_stages(t_ms)
        K, T = self._n_mission_slots, self.spec.T
        is_last = torch.arange(T + 1, device=self.device) == T
        carrot_on = is_last & self._transition[idx_stage]          # (B, T+1)
        ref_last = self._sample(node_time[:, -1])                  # (B, nx)
        active = params.node.active.clone()
        active[..., :K] = (self._slot_stage == idx_stage[..., None]).to(self.dtype)
        active[..., K] = carrot_on.to(self.dtype)
        new_refs = list(params.node.refs)
        new_refs[K] = ref_last[:, None].expand(-1, T + 1, -1)
        return params._replace(node=params.node._replace(
            active=active, refs=tuple(new_refs)))
