"""Weighted MPC: the mission's own stage costs, exponentially re-weighted.

PyTorch counterpart of ``eagle_mpc_tpu.mpc.weighted``. Transition stages
are merged into their successors, every node carries the union of all
stages' costs (one slot per (stage, cost)), and ``update_problem``
(i) activates the slots of each node's active stage and (ii) scales the
weights of the slots other than ``reg*``/``limits*`` by
``exp(alpha * (t_node - t_stage_end) / 1000) * beta``, held at ``beta``
past the trajectory end. A node's active stage follows the sequential
"jump clamp": it lands at most one stage past its predecessor's where it
would land exactly two ahead.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..config import specs as cspecs
from ..ocp import costs as C
from ..ocp import problem as P
from . import base


def merge_transition_stages(stages: Tuple[cspecs.StageSpec, ...]):
    """Fold each transition stage into its successor (durations summed,
    the first t_ini kept)."""
    merged: List[cspecs.StageSpec] = []
    carry_dur, carry_tini = 0, None
    for st in stages:
        if st.transition:
            carry_dur += st.duration
            if carry_tini is None:
                carry_tini = st.t_ini
            continue
        merged.append(dataclasses.replace(
            st, duration=st.duration + carry_dur,
            t_ini=st.t_ini if carry_tini is None else carry_tini))
        carry_dur, carry_tini = 0, None
    return tuple(merged)


def mission_cost_slots(stages, model, nu):
    """Union-of-stage-costs slot table: one slot per (stage, cost) named
    "<stage>/<cost>", with each slot's stage index and whether it keeps its
    stage weight (``reg*``/``limits*``)."""
    nx = model.nx
    slots, weights, refs, act_w, lbs, ubs = [], [], [], [], [], []
    slot_stage: List[int] = []
    slot_exempt: List[bool] = []
    for si, st in enumerate(stages):
        for cost in st.costs:
            kind = P._KIND_MAP[cost.type]
            ref_dims = {C.STATE: nx, C.CONTROL: nu, C.FRICTION_CONE: 0}
            slots.append(C.CostSlot(
                name=f"{st.name}/{cost.name}", kind=kind,
                activation=P._ACT_MAP[cost.activation], nr=cost.nr,
                ref_dim=ref_dims.get(kind, C.REF_DIMS.get(kind, cost.nr)),
                frame_id=cost.frame_id))
            weights.append(cost.weight)
            refs.append(P._encode_ref(cost, nx, nu))
            nr = cost.nr
            act_w.append(np.asarray(cost.act_weights if cost.act_weights
                                    is not None else np.ones(nr), np.float64))
            lbs.append(np.asarray(cost.lower_bound if cost.lower_bound
                                  is not None else np.full(nr, -np.inf),
                                  np.float64))
            ubs.append(np.asarray(cost.upper_bound if cost.upper_bound
                                  is not None else np.full(nr, np.inf),
                                  np.float64))
            slot_stage.append(si)
            slot_exempt.append(cost.name.startswith(("reg", "limits")))
    return slots, weights, refs, act_w, lbs, ubs, slot_stage, slot_exempt


@dataclasses.dataclass
class WeightedMpc(base.MpcAbstract):
    """Keys and defaults are the reference's: weighted_alpha=20,
    weighted_beta=1 (weighted_state_reg / weighted_control_reg build no
    cost in the reference, and are not read here)."""

    trajectory: cspecs.TrajectorySpec = None
    dt_ref: int = 0

    def __post_init__(self):
        mp = self.mpc_params
        g = mp.server.get_double
        self.alpha = base._try_param(g, "mpc_controller/weighted_alpha", 20.0)
        self.beta = base._try_param(g, "mpc_controller/weighted_beta", 1.0)

        self._stages = merge_transition_stages(self.trajectory.stages)
        self._n_stages = len(self._stages)
        self._duration = self.trajectory.duration
        (slots, weights, refs, act_w, lbs, ubs, slot_stage,
         slot_exempt) = mission_cost_slots(self._stages, mp.model,
                                           mp.platform.nu)
        self._finalize_problem(slots, slot_weights=weights,
                               slot_active=[0.0] * len(slots), slot_refs=refs,
                               act_w=act_w, lbs=lbs, ubs=ubs)
        t = lambda a, dtype=self.dtype: torch.as_tensor(
            np.asarray(a), dtype=dtype, device=self.device)
        self._t_stages = t([s.t_ini for s in self._stages])
        self._stage_end = t([s.t_ini + s.duration for s in self._stages])
        self._slot_stage = t(slot_stage, torch.int64)
        self._slot_exempt = t(slot_exempt, torch.bool)
        self._slot_weight = t(weights)
        self._n_mission_slots = len(slots)

    def _active_stages(self, t_ms):
        """(node times (B, T+1), each node's active stage (B, T+1)) with
        the sequential jump clamp, a loop over the nodes."""
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

    def update_problem(self, t_ms, params):
        """Batched updateProblem: ``t_ms`` (B,), ``params`` batched. Sets the
        activity and weights of the mission slots (the barrier slot is left
        as it is)."""
        node_time, idx_stage = self._active_stages(t_ms)
        K = self._n_mission_slots
        active = params.node.active.clone()
        active[..., :K] = (self._slot_stage == idx_stage[..., None]).to(self.dtype)
        wt = torch.where(node_time > self._duration, 0.0,
                         (node_time - self._stage_end[idx_stage]) / 1000.0)
        mod = torch.exp(self.alpha * wt) * self.beta                # (B, T+1)
        w = self._slot_weight
        weight = params.node.weight.clone()
        weight[..., :K] = torch.where(self._slot_exempt, w, w * mod[..., None])
        return params._replace(node=params.node._replace(active=active,
                                                         weight=weight))
