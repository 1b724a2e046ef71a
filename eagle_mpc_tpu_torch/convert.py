"""Carry robot models, problem specs and parameters across from the
reference package.

The converters work on the reference's containers by field name, so this
module imports neither ``jax`` nor the reference package, and what they
return holds none of the reference's objects: a ``ProblemParams`` whose
leaves are numpy arrays (the reference controllers' ``params0`` holds host
leaves) converts as it is; device arrays convert once passed through
``numpy.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from .dynamics.model import Frame, RobotModel
from .ocp import costs as C
from .ocp import problem as P


def params_from_jax(params, device, dtype) -> P.ProblemParams:
    """Reference ``ProblemParams`` (numpy leaves) -> this package's. Any
    leading batch axes are kept."""
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    node, glob = params.node, params.glob
    ca = getattr(node, "contact_active", None)
    return P.ProblemParams(
        x0=t(params.x0),
        node=P.NodeParams(weight=t(node.weight), active=t(node.active),
                          refs=tuple(t(r) for r in node.refs),
                          contact_active=None if ca is None else t(ca),
                          contact_refs=tuple(
                              t(r) for r in getattr(node, "contact_refs", ()))),
        glob=P.GlobalParams(
            act_w=tuple(t(a) for a in glob.act_w),
            lb=tuple(t(a) for a in glob.lb), ub=tuple(t(a) for a in glob.ub),
            squash_smooth=t(glob.squash_smooth),
            s_lb=t(glob.s_lb), s_ub=t(glob.s_ub)))


def model_from_jax(model) -> RobotModel:
    """Reference ``RobotModel`` -> this package's, field by field (numpy
    copies of the arrays, the port's ``Frame``s)."""
    a = lambda x: np.array(x, dtype=np.float64)
    return RobotModel(
        name=model.name, parent=tuple(model.parent),
        joint_type=tuple(model.joint_type), joint_p=a(model.joint_p),
        joint_R=a(model.joint_R), joint_axis=a(model.joint_axis),
        joint_names=tuple(model.joint_names), inertia=a(model.inertia),
        effort_limit=a(model.effort_limit),
        velocity_limit=a(model.velocity_limit),
        lower_limit=a(model.lower_limit), upper_limit=a(model.upper_limit),
        frames=tuple(Frame(f.name, f.body, a(f.p), a(f.R))
                     for f in model.frames),
        gravity=float(model.gravity))


def spec_from_jax(spec) -> P.ProblemSpec:
    """Reference ``ProblemSpec`` -> this package's (its cost and contact
    slots rebuilt field by field)."""
    return P.ProblemSpec(
        model=model_from_jax(spec.model), nu=int(spec.nu),
        tau_f=tuple(tuple(float(v) for v in row) for row in spec.tau_f),
        slots=tuple(C.CostSlot(
            name=str(s.name), kind=str(s.kind), activation=str(s.activation),
            nr=int(s.nr), ref_dim=int(s.ref_dim), frame_id=int(s.frame_id),
            contact_id=int(s.contact_id),
            cone_A=None if s.cone_A is None else tuple(
                tuple(float(v) for v in row) for row in s.cone_A))
            for s in spec.slots),
        integrator=str(spec.integrator), T=int(spec.T), dt=float(spec.dt),
        use_squash=bool(spec.use_squash),
        contacts=tuple(P.ContactSlot(
            name=str(c.name), frame_id=int(c.frame_id), dim=int(c.dim),
            ref_dim=int(c.ref_dim),
            gains=tuple(float(g) for g in c.gains))
            for c in spec.contacts))
