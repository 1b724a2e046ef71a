"""Static robot model: the port's analog of ``pinocchio::Model``.

eagle-mpc builds its model with
``pinocchio::urdf::buildModel(path, JointModelFreeFlyer, model)``
(src/trajectory.cpp:29-31). Here the model is a frozen host-side container
of numpy arrays produced once at setup time, with the same fields and
conventions as the JAX package's ``RobotModel``; ``dynamics.rbd`` turns it
into tensors and ``ops._cuda`` packs it into the kernels' descriptor.

Topology supported: free-flyer base + revolute/prismatic chains — covering
every robot in the reference's yaml/ tree (multicopters with serial arms).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# Joint type codes
REVOLUTE = 0
PRISMATIC = 1


@dataclasses.dataclass(frozen=True)
class Frame:
    """A named fixed frame attached to a body (operational frame)."""

    name: str
    body: int              # body index (0 = free-flyer base)
    p: np.ndarray          # translation of the frame in the body frame
    R: np.ndarray          # rotation of the frame in the body frame


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Immutable kinematic/inertial description.

    Bodies are indexed 0..n_joints: body 0 is the floating base; body i>0 is
    the link moved by actuated joint i (joints are numbered from 1 in
    parent-before-child order). ``parent[i]`` is the body index the joint i
    is mounted on.
    """

    name: str
    # per actuated joint (length nj, entries for joints 1..nj):
    parent: Tuple[int, ...]
    joint_type: Tuple[int, ...]
    joint_p: np.ndarray        # (nj, 3) joint placement translation in parent
    joint_R: np.ndarray        # (nj, 3, 3) joint placement rotation in parent
    joint_axis: np.ndarray     # (nj, 3) unit axis in the joint frame
    joint_names: Tuple[str, ...]
    # per body (length nj+1):
    inertia: np.ndarray        # (nj+1, 6, 6) spatial inertia in body frame
    # limits for actuated joints:
    effort_limit: np.ndarray    # (nj,)
    velocity_limit: np.ndarray  # (nj,)
    lower_limit: np.ndarray     # (nj,)
    upper_limit: np.ndarray     # (nj,)
    # operational frames:
    frames: Tuple[Frame, ...]
    gravity: float = 9.81

    # ---- dimensions (pinocchio-compatible) ----
    @property
    def nj(self) -> int:
        return len(self.parent)

    @property
    def nq(self) -> int:
        return 7 + self.nj

    @property
    def nv(self) -> int:
        return 6 + self.nj

    @property
    def nx(self) -> int:
        return self.nq + self.nv

    @property
    def ndx(self) -> int:
        return 2 * self.nv

    def frame_id(self, name: str) -> int:
        for i, f in enumerate(self.frames):
            if f.name == name:
                return i
        raise KeyError(f"Frame '{name}' does not exist in model '{self.name}'")

    def frame(self, name: str) -> Frame:
        return self.frames[self.frame_id(name)]

    @property
    def frame_names(self) -> Tuple[str, ...]:
        return tuple(f.name for f in self.frames)

    def __hash__(self):
        return hash((self.name, self.parent, self.joint_names, self.frame_names))

    def __eq__(self, other):
        return self is other or (
            isinstance(other, RobotModel)
            and self.name == other.name
            and self.parent == other.parent
            and np.array_equal(self.joint_p, other.joint_p)
            and np.array_equal(self.joint_axis, other.joint_axis)
            and self.frame_names == other.frame_names
        )
