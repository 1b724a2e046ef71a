"""URDF -> RobotModel loader (host-side, pure Python).

Replaces the reference's ``pinocchio::urdf::buildModel`` with a
free-flyer-rooted parse (eagle-mpc src/trajectory.cpp:29-31): the URDF
root link becomes the floating base; revolute/continuous/prismatic joints
become actuated joints; fixed joints are welded — their subtree inertia is
merged into the parent body and their links remain addressable as frames
(needed for e.g. the ``flying_arm_3__gripper`` cost frames).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np

from .model import Frame, PRISMATIC, REVOLUTE, RobotModel

_INF = 1e9


def _vec(s: Optional[str], default):
    if s is None:
        return np.asarray(default, dtype=np.float64)
    return np.array([float(x) for x in s.split()], dtype=np.float64)


def _rpy_to_rot(rpy: np.ndarray) -> np.ndarray:
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    return np.array(
        [
            [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ]
    )


def _origin(el: Optional[ET.Element]):
    if el is None:
        return np.zeros(3), np.eye(3)
    o = el.find("origin")
    if o is None:
        return np.zeros(3), np.eye(3)
    xyz = _vec(o.get("xyz"), [0, 0, 0])
    rpy = _vec(o.get("rpy"), [0, 0, 0])
    return xyz, _rpy_to_rot(rpy)


def _hat(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def _spatial_inertia(mass, com, Ic):
    C = _hat(com)
    out = np.zeros((6, 6))
    out[:3, :3] = mass * np.eye(3)
    out[:3, 3:] = mass * C.T
    out[3:, :3] = mass * C
    out[3:, 3:] = Ic - mass * (C @ C)
    return out


def _link_spatial_inertia(link: ET.Element) -> np.ndarray:
    """Spatial inertia of a URDF link in its own link frame."""
    inertial = link.find("inertial")
    if inertial is None:
        return np.zeros((6, 6))
    mass = float(inertial.find("mass").get("value"))
    p, R = _origin(inertial)
    inode = inertial.find("inertia")
    ixx = float(inode.get("ixx")); iyy = float(inode.get("iyy")); izz = float(inode.get("izz"))
    ixy = float(inode.get("ixy", 0)); ixz = float(inode.get("ixz", 0)); iyz = float(inode.get("iyz", 0))
    I_local = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
    # Rotate the COM-frame inertia into the link frame; COM offset is p.
    return _spatial_inertia(mass, p, R @ I_local @ R.T)


def _inertia_to_parent(p, R, I6):
    """Express child-frame spatial inertia in the parent frame ((p,R) = pose
    of child in parent; motion X maps parent->child)."""
    Rt = R.T
    X = np.zeros((6, 6))
    X[:3, :3] = Rt
    X[3:, 3:] = Rt
    X[:3, 3:] = -Rt @ _hat(p)
    return X.T @ I6 @ X


def build_model(urdf_path: str, name: Optional[str] = None) -> RobotModel:
    tree = ET.parse(urdf_path)
    return _build(tree.getroot(), name)


def _build(robot: ET.Element, name: Optional[str]) -> RobotModel:
    links: Dict[str, ET.Element] = {l.get("name"): l for l in robot.findall("link")}
    joints = robot.findall("joint")

    children: Dict[str, List[ET.Element]] = {}
    child_links = set()
    for j in joints:
        parent = j.find("parent").get("link")
        child = j.find("child").get("link")
        children.setdefault(parent, []).append(j)
        child_links.add(child)

    roots = [ln for ln in links if ln not in child_links]
    if len(roots) != 1:
        raise ValueError(f"URDF must have exactly one root link, found {roots}")
    root = roots[0]

    parents: List[int] = []
    jtypes: List[int] = []
    jp: List[np.ndarray] = []
    jR: List[np.ndarray] = []
    jaxis: List[np.ndarray] = []
    jnames: List[str] = []
    inertias: List[np.ndarray] = [np.zeros((6, 6))]
    eff: List[float] = []
    vel: List[float] = []
    lo: List[float] = []
    hi: List[float] = []
    frames: List[Frame] = []

    def add_subtree(link_name: str, body: int, p: np.ndarray, R: np.ndarray):
        """Attach link `link_name` rigidly to `body` at offset (p, R)."""
        inertias[body] = inertias[body] + _inertia_to_parent(p, R, _link_spatial_inertia(links[link_name]))
        frames.append(Frame(link_name, body, p.copy(), R.copy()))
        for j in children.get(link_name, []):
            op, oR = _origin(j)
            # pose of the joint frame in `body`
            jp_, jR_ = p + R @ op, R @ oR
            jtype = j.get("type")
            jname = j.get("name")
            child = j.find("child").get("link")
            if jtype == "fixed":
                frames.append(Frame(jname, body, jp_.copy(), jR_.copy()))
                add_subtree(child, body, jp_, jR_)
            elif jtype in ("revolute", "continuous", "prismatic"):
                parents.append(body)
                jtypes.append(PRISMATIC if jtype == "prismatic" else REVOLUTE)
                jp.append(jp_)
                jR.append(jR_)
                axis = _vec(j.find("axis").get("xyz") if j.find("axis") is not None else None, [1, 0, 0])
                jaxis.append(axis / np.linalg.norm(axis))
                jnames.append(jname)
                limit = j.find("limit")
                if limit is not None:
                    eff.append(float(limit.get("effort", _INF)))
                    vel.append(float(limit.get("velocity", _INF)))
                    lo.append(float(limit.get("lower", -_INF)))
                    hi.append(float(limit.get("upper", _INF)))
                else:
                    eff.append(_INF); vel.append(_INF); lo.append(-_INF); hi.append(_INF)
                inertias.append(np.zeros((6, 6)))
                new_body = len(inertias) - 1
                frames.append(Frame(jname, new_body, np.zeros(3), np.eye(3)))
                add_subtree(child, new_body, np.zeros(3), np.eye(3))
            else:
                raise NotImplementedError(f"Joint type '{jtype}' not supported")

    add_subtree(root, 0, np.zeros(3), np.eye(3))

    nj = len(parents)
    return RobotModel(
        name=name or robot.get("name", "robot"),
        parent=tuple(parents),
        joint_type=tuple(jtypes),
        joint_p=np.array(jp).reshape(nj, 3),
        joint_R=np.array(jR).reshape(nj, 3, 3),
        joint_axis=np.array(jaxis).reshape(nj, 3),
        joint_names=tuple(jnames),
        inertia=np.stack(inertias),
        effort_limit=np.array(eff),
        velocity_limit=np.array(vel),
        lower_limit=np.array(lo),
        upper_limit=np.array(hi),
        frames=tuple(frames),
    )
