"""Platform parameter presets for two research hexarotors.

The port's own copy of the JAX package's ``utils.aerial_manipulation``, the
counterpart of the reference's preset classes (``Hexarotor680Params``: a
planar 680 mm frame whose rotor ring comes from the arm angles;
``Hexarotor370Params``: a 370 mm frame with measured rotor poses). They
build the port's :class:`~eagle_mpc_tpu_torch.config.specs.PlatformParams`,
so a preset plugs into problems, simulators and controllers as a YAML
platform does.

The allocation matrix is the YAML path's (the reference's
``multicopter-base-params.cpp:67-78``): column i of ``tau_f`` is
``[R_i e3 ; p_i x (R_i e3) + spin_i (cm/cf) R_i e3]``.
"""

from __future__ import annotations

import numpy as np

from ..config.specs import PlatformParams

_E3 = np.array([0.0, 0.0, 1.0])


def _quat_to_rot(w, x, y, z):
    q = np.array([w, x, y, z], dtype=np.float64)
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _allocation(poses, spins, cf, cm):
    """(6, n) allocation matrix from per-rotor (p, R) poses and spin signs."""
    n = len(poses)
    tau_f = np.zeros((6, n))
    for i, ((p, R), spin) in enumerate(zip(poses, spins)):
        thrust_dir = R @ _E3
        tau_f[:3, i] = thrust_dir
        tau_f[3:, i] = np.cross(p, thrust_dir) + spin * (cm / cf) * thrust_dir
    return tau_f


def _platform(poses, spins, cf, cm, min_thrust, max_thrust,
              base_link_name="base_link", n_arm_joints=0,
              arm_effort_limit=None):
    n = len(poses)
    tau_f = _allocation(poses, spins, cf, cm)
    lb = [min_thrust] * n
    ub = [max_thrust] * n
    if n_arm_joints:
        eff = np.broadcast_to(np.asarray(arm_effort_limit, dtype=np.float64),
                              (n_arm_joints,))
        lb += list(-eff)
        ub += list(eff)
    return PlatformParams(
        cf=cf, cm=cm, max_thrust=max_thrust, min_thrust=min_thrust,
        base_link_name=base_link_name, n_rotors=n, tau_f=tau_f,
        u_lb=np.asarray(lb, dtype=np.float64),
        u_ub=np.asarray(ub, dtype=np.float64))


def hexarotor680_params(n_arm_joints: int = 0,
                        arm_effort_limit=3.0) -> PlatformParams:
    """680 mm hexarotor (Tarot 4008 motors, 1660 propellers).

    Planar rotor ring: arms every 60 deg starting at 30 deg, alternating
    spin (+ for even rotor index). Thrust/drag coefficients derived from
    propeller aerodynamics: cf = cT0 rho D^4 / (2 pi)^2 and
    cm = (cP0 D / (cT0 2 pi)) cf.
    """
    diameter = 0.4064
    air_density = 1.22
    ct0, cp0 = 0.062, 0.02
    cf = (ct0 * air_density * diameter ** 4) / (2 * np.pi) ** 2
    cm = (cp0 * diameter / (ct0 * 2 * np.pi)) * cf
    l_arm = 0.68 / 2

    poses = []
    spins = []
    for idx in range(6):
        angle = (2 * idx + 1) * np.pi / 6
        c, s = np.cos(angle), np.sin(angle)
        R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        poses.append((R @ np.array([l_arm, 0.0, 0.0]), R))
        spins.append((-1.0) ** idx)
    return _platform(poses, spins, cf, cm, 0.0, 2.53 * 9.81,
                     n_arm_joints=n_arm_joints,
                     arm_effort_limit=arm_effort_limit)


def hexarotor370_params(n_arm_joints: int = 0,
                        arm_effort_limit=1.0) -> PlatformParams:
    """370 mm hexarotor (T-Motor F90 1300KV, 6S, GF7042 propellers).

    Measured rotor poses (non-uniform ring, z-axis yaw per rotor);
    alternating spin with - on even rotor index. Coefficients are the
    identified values, not the aerodynamic formula.
    """
    cf = 4.138394792004922e-06
    cm = 6.991478005829954e-08
    rotors = [  # (translation, quaternion wxyz about z)
        ([0.1602147, 0.0925, 0.0], (0.965926, 0, 0, 0.258819)),
        ([0.0, 0.185, 0.0], (0.707107, 0, 0, 0.707107)),
        ([-0.1602147, 0.0925, 0.0], (0.258819, 0, 0, 0.965926)),
        ([-0.1602147, -0.0925, 0.0], (-0.258819, 0, 0, 0.965926)),
        ([0.0, -0.185, 0.0], (0.707107, 0, 0, -0.707107)),
        ([0.1602147, -0.0925, 0.0], (0.965926, 0, 0, -0.258819)),
    ]
    poses = [(np.asarray(p, dtype=np.float64), _quat_to_rot(*q))
             for p, q in rotors]
    spins = [(-1.0) ** (idx + 1) for idx in range(6)]
    return _platform(poses, spins, cf, cm, 0.0, 20.6991,
                     n_arm_joints=n_arm_joints,
                     arm_effort_limit=arm_effort_limit)
