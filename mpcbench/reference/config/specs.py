"""Typed mission / platform / controller specifications.

The port's own copy of the JAX package's host-side loaders: the same YAML
keys, types and defaults (those of the eagle-mpc factories), so any
eagle-mpc YAML loads unchanged and gives the same values field by field.
Parsing produces frozen dataclasses once, on the host; device code only
sees tensors derived from them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..dynamics import urdf as urdf_mod
from ..dynamics.model import RobotModel
from .parser import (MissingValueException, ParamsServer, ParserYaml,
                     get_urdf_path, get_yaml_path)

# Cost model types (reference: factory/cost.hpp:38-63)
COST_STATE = "CostModelState"
COST_CONTROL = "CostModelControl"
COST_FRAME_PLACEMENT = "CostModelFramePlacement"
COST_FRAME_TRANSLATION = "CostModelFrameTranslation"
COST_FRAME_ROTATION = "CostModelFrameRotation"
COST_FRAME_VELOCITY = "CostModelFrameVelocity"
COST_FRICTION_CONE = "CostModelContactFrictionCone"
COST_TYPES = (
    COST_STATE, COST_CONTROL, COST_FRAME_PLACEMENT, COST_FRAME_TRANSLATION,
    COST_FRAME_ROTATION, COST_FRAME_VELOCITY, COST_FRICTION_CONE,
)

# Activation types (reference: factory/activation.hpp:25-35; 4 implemented)
ACT_QUAD = "ActivationModelQuad"
ACT_WEIGHTED_QUAD = "ActivationModelWeightedQuad"
ACT_QUAD_BARRIER = "ActivationModelQuadraticBarrier"
ACT_WEIGHTED_QUAD_BARRIER = "ActivationModelWeightedQuadraticBarrier"
ACT_TYPES = (ACT_QUAD, ACT_WEIGHTED_QUAD, ACT_QUAD_BARRIER, ACT_WEIGHTED_QUAD_BARRIER)

CONTACT_2D = "ContactModel2D"
CONTACT_3D = "ContactModel3D"
CONTACT_6D = "ContactModel6D"

INTEGRATOR_EULER = "IntegratedActionModelEuler"
INTEGRATOR_RK4 = "IntegratedActionModelRK4"

SOLVER_SBFDDP = "SolverSbFDDP"
SOLVER_BOX_FDDP = "SolverBoxFDDP"
SOLVER_BOX_DDP = "SolverBoxDDP"

MPC_CARROT = "Carrot"
MPC_RAIL = "Rail"
MPC_WEIGHTED = "Weighted"


@dataclasses.dataclass(frozen=True)
class PlatformParams:
    """Multicopter platform: thrust model + 6 x n_rotors allocation matrix.

    ``tau_f`` column i = [R_i e3 ; p_i x (R_i e3) + spin_i (cm/cf) R_i e3]
    (reference math: eagle-mpc src/multicopter-base-params.cpp:67-78),
    supporting tilted-rotor, fully-actuated platforms (hextilt)."""

    cf: float
    cm: float
    max_thrust: float
    min_thrust: float
    base_link_name: str
    n_rotors: int
    tau_f: np.ndarray          # (6, n_rotors)
    u_lb: np.ndarray           # (n_rotors + n_arm_joints,)
    u_ub: np.ndarray

    @property
    def max_prop_speed(self) -> float:
        return float(np.sqrt(self.max_thrust / self.cf))

    @property
    def min_prop_speed(self) -> float:
        return float(np.sqrt(self.min_thrust / self.cf))

    @property
    def nu(self) -> int:
        return len(self.u_lb)


def _quat_to_rot_np(q):
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def platform_params(server: ParamsServer, model: RobotModel,
                    prefix: str = "robot/platform/") -> PlatformParams:
    cf = server.get_double(prefix + "cf")
    cm = server.get_double(prefix + "cm")
    max_thrust = server.get_double(prefix + "max_thrust")
    min_thrust = server.get_double(prefix + "min_thrust")
    base_link = server.get_string(prefix + "base_link_name")
    n_rotors = server.get_int(prefix + "n_rotors")
    rotors = server.get_list(prefix + "rotors")
    if len(rotors) != n_rotors:
        raise ValueError("'n_rotors' and the number of rotor poses must match")

    e3 = np.array([0.0, 0.0, 1.0])
    tau_f = np.zeros((6, n_rotors))
    for i, rotor in enumerate(rotors):
        t = np.asarray(rotor["translation"], dtype=np.float64)
        q = np.asarray(rotor["orientation"], dtype=np.float64)
        q = q / np.linalg.norm(q)
        spin = float(np.atleast_1d(rotor["spin_direction"])[0])
        thrust_w = _quat_to_rot_np(q) @ e3
        tau_f[:3, i] = thrust_w
        tau_f[3:, i] = np.cross(t, thrust_w) + spin * (cm / cf) * thrust_w

    # control limits: rotors' thrust range then arm-joint effort limits
    # (eagle-mpc src/multicopter-base-params.cpp:89-101)
    u_lb = np.concatenate([np.full(n_rotors, min_thrust), -model.effort_limit])
    u_ub = np.concatenate([np.full(n_rotors, max_thrust), model.effort_limit])
    return PlatformParams(cf, cm, max_thrust, min_thrust, base_link, n_rotors,
                          tau_f, u_lb, u_ub)


@dataclasses.dataclass(frozen=True)
class CostSpec:
    """One cost entry of a stage (reference: src/factory/cost.cpp)."""

    name: str
    type: str
    weight: float
    active: bool
    activation: str
    nr: int
    # activation params
    act_weights: Optional[np.ndarray] = None     # WeightedQuad / WeightedQuadraticBarrier
    lower_bound: Optional[np.ndarray] = None     # barrier activations
    upper_bound: Optional[np.ndarray] = None
    # residual params (type-dependent)
    reference: Optional[np.ndarray] = None       # state / control refs
    link_name: Optional[str] = None
    frame_id: int = -1
    position: Optional[np.ndarray] = None        # frame placement/translation
    orientation: Optional[np.ndarray] = None     # quaternion (x,y,z,w)
    linear: Optional[np.ndarray] = None          # frame velocity
    angular: Optional[np.ndarray] = None
    n_surf: Optional[np.ndarray] = None          # friction cone
    mu: float = 0.0


@dataclasses.dataclass(frozen=True)
class ContactSpec:
    """One contact entry (reference: src/factory/contacts.cpp)."""

    name: str
    type: str
    link_name: str
    frame_id: int
    position: np.ndarray
    orientation: Optional[np.ndarray]
    gains: np.ndarray


@dataclasses.dataclass(frozen=True)
class StageSpec:
    name: str
    duration: int          # ms
    transition: bool
    t_ini: int             # ms
    costs: Tuple[CostSpec, ...]
    contacts: Tuple[ContactSpec, ...]


def _activation_spec(server: ParamsServer, path: str, nr: int):
    """Activation name + params with reference defaulting
    (src/factory/activation.cpp: missing 'activation' -> Quad; missing
    weights -> ones)."""
    try:
        act = server.get_string(path + "activation")
    except MissingValueException:
        act = ACT_QUAD
    if act not in ACT_TYPES:
        raise ValueError(f"Activation '{act}' @{path} not found")
    weights = None
    lb = None
    ub = None
    if act in (ACT_WEIGHTED_QUAD, ACT_WEIGHTED_QUAD_BARRIER):
        try:
            weights = server.get_vector(path + "weights")
        except MissingValueException:
            weights = np.ones(nr)
        if len(weights) != nr:
            raise ValueError(f"Weights vector @{path}weights has dimension "
                             f"{len(weights)}. Should be {nr}")
    if act in (ACT_QUAD_BARRIER, ACT_WEIGHTED_QUAD_BARRIER):
        lb = server.get_vector(path + "l_bound")
        ub = server.get_vector(path + "u_bound")
        if len(lb) != nr or len(ub) != nr:
            raise ValueError(f"Bound vectors @{path} must have dimension {nr}")
    return act, weights, lb, ub


def cost_spec(server: ParamsServer, path: str, model: RobotModel, nu: int,
              name: str) -> CostSpec:
    ctype = server.get_string(path + "type")
    if ctype not in COST_TYPES:
        raise ValueError(f"Cost {ctype} not found. Please make sure the specified cost exists.")
    weight = server.get_double(path + "weight")
    try:
        active = server.get_bool(path + "active")
    except MissingValueException:
        active = True

    nx = model.nx
    ndx = model.ndx
    kw = dict(name=name, type=ctype, weight=weight, active=active)

    if ctype == COST_STATE:
        act, w, lb, ub = _activation_spec(server, path, ndx)
        try:
            ref = server.get_vector(path + "reference")
        except MissingValueException:
            ref = np.zeros(nx)
            ref[6] = 1.0
        if len(ref) != nx:
            raise ValueError(f"State reference vector @{path}reference has dimension "
                             f"{len(ref)}. Should be {nx}")
        return CostSpec(nr=ndx, activation=act, act_weights=w, lower_bound=lb,
                        upper_bound=ub, reference=ref, **kw)
    if ctype == COST_CONTROL:
        act, w, lb, ub = _activation_spec(server, path, nu)
        try:
            ref = server.get_vector(path + "reference")
        except MissingValueException:
            ref = np.zeros(nu)
        if len(ref) != nu:
            raise ValueError(f"Control reference vector @{path}reference has dimension "
                             f"{len(ref)}. Should be {nu}")
        return CostSpec(nr=nu, activation=act, act_weights=w, lower_bound=lb,
                        upper_bound=ub, reference=ref, **kw)

    link = server.get_string(path + "link_name")
    fid = model.frame_id(link)
    if ctype == COST_FRAME_PLACEMENT:
        act, w, lb, ub = _activation_spec(server, path, 6)
        pos = server.get_vector(path + "position")
        ori = server.get_vector(path + "orientation")
        ori = ori / np.linalg.norm(ori)
        return CostSpec(nr=6, activation=act, act_weights=w, lower_bound=lb,
                        upper_bound=ub, link_name=link, frame_id=fid,
                        position=pos, orientation=ori, **kw)
    if ctype == COST_FRAME_TRANSLATION:
        act, w, lb, ub = _activation_spec(server, path, 3)
        pos = server.get_vector(path + "position")
        return CostSpec(nr=3, activation=act, act_weights=w, lower_bound=lb,
                        upper_bound=ub, link_name=link, frame_id=fid,
                        position=pos, **kw)
    if ctype == COST_FRAME_ROTATION:
        act, w, lb, ub = _activation_spec(server, path, 3)
        ori = server.get_vector(path + "orientation")
        ori = ori / np.linalg.norm(ori)
        return CostSpec(nr=3, activation=act, act_weights=w, lower_bound=lb,
                        upper_bound=ub, link_name=link, frame_id=fid,
                        orientation=ori, **kw)
    if ctype == COST_FRAME_VELOCITY:
        act, w, lb, ub = _activation_spec(server, path, 6)
        lin = server.get_vector(path + "linear")
        ang = server.get_vector(path + "angular")
        return CostSpec(nr=6, activation=act, act_weights=w, lower_bound=lb,
                        upper_bound=ub, link_name=link, frame_id=fid,
                        linear=lin, angular=ang, **kw)
    if ctype == COST_FRICTION_CONE:
        n_surf = server.get_vector(path + "n_surf")
        mu = server.get_double(path + "mu")
        # 4-facet linearized cone with quadratic-barrier activation; bounds
        # lb = 0 (edge rows and min normal force), ub = +inf — the crocoddyl
        # FrictionCone defaults the reference hardcodes
        # (src/factory/cost.cpp:149-168).
        return CostSpec(nr=5, activation=ACT_QUAD_BARRIER, link_name=link,
                        frame_id=fid, n_surf=n_surf / np.linalg.norm(n_surf), mu=mu,
                        lower_bound=np.zeros(5),
                        upper_bound=np.full(5, np.inf), **kw)
    raise AssertionError


def contact_spec(server: ParamsServer, path: str, model: RobotModel,
                 name: str) -> ContactSpec:
    ctype = server.get_string(path + "type")
    if ctype not in (CONTACT_2D, CONTACT_3D, CONTACT_6D):
        raise ValueError(f"Contact {ctype} not found.")
    link = server.get_string(path + "link_name")
    fid = model.frame_id(link)
    pos = server.get_vector(path + "position")
    ori = None
    if ctype == CONTACT_6D:
        ori = server.get_vector(path + "orientation")
        ori = ori / np.linalg.norm(ori)
    try:
        gains = server.get_vector(path + "gains")
    except MissingValueException:
        gains = np.zeros(2)
    return ContactSpec(name=name, type=ctype, link_name=link, frame_id=fid,
                       position=pos, orientation=ori, gains=gains)


@dataclasses.dataclass(frozen=True)
class ProblemParamsSpec:
    dt: int = 0
    use_squash: bool = False
    integrator: str = ""


@dataclasses.dataclass(frozen=True)
class TrajectorySpec:
    """Parsed mission: the analog of a fully autoSetup'd ``Trajectory``
    (eagle-mpc src/trajectory.cpp:21-89)."""

    name: str
    robot_urdf: str
    model: RobotModel
    platform: PlatformParams
    initial_state: np.ndarray
    stages: Tuple[StageSpec, ...]
    problem_params: ProblemParamsSpec
    server: ParamsServer

    @property
    def duration(self) -> int:
        return sum(s.duration for s in self.stages)

    @property
    def has_contact(self) -> bool:
        return any(len(s.contacts) > 0 for s in self.stages)

    @property
    def nu(self) -> int:
        return self.platform.nu


def load_trajectory(yaml_path: str, yaml_dir: Optional[str] = None,
                    robot_dir: Optional[str] = None) -> TrajectorySpec:
    """YAML -> TrajectorySpec (the reference's Trajectory::autoSetup)."""
    path = get_yaml_path(yaml_path, yaml_dir)
    parser = ParserYaml(path, yaml_dir=yaml_dir)
    server = ParamsServer(parser.get_params())

    urdf_path = get_urdf_path(server.get_string("robot/urdf"), robot_dir)
    model = urdf_mod.build_model(urdf_path, name=server.get_string("robot/name"))
    platform = platform_params(server, model)

    try:
        pp = ProblemParamsSpec(
            dt=server.get_int("problem_params/dt"),
            use_squash=server.get_bool("problem_params/use_squash"),
            integrator=server.get_string("problem_params/integrator"),
        )
    except MissingValueException:
        pp = ProblemParamsSpec()

    try:
        x0 = server.get_vector("initial_state")
    except MissingValueException:
        x0 = np.zeros(model.nx)
        x0[6] = 1.0
    if len(x0) != model.nx:
        raise ValueError(
            f"The specified initial state has wrong dimension. Should be {model.nx} "
            f"and it has {len(x0)}")

    nu = platform.nu
    stages = []
    t = 0
    last_duration0 = False
    for descr in server.get_raw("stages"):
        name = descr["name"]
        duration = int(descr["duration"])
        if last_duration0 and duration == 0:
            raise ValueError("Two consecutives stages cannot have duration 0. "
                             "Please, unify them in a single stage.")
        last_duration0 = duration == 0
        base = f"stages/{name}/"
        costs = tuple(
            cost_spec(server, base + f"costs/{c}/", model, nu, c) for c in descr["costs"]
        )
        contacts = tuple(
            contact_spec(server, base + f"contacts/{c}/", model, c)
            for c in descr.get("contacts", [])
        )
        stages.append(StageSpec(name=name, duration=duration,
                                transition=bool(descr["transition"]), t_ini=t,
                                costs=costs, contacts=contacts))
        t += duration

    return TrajectorySpec(
        name=server.get_string("robot/name"),
        robot_urdf=urdf_path,
        model=model,
        platform=platform,
        initial_state=x0,
        stages=tuple(stages),
        problem_params=pp,
        server=server,
    )


@dataclasses.dataclass(frozen=True)
class MpcParamsSpec:
    """mpc_controller/* block (reference: src/mpc-base.cpp:39-58)."""

    integration_method: str
    knots: int
    iters: int
    dt: int
    solver: str
    callback: bool
    server: ParamsServer
    robot_urdf: str
    model: RobotModel
    platform: PlatformParams


def load_mpc_params(yaml_path: str, yaml_dir: Optional[str] = None,
                    robot_dir: Optional[str] = None) -> MpcParamsSpec:
    path = get_yaml_path(yaml_path, yaml_dir)
    parser = ParserYaml(path, yaml_dir=yaml_dir)
    server = ParamsServer(parser.get_params())
    urdf_path = get_urdf_path(server.get_string("robot/urdf"), robot_dir)
    model = urdf_mod.build_model(urdf_path, name=server.get_string("robot/name"))
    platform = platform_params(server, model)
    try:
        callback = server.get_bool("mpc_controller/callback")
    except MissingValueException:
        callback = False
    return MpcParamsSpec(
        integration_method=server.get_string("mpc_controller/integration_method"),
        knots=server.get_int("mpc_controller/knots"),
        iters=server.get_int("mpc_controller/iters"),
        dt=server.get_int("mpc_controller/dt"),
        solver=server.get_string("mpc_controller/solver"),
        callback=callback,
        server=server,
        robot_urdf=urdf_path,
        model=model,
        platform=platform,
    )
