"""Write the JAX reference fixtures that the PyTorch port's tests read.

Each MPC controller of the flagship (hexacopter370_flying_arm_3,
displacement mission, offline reference from missions/refs/) is run
through the JAX package in float64 on the CPU at B=2, and its inputs and
outputs are saved to tests/fixtures/torch_port_<controller>.npz:

- warm start (``warm_*``): ``sbfddp.solve_fixed_batched(depth=4,
  polish="fixed")`` with the default settings (two homotopy stages) from
  the cold bench-style candidates (x0 = reference + seeded noise, xs = x0
  tiled, us = hover);
- tick (``tick_*``): ``update_problem`` + ``sbfddp.solve_fixed(depth=2,
  n_alphas=10, polish="while_fixed", polish_maxiter=1)`` at
  convergence_init=1e-3 + ``AerialSimulator.step`` (2 ms RK4) from
  ``us_squash[0]``. Element 0 starts from the warm-start solution; element
  1 from a rough candidate (seeded noise on states and controls), so the
  DDP polish runs for it.

Carrot (``torch_port_flagship.npz``) warms at 3480 ms and ticks at 3500 ms;
Weighted and Rail (``torch_port_weighted.npz``, ``torch_port_rail.npz``)
at 3180 and 3200 ms. The noise comes from seed 0, except Weighted's from
seed 8. The Weighted solves are chaotic at the level of the tests'
tolerances (cost rtol 1e-8, states rtol 1e-6 / atol 1e-8): over nine seeds of
0-12 the port's plain path landed from 0.002 to 5.6 times a tolerance away
from JAX (seed 0: the warm start's cost 1.01 times; seed 12: the tick's
cost 5.6 times), seed 8 at most 0.07 times in the warm start and 0.004
times in the tick. Besides the ticks:

- carrot: the node derivatives of the XLA path (``calc_diff_all``,
  ``pallas_nodes=False``) on perturbed candidates at 500 and 3500 ms
  (``cd_*``), ``total_cost`` on others (``tc_*``) and one plant step from
  random states (``sim_*``);
- weighted: at the tick's inputs (gaps kept), the node derivatives of the
  XLA path (``cd_*``), the gaps and the gains of one backward pass, and
  the forward pass for each of the 10 alphas (``fp_*``).

The offline path (``torch_port_offline.npz``, ``offline``) is iris, the
hover mission, from ``problem.from_trajectory``:

- ``smoke_*``: ``sbfddp.solve`` at dt 60 ms (T = 18) with maxiter 60 and
  the trace recorded (the JAX package's example smoke solve);
- ``fddp_*`` / ``ddp_*``: ``fddp.solve_fddp`` / ``solve_ddp`` alone from
  ``default_init`` at dt 60 (maxiter 30, th_stop 1e-3);
- ``boxfddp_*`` / ``boxddp_*``: ``fddp.solve_box_fddp`` /
  ``solve_box_ddp`` at dt 40 ms without the squash (T = 27; maxiter 60,
  th_stop 1e-9);
- ``boxqp_*``: ``fddp._boxqp`` on 6 random SPD problems (n = 5) with
  finite, infinite and active bounds;
- ``fpbox_*``: ``fddp._forward_pass(box=True)`` for the 10 alphas on the
  dt-40 box spec at a rough candidate with random gains and gaps
  (element 0 infeasible, element 1 feasible);
- ``esc_*``: ``fddp._compute_direction`` vmapped over 2 elements at dt 60
  from ``default_init``, element 1 with its control-regularization weight
  set to -1e3, so its backward pass fails until the regularization has
  escalated;
- ``batch_*``: ``sbfddp.solve`` vmapped over 3 x0 at dt 60, maxiter 60:
  the mission's (the smoke solve) and two perturbed (sd 0.05, quaternion
  untouched, seed 3).

The closed-loop layer (``torch_port_closed_loop.npz``, ``closed_loop``):

- ``iris_*``: the offline solve of tests/test_mpc.py's ``iris_setup``
  (iris hover, dt 40 ms, ``sbfddp.solve`` at maxiter 100), and
  ``run_closed_loop`` of a CarrotMpc (missions/iris/mpc/mpc.yaml) on it for
  3 ticks at dt_sim 10 ms from the hold-padded warm start, with
  ``fixed=False`` (``cl_while_*``) and ``fixed=True`` (``cl_fixed_*``);
- ``pw_*``: ``sbfddp.solve_fixed(polish="while")`` of the flagship tick
  fixture's rough element (depth 2, convergence_init 1e-3), so the
  while-loop DDP polish runs;
- ``task_*``: ``TaskActivatedCarrotMpc.update_problem`` on iris hover (the
  iris offline solution as its reference) at 4 times around the stage
  change at 1100 ms;
- ``rand_x``: ``State.rand`` of the flagship state from seed 0, and
  ``roll_*``: ``AerialSimulator.rollout`` (flagship, 2 ms) for 5 steps from
  it;
- ``flag_*``: the flagship closed loop of chip_smoke.py's phase 7 step 1
  (CarrotMpc, the dt 30 offline reference, x0 its first state, the warm
  start its first T+1 states and T controls, dt_sim 2 ms, 20 ticks,
  ``fixed=False``), and ``flag_eps_*`` the same from x0 + 1e-12 (off the
  quaternion), to show how far chaining amplifies round-off;
- ``qn_*``: the node derivatives of the XLA path at the flagship carrot
  candidates (t = 3500 ms) with every quaternion's norm 1 + 1e-7
  (element 0) or 1 - 1e-7 (element 1);
- ``sl_*``: node derivatives and ``total_cost`` of a slot-less spec (iris
  hover at dt 40 ms without the squash, its slots removed);
- ``fb_*``: ``fddp.solve_fixed`` on iris hover at dt 60 ms from
  ``default_init`` with a budget of 0 (the final-cost fallback) and of 1;
- ``off32_*``: the flagship offline solve (dt 30, maxiter 400) in float32,
  in a process without x64: iterations, cost and feasibility;
- ``up_*``: the flagship CarrotMpc's ``update_problem`` at the times of
  tests/test_torch_mpc.py (activity and each slot's references).

The contact layer (``torch_port_contacts.npz``, ``contacts``; the
gripper frame of hexacopter370_flying_arm_3):

- ``dyn_*``: at 4 random states (seed 5) and random generalized forces
  (seed 6), ``rbd.frame_jacobian_local``, ``frame_accel_drift``,
  ``frame_velocity`` and ``contact_fwd_dynamics`` with the 3-D rows all
  active (a0 the drift plus w x v), the 6-D rows all active (a0 the
  drift), the 6-D rows half active (the linear ones) and the 3-D rows
  inactive with a random a0; ``fwd_dynamics``; ``kinetic_energy`` and
  ``potential_energy``;
- ``mb_*`` / ``ec_*``: ``sbfddp.solve`` (maxiter 150) of monkey_bar at dt
  40 ms (T = 45) and eagle_catch at dt 50 ms (T = 70), the dt values of
  tests/test_contacts.py; ``*_eps_*`` the same solve from x0 + 1e-12 (off
  the quaternion), which lands elsewhere (the solves amplify round-off far
  past any tolerance, so they are held to feasibility and invariants, not
  to these states); ``*_b64_*`` the same solve in float32 (a process
  without x64) vmapped over the 64 starts of chip_smoke.py's phase 8 step
  2 (x0 plus seeded noise, seed 0, sd 0.05, quaternion untouched):
  iterations, feasibility and failure per element, and the feasibility
  of the same solve from B64_REPLICAS round-off copies of those starts
  (``*_b64_spread_feasible``: copy k moves every entry off the quaternion
  by k * 1e-6, a few float32 ulps); and ``node_calc_diff``
  at the nodes
  ``*_nodes`` of the solution (contact-active, inactive and friction-cone
  nodes) with the parameters as ``from_trajectory`` builds them
  (``*_cd_*``); ``ecr_*`` the same at eagle_catch's contact nodes 31 and
  34 of a rough candidate (the solution plus seeded noise, seed 9: sd 0.05
  on the states, quaternions renormalized, 0.5 on the controls), where the
  friction cone's barrier is active;
- ``m6_*``: ``node_calc_diff`` at contact-active nodes of monkey_bar's
  solution for monkey_bar with its contact switched to ContactModel6D
  (reference orientation the gripper's at the initial state);
- ``it_*``: ``fddp.solve_fddp`` of monkey_bar at dt 100 ms (T = 18) from
  ``default_init``, maxiter 3, th_stop 1e-9, the trace recorded.

The RK4 integrator (``torch_port_rk4.npz``, ``rk4``; every problem built
with ``integrator="IntegratedActionModelRK4"``):

- ``x0``, ``warm_*``, ``tick_*``: the flagship CarrotMpc with RK4 nodes
  (``mpc.yaml`` with ``integration_method`` RK4), as the carrot fixture's
  (seed 0, 3480 / 3500 ms); ``cd_*`` its node derivatives of the XLA path
  on the carrot fixture's perturbed candidates at 500 and 3500 ms;
- ``sp_*``: the flagship mission at dt 20 ms (tests/test_problem.py's
  derivative test) at 3 seeded states and controls (seed 3) and nodes
  0, 40 and 100: ``_stage_points`` (the four points), ``node_calc`` and
  ``node_calc_diff``;
- iris hover at dt 60 ms (T = 18): ``fp_*`` / ``fpbox_*``
  ``fddp._forward_pass`` for the 10 alphas without and with the clip at a
  rough candidate with random gains and gaps (element 0 infeasible,
  element 1 feasible), ``tc_*`` ``total_cost`` there, ``it_*``
  ``fddp.solve_fddp`` from ``default_init`` with maxiter 3 and th_stop
  1e-9, and ``off_*`` ``sbfddp.solve`` at maxiter 100
  (tests/test_missions.py's RK4 mission solve);
- ``mpc_*``: a CarrotMpc with RK4 nodes on iris hover
  (tests/test_mpc.py's ``TestRk4ClosedLoop``; the reference the
  ``iris_*`` solve of ``torch_port_closed_loop.npz``): ``update_problem``
  at 4 times and ``run_closed_loop`` for one tick at dt_sim 10 ms from
  the hold-padded warm start;
- ``mb_*``: ``node_calc_diff`` of monkey_bar at dt 40 ms with RK4 nodes
  at the contact fixture's solution, hang nodes 1 and 15 and the free
  node 35;
- ``ecr4_*``: ``node_calc_diff`` of eagle_catch at dt 50 ms with RK4
  nodes at the contact fixture's rough candidate (``ecr_*``), its contact
  nodes 31 and 34, where the friction cone's barrier is active;
- ``ecfp_*``: ``fddp._forward_pass`` of eagle_catch at dt 50 ms with RK4
  nodes and every cone's mu TIGHT_MU at the contact fixture's solution
  (``ec_*``) for the 10 alphas, infeasible, with the gains and gaps of
  ``fddp._compute_direction`` there (regularization 1e-9): the cone's
  barrier is active along the rollouts;
- monkey_bar at dt 100 ms (T = 18) with RK4 nodes: ``mbit_*``
  ``fddp.solve_fddp`` from ``default_init`` with every candidate state's
  base turned by RK4_TURN about its y axis (the hanging start is turned by
  pi from the state references, on the rotation log's branch cut, where
  the gradients' sign follows round-off at the RK4 stage points), maxiter
  3, th_stop 1e-9, the trace recorded; ``mbfp_*``
  ``fddp._forward_pass`` for the 10 alphas at that start and at
  ``mbit_*``'s result, both infeasible, with the gains and gaps of
  ``fddp._compute_direction`` there (regularization 1e-9).

The scale-out layer (``torch_port_parallel.npz``, ``parallel``), iris
hover at dt 100 ms (T = 11):

- ``batch_*``: ``parallel.make_batch_solver(spec, maxiter=20)`` on
  ``perturbed_x0_batch(params, 8, scale=0.02)`` (``batch_x0``), its
  ``convergence_summary`` (``summary_*``) and the same solve with element
  3's x0 NaN (``nan_*``);
- ``pr_*``: tests/test_priccati.py's candidate, its node derivatives and
  gaps, and ``priccati.parallel_backward_pass`` and
  ``fddp._backward_pass`` there for both ``feasible`` flags and
  regularization 0 and 1e-3;
- ``flag_*``: the same two passes (reg 1e-9, infeasible) at the flagship
  offline reference's solution (missions/refs, dt 30, T = 132) at its
  last homotopy stage, with its node derivatives;
- ``full_*``: ``fddp.solve_fddp`` from ``default_init`` (maxiter 30,
  th_stop 1e-9) with ``parallel_riccati`` True (``full_par_*``) and
  False (``full_seq_*``);
- ``worker_*``: tests/distributed_worker.py's global batch (iris hover at
  dt 200 ms, 8 starts of seed-0 noise, sd 0.03) solved in one process by
  ``sbfddp.solve`` (maxiter 40) under vmap, per element and its
  ``convergence_summary`` (``worker_summary_*``).

The serving layer (``torch_port_serving.npz``, ``serving``): the tick of
tools/serving_bench.py (``one_tick``: ``update_problem``,
``ctrl.solve(fixed=True)`` at ``SbFddpSettings(convergence_init=1e-3)``
with its default ``while`` polish, ``AerialSimulator.step`` of 2 ms from
``us_squash[0]``), unbatched under ``jax.jit`` and chained 3 times per
element, each tick starting from the last one's plant state and solution
at a mission time 2 ms later:

- ``iris_*``: iris hover, ``mpc.yaml`` cut to SERVING_IRIS_KNOTS knots,
  the synthetic reference at dt 20 ms (no cached solve exists), t0 = 0, two
  starts: element 0 the bench's (the reference's first state tiled, hover
  thrust), element 1 a rough one (seeded noise, seed 4: sd 0.05 on x0 off
  the quaternion, 0.3 on the candidate states, quaternions renormalized,
  1.0 on the controls), for which the polish runs in the first tick;
- ``flag_*``: the flagship bench start (missions/refs dt 30, t0 = 3500 ms,
  the reference's state there tiled, hover thrust), one element;
- ``disp_*``: ``viz.MulticopterDisplay``'s geometry of the flagship (the
  gripper frame and the base link displayed, with the CoG) at the offline
  reference's states ``disp_idx``: the base rotation it draws
  (``disp_R_drawn``) and the world rotors (``disp_rotor_p``,
  ``disp_rotor_d``) from it, the base rotation of ``rbd``
  (``disp_R_rbd``) and the rotors from that (``disp_rbd_rotor_p``,
  ``disp_rbd_rotor_d``), the CoG and each frame's placement
  (``disp_frame_p``, ``disp_frame_R``).

Compiling the solvers takes a few minutes on a CPU (about 2 minutes per
controller). Regenerate all nine, or the ones named, with

    JAX_PLATFORMS=cpu python tools/make_torch_port_fixtures.py [flagship weighted rail offline closed_loop contacts rk4 parallel serving]

(``closed_loop`` reads ``torch_port_flagship.npz``, ``rk4`` reads
``torch_port_closed_loop.npz`` and ``torch_port_contacts.npz``.)
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FIXTURES = os.path.join(ROOT, "tests", "fixtures")
ROBOT = "hexacopter370_flying_arm_3"
MISSION = "displacement"
DT_REF = 30
B = 2
SEEDS = {"flagship": 0, "weighted": 8, "rail": 0}
# (warm start, tick) times in ms per controller
TIMES = {"flagship": (3480.0, 3500.0), "weighted": (3180.0, 3200.0),
         "rail": (3180.0, 3200.0)}
NAMES = ("xs", "us", "us_squash", "cost", "iters", "feasible", "failed")
SERVING_IRIS_KNOTS = 12
SERVING_TICKS = 3
SERVING_NAMES = ("x", "xs", "us", "u0", "cost", "iters", "feasible")


def perturbed(spec, x_base, seed):
    """The perturbed candidates of tests/test_node_pallas.py."""
    rng = np.random.default_rng(seed)
    nx, T, nu = spec.model.nx, spec.T, spec.nu
    xs = np.tile(np.asarray(x_base), (B, T + 1, 1))
    xs += rng.normal(size=xs.shape) * 0.03
    xs[..., 3:7] /= np.linalg.norm(xs[..., 3:7], axis=-1, keepdims=True)
    us = rng.normal(size=(B, T, nu)) * 0.5 + 1.0
    return xs, us


def tick_fixture(ctrl, sim, ref, mp, t_warm, t_tick, seed):
    """The warm start and the tick of one controller (module docstring)."""
    import jax

    from eagle_mpc_tpu.ocp import problem as P
    from eagle_mpc_tpu.solvers import sbfddp

    spec = ctrl.spec
    T, nu, nx = spec.T, spec.nu, mp.model.nx
    hover = float(mp.model.inertia[0][0, 0]) * 9.81 / mp.platform.n_rotors

    rng = np.random.default_rng(seed)
    noise = rng.normal(size=(B, nx)) * 0.05
    noise[:, 3:7] = 0.0
    x0 = ref[int(t_warm // DT_REF)][None] + noise
    xs_cold = np.tile(x0[:, None, :], (1, T + 1, 1))
    us_cold = np.zeros((B, T, nu))
    us_cold[:, :, :mp.platform.n_rotors] = hover
    params0 = P.as_device(ctrl.params0)

    def update(t, x):
        return ctrl.update_problem(t, params0._replace(x0=x))

    @jax.jit
    def warm(t, x0, xs, us):
        params_b = jax.vmap(update)(t, x0)
        r = sbfddp.solve_fixed_batched(spec, params_b, xs, us, depth=4,
                                       polish="fixed")
        return r.xs, r.us, r.us_squash, r.cost, r.iters, r.feasible, r.failed

    tick_settings = sbfddp.SbFddpSettings(convergence_init=1e-3)

    @jax.jit
    def tick(t, x0, xs, us):
        def one(t1, x1, xs1, us1):
            r = sbfddp.solve_fixed(spec, update(t1, x1), xs1, us1, depth=2,
                                   settings=tick_settings, n_alphas=10,
                                   polish="while_fixed", polish_maxiter=1)
            x_next = sim.step(x1, r.us_squash[0])
            return (r.xs, r.us, r.us_squash, r.cost, r.iters, r.feasible,
                    r.failed, x_next)
        return jax.vmap(one)(t, x0, xs, us)

    t_w = np.full((B,), t_warm)
    w = [np.asarray(a) for a in warm(t_w, x0, xs_cold, us_cold)]

    t_t = np.full((B,), t_tick)
    rough_xs = xs_cold[1] + rng.normal(size=xs_cold[1].shape) * 0.03
    rough_xs[:, 3:7] /= np.linalg.norm(rough_xs[:, 3:7], axis=-1,
                                       keepdims=True)
    rough_us = rng.normal(size=(T, nu)) * 0.5 + 1.0
    xs_tick = np.stack([w[0][0], rough_xs])
    us_tick = np.stack([w[1][0], rough_us])
    k = [np.asarray(a) for a in tick(t_t, x0, xs_tick, us_tick)]

    out = {"x0": x0, "warm_t": t_w, "warm_xs_in": xs_cold,
           "warm_us_in": us_cold, "tick_t": t_t, "tick_xs_in": xs_tick,
           "tick_us_in": us_tick}
    out.update({f"warm_{n}": a for n, a in zip(NAMES, w)})
    out.update({f"tick_{n}": a for n, a in zip(NAMES + ("x_next",), k)})
    return out


def calc_diff_fixture(ctrl, t_ms, x0, xs, us, prefix="cd"):
    """Node derivatives of the XLA path (running nodes, then the terminal
    node's cost, Lx, Lxx) at (t_ms, x0, xs, us), B problems."""
    import jax
    import jax.numpy as jnp

    from eagle_mpc_tpu.ocp import problem as P

    params0 = P.as_device(ctrl.params0)

    def cd(t1, x1, xs1, us1):
        p = ctrl.update_problem(t1, params0._replace(x0=x1))
        return P.calc_diff_all(ctrl.spec, p, xs1, us1, pallas_nodes=False)

    d, term = jax.jit(jax.vmap(cd))(jnp.asarray(t_ms), jnp.asarray(x0),
                                    jnp.asarray(xs), jnp.asarray(us))
    out = {f"{prefix}_t": np.asarray(t_ms), f"{prefix}_x0": np.asarray(x0),
           f"{prefix}_xs": np.asarray(xs), f"{prefix}_us": np.asarray(us)}
    out.update({f"{prefix}_{n}": np.asarray(getattr(d, n)) for n in d._fields})
    out.update({f"{prefix}_term_{n}": np.asarray(a)
                for n, a in zip(("cost", "Lx", "Lxx"), term)})
    return out


def forward_pass_fixture(ctrl, fx):
    """Gaps (kept: infeasible), one backward pass (reg 1e-9) and the
    forward pass for each of the 10 alphas at the tick's inputs."""
    import jax
    import jax.numpy as jnp

    from eagle_mpc_tpu.ocp import problem as P
    from eagle_mpc_tpu.solvers import fddp

    spec = ctrl.spec
    settings = fddp.SolverSettings()
    alphas = jnp.asarray(settings.alphas)
    params0 = P.as_device(ctrl.params0)
    feasible = jnp.asarray(False)

    def one(t1, x1, xs1, us1):
        p = ctrl.update_problem(t1, params0._replace(x0=x1))
        d, term = P.calc_diff_all(spec, p, xs1, us1, pallas_nodes=False)
        fs = fddp._gaps(spec, p, xs1, d, feasible)
        reg = jnp.asarray(1e-9)
        bp = fddp._backward_pass(spec, d, term, fs, reg, reg, feasible)
        fp = jax.vmap(lambda a: fddp._forward_pass(
            spec, p, xs1, us1, bp, fs, a, feasible, True,
            th_diverge=settings.th_diverge))(alphas)
        return fs, bp.k, bp.K, fp[:4]

    fs, k, K, fp = jax.jit(jax.vmap(one))(
        jnp.asarray(fx["tick_t"]), jnp.asarray(fx["x0"]),
        jnp.asarray(fx["tick_xs_in"]), jnp.asarray(fx["tick_us_in"]))
    out = {"fp_fs": np.asarray(fs), "fp_k": np.asarray(k),
           "fp_K": np.asarray(K)}
    out.update({f"fp_{n}": np.asarray(a) for n, a in
                zip(("xs_try", "us_try", "cost_try", "diverged"), fp)})
    return out


OFFLINE_NAMES = ("xs", "us", "cost", "iters", "feasible", "failed")


def offline_fixture(missions):
    """The offline path's JAX values (module docstring)."""
    import jax
    import jax.numpy as jnp

    from eagle_mpc_tpu.config import specs
    from eagle_mpc_tpu.ocp import problem as P
    from eagle_mpc_tpu.solvers import fddp, sbfddp

    traj = specs.load_trajectory("iris/trajectories/hover.yaml",
                                 yaml_dir=missions)
    euler = "IntegratedActionModelEuler"
    out = {}
    host = lambda a: np.asarray(a)

    spec, params = P.from_trajectory(traj, dt_ms=60, use_squash=True,
                                     integrator=euler)
    st = sbfddp.SbFddpSettings(solver=fddp.SolverSettings(record_trace=True))
    r = jax.jit(lambda p: sbfddp.solve(spec, p, maxiter=60, settings=st))(
        params)
    out.update({f"smoke_{n}": host(getattr(r, n))
                for n in OFFLINE_NAMES + ("us_squash",)})
    out.update({f"smoke_trace_{n}": host(a) for n, a in
                zip(fddp.IterTrace._fields, r.trace)})

    solver = fddp.SolverSettings()
    xs0, us0 = fddp.default_init(spec, params)
    for name, fn in (("fddp", fddp.solve_fddp), ("ddp", fddp.solve_ddp)):
        r = jax.jit(lambda p: fn(spec, solver, p, xs0, us0, 30, 1e-3))(params)
        out.update({f"{name}_{n}": host(getattr(r, n)) for n in OFFLINE_NAMES})

    # the escalation: element 1's control regularization weight -1e3
    k = [s.name for s in spec.slots].index("approach/reg_control")
    p2 = jax.tree_util.tree_map(lambda a: jnp.stack([a, a]),
                                P.as_device(params))
    w = p2.node.weight.at[1, :, k].set(-1e3)
    p2 = p2._replace(node=p2.node._replace(weight=w))
    reg = jnp.full((2,), 1e-9)

    def direction(p, xs, us, xr, ur):
        cost, fs, bp, xr, ur, failed = fddp._compute_direction(
            spec, solver, p, xs, us, jnp.asarray(False), xr, ur)
        return xr, ur, failed, bp.ok, bp.k, bp.K
    esc = jax.jit(jax.vmap(direction))(p2, jnp.stack([xs0, xs0]),
                                       jnp.stack([us0, us0]), reg, reg)
    out.update({f"esc_{n}": host(a) for n, a in
                zip(("xreg", "ureg", "failed", "ok", "k", "K"), esc)})
    out["esc_slot"] = np.asarray(k)

    rng = np.random.default_rng(3)
    noise = rng.normal(size=(3, spec.model.nx)) * 0.05
    noise[:, 3:7] = 0.0
    noise[0] = 0.0       # element 0 is the smoke solve
    x0b = np.asarray(params.x0)[None] + noise
    rb = jax.jit(jax.vmap(lambda x0: sbfddp.solve(
        spec, P.as_device(params)._replace(x0=x0), maxiter=60)))(x0b)
    out["batch_x0"] = x0b
    out.update({f"batch_{n}": host(getattr(rb, n)) for n in OFFLINE_NAMES})

    spec, params = P.from_trajectory(traj, dt_ms=40, use_squash=False,
                                     integrator=euler)
    xs0, us0 = fddp.default_init(spec, params)
    for name, fn in (("boxfddp", fddp.solve_box_fddp),
                     ("boxddp", fddp.solve_box_ddp)):
        r = jax.jit(lambda p: fn(spec, solver, p, xs0, us0, 60, 1e-9))(params)
        out.update({f"{name}_{n}": host(getattr(r, n)) for n in OFFLINE_NAMES})

    # the line search with the clip, at a rough candidate
    T, nx, nu, ndx = spec.T, spec.model.nx, spec.nu, spec.state.ndx
    rng = np.random.default_rng(5)
    hover = float(traj.model.inertia[0][0, 0]) * 9.81 / nu
    xs = np.tile(np.asarray(params.x0), (2, T + 1, 1))
    xs += rng.normal(size=xs.shape) * 0.03
    xs[..., 3:7] /= np.linalg.norm(xs[..., 3:7], axis=-1, keepdims=True)
    us = hover + rng.normal(size=(2, T, nu)) * 2.0
    kff = rng.normal(size=(2, T, nu)) * 3.0
    Kfb = rng.normal(size=(2, T, nu, ndx)) * 0.5
    fs = rng.normal(size=(2, T + 1, ndx)) * 0.01
    feas = np.array([False, True])
    alphas = jnp.asarray(solver.alphas)

    def fp(xs1, us1, k1, K1, fs1, f1):
        bp = fddp.BackwardPassData(k=k1, K=K1, Qu=k1, Quuk=k1, Vx=fs1,
                                   Vxx=None, ok=True)
        return jax.vmap(lambda a: fddp._forward_pass(
            spec, P.as_device(params), xs1, us1, bp, fs1, a, f1, True,
            box=True, th_diverge=solver.th_diverge))(alphas)
    fpr = jax.jit(jax.vmap(fp))(xs, us, kff, Kfb, fs, feas)
    out.update(fpbox_xs=xs, fpbox_us=us, fpbox_k=kff, fpbox_K=Kfb,
               fpbox_fs=fs, fpbox_feasible=feas)
    out.update({f"fpbox_{n}": host(a) for n, a in
                zip(("xs_try", "us_try", "cost_try", "diverged"), fpr)})

    # the box QP on random problems
    rng = np.random.default_rng(7)
    n = 5
    A = rng.normal(size=(6, n, n))
    H = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(n)
    q = rng.normal(size=(6, n)) * 3.0
    lo = -rng.uniform(0.1, 1.0, size=(6, n))
    hi = rng.uniform(0.1, 1.0, size=(6, n))
    lo[:, 0], hi[:, 1] = -np.inf, np.inf
    lo[0], hi[0] = -np.inf, np.inf
    x0 = rng.normal(size=(6, n)) * 0.1
    x, free = jax.jit(jax.vmap(lambda *a: fddp._boxqp(*a, 12)))(H, q, lo, hi,
                                                                x0)
    out.update(boxqp_H=H, boxqp_q=q, boxqp_lo=lo, boxqp_hi=hi, boxqp_x0=x0,
               boxqp_x=host(x), boxqp_free=host(free))
    return out


CL_NAMES = ("states", "controls", "solve_iters", "costs", "xs", "us")

OFF32 = """
import json, os, sys
sys.path.insert(0, {root!r})
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from eagle_mpc_tpu.config import specs
from eagle_mpc_tpu.ocp import problem as P
from eagle_mpc_tpu.solvers import sbfddp
traj = specs.load_trajectory({rel!r}, yaml_dir={missions!r})
spec, params = P.from_trajectory(traj, dt_ms={dt}, use_squash=True,
                                 integrator="IntegratedActionModelEuler",
                                 dtype=jnp.float32)
r = jax.jit(lambda p: sbfddp.solve(spec, p, maxiter=400))(params)
assert r.xs.dtype == jnp.float32
print(json.dumps(dict(iters=int(r.iters), cost=float(r.cost),
                      feasible=bool(r.feasible))))
"""


PRICCATI_REGS = (0.0, 1e-3)  # the parallel fixture's regularizations
B64_REPLICAS = 4  # round-off copies of the f32 B=64 starts (contacts)
B64_F32 = """
import json, os, sys
sys.path.insert(0, {root!r})
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from eagle_mpc_tpu.config import specs
from eagle_mpc_tpu.ocp import problem as P
from eagle_mpc_tpu.solvers import sbfddp
traj = specs.load_trajectory({rel!r}, yaml_dir={missions!r})
spec, params = P.from_trajectory(traj, dt_ms={dt}, use_squash=True,
                                 integrator="IntegratedActionModelEuler",
                                 dtype=jnp.float32)
d = np.random.default_rng(0).normal(size=(64, spec.model.nx)) * 0.05
d[:, 3:7] = 0.0
x0s = (np.asarray(params.x0, np.float64) + d).astype(np.float32)
f = jax.jit(jax.vmap(lambda x0: sbfddp.solve(
    spec, params._replace(x0=x0), maxiter=150)))
r = f(x0s)
assert r.xs.dtype == jnp.float32
spread = []
for k in range(1, {replicas} + 1):
    dx = np.full(x0s.shape, k * 1e-6, np.float32)
    dx[:, 3:7] = 0.0
    spread.append(np.asarray(f(x0s + dx).feasible).tolist())
print(json.dumps(dict(iters=np.asarray(r.iters).tolist(),
                      feasible=np.asarray(r.feasible).tolist(),
                      failed=np.asarray(r.failed).tolist(),
                      spread_feasible=spread)))
"""


def closed_loop_fixture(missions, mp, traj, ref, sim):
    """The closed-loop layer's JAX values (module docstring); ``mp``,
    ``traj``, ``ref`` and ``sim`` are the flagship's."""
    import dataclasses
    import json
    import subprocess

    import jax
    import jax.numpy as jnp

    from eagle_mpc_tpu.config import specs
    from eagle_mpc_tpu.dynamics.state import State
    from eagle_mpc_tpu.mpc import CarrotMpc, TaskActivatedCarrotMpc, run_closed_loop
    from eagle_mpc_tpu.ocp import problem as P
    from eagle_mpc_tpu.sim import AerialSimulator
    from eagle_mpc_tpu.solvers import fddp, sbfddp

    host = lambda a: np.asarray(a)
    out = {}
    euler = "IntegratedActionModelEuler"

    def warm(ctrl, xs, us):
        T = ctrl.spec.T
        pad = max(0, T + 1 - xs.shape[0])
        xs_w = np.vstack([xs, np.tile(xs[-1], (pad, 1))])[:T + 1]
        us_w = np.vstack([us, np.tile(us[-1], (pad, 1))])[:T]
        return jnp.asarray(xs_w), jnp.asarray(us_w)

    # (a) iris hover: the offline solve and 3 closed-loop ticks, both routes
    itraj = specs.load_trajectory("iris/trajectories/hover.yaml",
                                  yaml_dir=missions)
    imp = specs.load_mpc_params("iris/mpc/mpc.yaml", yaml_dir=missions)
    spec, params = P.from_trajectory(itraj, dt_ms=40, use_squash=True,
                                     integrator=euler)
    r = jax.jit(lambda p: sbfddp.solve(spec, p, maxiter=100))(params)
    ixs, ius = host(r.xs), host(r.us)
    out.update(iris_xs=ixs, iris_us=ius, iris_iters=host(r.iters))
    ictrl = CarrotMpc(mpc_params=imp, trajectory=itraj, state_ref=ixs,
                      dt_ref=40)
    isim = AerialSimulator.from_platform(imp.model, imp.platform, dt_ms=10)
    xs_w, us_w = warm(ictrl, ixs, ius)
    for name, fixed in (("while", False), ("fixed", True)):
        cl = jax.jit(lambda x0, a, b: run_closed_loop(
            ictrl, isim, x0, a, b, n_steps=3, dt_sim_ms=10.0,
            fixed=fixed))(jnp.asarray(ixs[0]), xs_w, us_w)
        out.update({f"cl_{name}_{n}": host(a) for n, a in zip(CL_NAMES, cl)})

    # (b) the while polish from the flagship tick fixture's rough element
    fx = np.load(os.path.join(FIXTURES, "torch_port_flagship.npz"))
    ctrl = CarrotMpc(mpc_params=mp, trajectory=traj, state_ref=ref,
                     dt_ref=DT_REF)
    p1 = ctrl.update_problem(fx["tick_t"][1], P.as_device(ctrl.params0)._replace(
        x0=jnp.asarray(fx["x0"][1])))
    r = jax.jit(lambda p, xs, us: sbfddp.solve_fixed(
        ctrl.spec, p, xs, us, depth=2, settings=ctrl.solver_settings(),
        polish="while"))(p1, fx["tick_xs_in"][1], fx["tick_us_in"][1])
    out.update({f"pw_{n}": host(getattr(r, n)) for n in NAMES})

    # (c) the task-activated carrot around the stage change at 1100 ms
    tctrl = TaskActivatedCarrotMpc(mpc_params=imp, trajectory=itraj,
                                   state_ref=ixs, dt_ref=40)
    times = np.array([0.0, 330.0, 1090.0, 1110.0])
    K = tctrl._n_mission_slots
    upd = [tctrl.update_problem(tm, P.as_device(tctrl.params0)) for tm in times]
    out.update(task_t=times,
               task_active=np.stack([host(u.node.active) for u in upd]),
               task_ref=np.stack([host(u.node.refs[K]) for u in upd]))

    # (d), (e) State.rand and the plant's rollout
    st = State(mp.model.nq, mp.model.nv)
    x = host(st.rand(np.random.default_rng(0)))
    u = np.random.default_rng(1).uniform(0.0, 5.0, size=(5, mp.platform.nu))
    out.update(rand_x=x, roll_u=u,
               roll_xs=host(jax.jit(sim.rollout)(jnp.asarray(x), u)))

    # (f) the flagship closed loop of chip_smoke.py's phase 7, step 1
    with np.load(os.path.join(missions, "refs",
                              f"{ROBOT}__{MISSION}__dt{DT_REF}.npz")) as z:
        rus = z["us"]
    xs_w, us_w = warm(ctrl, ref, rus)
    loop = jax.jit(lambda x0: run_closed_loop(ctrl, sim, x0, xs_w, us_w,
                                              n_steps=20, dt_sim_ms=2.0))
    x0 = ref[0].copy()
    out.update({f"flag_{n}": host(a) for n, a in zip(CL_NAMES, loop(x0))})
    x0[:3] += 1e-12
    x0[7:] += 1e-12
    out.update({f"flag_eps_{n}": host(a) for n, a in zip(CL_NAMES, loop(x0))})
    out["flag_eps_x0"] = x0

    # node derivatives at |q| = 1 +- 1e-7
    xs, us = perturbed(ctrl.spec, ctrl.params0.x0, 0)
    xs[0, :, 3:7] *= 1 + 1e-7
    xs[1, :, 3:7] *= 1 - 1e-7
    out.update(calc_diff_fixture(ctrl, np.array([3500.0, 3500.0]), xs[:, 0],
                                 xs, us, prefix="qn"))

    # the slot-less spec: iris hover, raw controls, slots removed
    spec, params = P.from_trajectory(itraj, dt_ms=40, use_squash=False,
                                     integrator=euler)
    spec = dataclasses.replace(spec, slots=())
    node, glob = params.node, params.glob
    params = P.as_device(params._replace(
        node=node._replace(weight=node.weight[:, :0], active=node.active[:, :0],
                           refs=()),
        glob=glob._replace(act_w=(), lb=(), ub=())))
    rng = np.random.default_rng(4)
    T, nu = spec.T, spec.nu
    xs = np.tile(np.asarray(params.x0), (T + 1, 1))
    xs += rng.normal(size=xs.shape) * 0.03
    xs[:, 3:7] /= np.linalg.norm(xs[:, 3:7], axis=-1, keepdims=True)
    us = rng.normal(size=(T, nu)) + 2.0
    d, term = jax.jit(lambda a, b: P.calc_diff_all(
        spec, params, a, b, pallas_nodes=False))(xs, us)
    out.update(sl_xs=xs, sl_us=us,
               sl_total_cost=host(P.total_cost(spec, params, xs, us)))
    out.update({f"sl_{n}": host(getattr(d, n)) for n in d._fields})
    out.update({f"sl_term_{n}": host(a)
                for n, a in zip(("cost", "Lx", "Lxx"), term)})

    # the final-cost fallback: a budget of 0, and of 1
    spec, params = P.from_trajectory(itraj, dt_ms=60, use_squash=True,
                                     integrator=euler)
    solver = fddp.SolverSettings()
    xs0, us0 = fddp.default_init(spec, params)
    for budget in (0, 1):
        r = jax.jit(lambda p: fddp.solve_fixed(
            spec, solver, p, xs0, us0, 1, 1e-9, maxiter=budget))(params)
        out[f"fb_cost{budget}"] = host(r.cost)

    # the flagship carrot's update at tests/test_torch_mpc.py's times
    times = np.array([0.0, 1000.0, 3500.0, 4050.0, 4500.0])
    upd = [ctrl.update_problem(tm, P.as_device(ctrl.params0)) for tm in times]
    out.update(up_t=times,
               up_active=np.stack([host(u.node.active) for u in upd]))
    out.update({f"up_ref{k}": np.stack([host(u.node.refs[k]) for u in upd])
                for k in range(len(ctrl.spec.slots))})

    # the flagship offline solve in float32, without x64
    code = OFF32.format(root=ROOT, missions=missions, dt=DT_REF,
                        rel=f"{ROBOT}/trajectories/{MISSION}.yaml")
    env = dict(os.environ, JAX_ENABLE_X64="0", JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True)
    off32 = json.loads(res.stdout.strip().splitlines()[-1])
    out.update({f"off32_{k}": np.asarray(v) for k, v in off32.items()})
    return out


def contact_6d(traj):
    """``traj`` with every contact switched to a 6-D one that holds its
    frame's initial pose: the reference orientation is the frame's at the
    initial state (the position stays the mission's)."""
    import dataclasses

    from eagle_mpc_tpu.dynamics import lie, rbd

    q0 = np.asarray(traj.initial_state)[:traj.model.nq]

    def six(con):
        R = rbd.frame_placement(traj.model, q0, con.frame_id)[1]
        return dataclasses.replace(con, type="ContactModel6D",
                                   orientation=np.asarray(lie.rot_to_quat(R)))
    return dataclasses.replace(traj, stages=tuple(
        dataclasses.replace(st, contacts=tuple(six(c) for c in st.contacts))
        for st in traj.stages))


CONTACT_SOLVES = {"mb": ("monkey_bar", 40, (1, 15, 29, 35)),
                  "ec": ("eagle_catch", 50, (31, 34, 50))}


def contacts_fixture(missions):
    """The contact layer's JAX values (module docstring)."""
    import json
    import subprocess

    import jax
    import jax.numpy as jnp

    from eagle_mpc_tpu.config import specs
    from eagle_mpc_tpu.dynamics import rbd
    from eagle_mpc_tpu.dynamics.state import State
    from eagle_mpc_tpu.ocp import problem as P
    from eagle_mpc_tpu.solvers import fddp, sbfddp

    euler = "IntegratedActionModelEuler"
    load = lambda name: specs.load_trajectory(
        f"{ROBOT}/trajectories/{name}.yaml", yaml_dir=missions)
    host = lambda a: np.asarray(a)
    out = {}

    # the contact dynamics at random states
    m = load("monkey_bar").model
    fid = m.frame_id("flying_arm_3__gripper")
    st = State(m.nq, m.nv)
    rng = np.random.default_rng(5)
    xs = np.stack([st.rand(rng) for _ in range(4)])
    taus = np.random.default_rng(6).normal(size=(4, m.nv))
    a0r = np.random.default_rng(7).normal(size=(4, 3))

    def dyn(x, tau, a0_rand):
        q, v = x[:m.nq], x[m.nq:]
        J6 = rbd.frame_jacobian_local(m, q, fid)
        drift = rbd.frame_accel_drift(m, q, v, fid)
        vf = rbd.frame_velocity(m, q, v, fid)
        a03 = drift[:3] + jnp.cross(vf[3:], vf[:3])
        cfd = lambda J, a0, act: rbd.contact_fwd_dynamics(m, q, v, tau, J,
                                                          a0, act)
        a3, l3 = cfd(J6[:3], a03, jnp.ones(3))
        a6, l6 = cfd(J6, drift, jnp.ones(6))
        amix, lmix = cfd(J6, drift, jnp.array([1.0, 1, 1, 0, 0, 0]))
        ain, lin = cfd(J6[:3], a0_rand, jnp.zeros(3))
        return dict(J6=J6, drift=drift, vf=vf, a3=a3, lam3=l3, a6=a6,
                    lam6=l6, amix=amix, lammix=lmix, ain=ain, lamin=lin,
                    afree=rbd.fwd_dynamics(m, q, v, tau),
                    ke=rbd.kinetic_energy(m, q, v),
                    pe=rbd.potential_energy(m, q))
    vals = jax.jit(jax.vmap(dyn))(xs, taus, a0r)
    out.update(dyn_x=xs, dyn_tau=taus, dyn_a0=a0r, dyn_frame=fid)
    out.update({f"dyn_{k}": host(v) for k, v in vals.items()})

    def derivs(spec, params, xs_sol, us_sol, nodes):
        f = jax.jit(lambda view, x, s: P.node_calc_diff(spec, view,
                                                        params.glob, x, s))
        got = [f(P.node_view(params.node, t), xs_sol[t], us_sol[t])
               for t in nodes]
        return {n: np.stack([host(getattr(g, n)) for g in got])
                for n in P.NodeDerivatives._fields}

    for key, (name, dt_ms, nodes) in CONTACT_SOLVES.items():
        traj = load(name)
        spec, params = P.from_trajectory(traj, dt_ms=dt_ms, use_squash=True,
                                         integrator=euler)
        solve = jax.jit(lambda p: sbfddp.solve(spec, p, maxiter=150))
        r = solve(params)
        out.update({f"{key}_{n}": host(getattr(r, n))
                    for n in NAMES + ("smooth",)})
        x0 = np.array(params.x0)
        x0[:3] += 1e-12
        x0[7:] += 1e-12
        r_eps = solve(params._replace(x0=x0))
        out.update({f"{key}_eps_{n}": host(getattr(r_eps, n)) for n in NAMES})
        code = B64_F32.format(root=ROOT, missions=missions, dt=dt_ms,
                              rel=f"{ROBOT}/trajectories/{name}.yaml",
                              replicas=B64_REPLICAS)
        env = dict(os.environ, JAX_ENABLE_X64="0", JAX_PLATFORMS="cpu")
        res = subprocess.run([sys.executable, "-c", code], env=env,
                             check=True, capture_output=True, text=True)
        b64 = json.loads(res.stdout.strip().splitlines()[-1])
        out.update({f"{key}_b64_{k}": np.asarray(v) for k, v in b64.items()})
        out[f"{key}_nodes"] = np.array(nodes)
        xs_sol, us_sol = np.asarray(r.xs), np.asarray(r.us)
        out.update({f"{key}_cd_{n}": v for n, v in
                    derivs(spec, params, xs_sol, us_sol, nodes).items()})
        if key == "ec":
            rng = np.random.default_rng(9)
            xr = xs_sol + rng.normal(size=xs_sol.shape) * 0.05
            xr[:, 3:7] /= np.linalg.norm(xr[:, 3:7], axis=-1, keepdims=True)
            ur = us_sol + rng.normal(size=us_sol.shape) * 0.5
            out["ecr_nodes"] = np.array(nodes[:2])
            out["ecr_xs"], out["ecr_us"] = xr, ur
            out.update({f"ecr_cd_{n}": v for n, v in derivs(
                spec, params, xr, ur, nodes[:2]).items()})
        if key == "mb":
            spec6, params6 = P.from_trajectory(
                contact_6d(traj), dt_ms=dt_ms, use_squash=True,
                integrator=euler)
            out["m6_nodes"] = np.array(nodes[:2])
            out.update({f"m6_cd_{n}": v for n, v in derivs(
                spec6, params6, xs_sol, us_sol, nodes[:2]).items()})

    # three FDDP iterations of monkey_bar at dt 100
    spec, params = P.from_trajectory(load("monkey_bar"), dt_ms=100,
                                     use_squash=True, integrator=euler)
    solver = fddp.SolverSettings(record_trace=True)
    xs0, us0 = fddp.default_init(spec, params)
    r = jax.jit(lambda p: fddp.solve_fddp(spec, solver, p, xs0, us0, 3,
                                          1e-9))(params)
    out.update({f"it_{n}": host(getattr(r, n)) for n in OFFLINE_NAMES})
    out.update({f"it_trace_{n}": host(a) for n, a in
                zip(fddp.IterTrace._fields, r.trace)})
    return out


RK4 = "IntegratedActionModelRK4"
RK4_TURN = 1e-3   # rad: monkey_bar's RK4 iterations start off the log's cut
TIGHT_MU = 0.1    # a slippery eagle_catch: the friction cone's barrier active


def rk4_fixture(missions, mp, traj, ref, sim):
    """The RK4 integrator's JAX values (module docstring); ``mp``,
    ``traj``, ``ref`` and ``sim`` are the flagship's."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from eagle_mpc_tpu.config import specs
    from eagle_mpc_tpu.mpc import CarrotMpc, run_closed_loop
    from eagle_mpc_tpu.ocp import problem as P
    from eagle_mpc_tpu.sim import AerialSimulator
    from eagle_mpc_tpu.solvers import fddp, sbfddp

    host = lambda a: np.asarray(a)
    out = {}

    # the flagship carrot with RK4 nodes: warm start, tick, node derivatives
    ctrl = CarrotMpc(mpc_params=dataclasses.replace(
        mp, integration_method=RK4), trajectory=traj, state_ref=ref,
        dt_ref=DT_REF)
    assert ctrl.spec.integrator == P.RK4
    out.update(tick_fixture(ctrl, sim, ref, mp, *TIMES["flagship"],
                            SEEDS["flagship"]))
    xs, us = perturbed(ctrl.spec, ctrl.params0.x0, 0)
    out.update(calc_diff_fixture(ctrl, np.array([500.0, 3500.0]), xs[:, 0],
                                 xs, us))

    # stage points, node_calc and node_calc_diff of the flagship at dt 20
    spec, params = P.from_trajectory(traj, dt_ms=20, use_squash=True,
                                     integrator=RK4)
    params = P.as_device(params)
    st = spec.state
    rng = np.random.default_rng(3)
    nodes = np.array([0, 40, 100])
    xs = np.stack([host(st.rand(rng)) for _ in nodes])
    ss = rng.normal(size=(len(nodes), spec.nu))

    def one(t, x, s):
        view = P.node_view(params.node, t)
        pts, xnext, usq = P._stage_points(spec, view, params.glob, x, s)
        xn, cost, _ = P.node_calc(spec, view, params.glob, x, s)
        d = P.node_calc_diff(spec, view, params.glob, x, s)
        return jnp.stack([p[1] for p in pts]), xnext, usq, xn, cost, d

    got = [jax.jit(one)(t, x, s) for t, x, s in zip(nodes, xs, ss)]
    out.update(sp_nodes=nodes, sp_x=xs, sp_s=ss)
    for i, n in enumerate(("pts", "pts_xnext", "usq", "xnext", "cost")):
        out[f"sp_{n}"] = np.stack([host(g[i]) for g in got])
    out.update({f"sp_cd_{n}": np.stack([host(getattr(g[5], n)) for g in got])
                for n in P.NodeDerivatives._fields})

    # iris hover at dt 60: forward passes, total cost, FDDP, the solve
    itraj = specs.load_trajectory("iris/trajectories/hover.yaml",
                                  yaml_dir=missions)
    spec, params = P.from_trajectory(itraj, dt_ms=60, use_squash=True,
                                     integrator=RK4)
    settings = fddp.SolverSettings()
    rng = np.random.default_rng(13)
    T, nu, ndx = spec.T, spec.nu, spec.state.ndx
    xs0, us0 = fddp.default_init(spec, params)
    xs = np.stack([host(xs0)] * B) + rng.normal(size=(B, T + 1, spec.model.nx)) * 0.02
    xs[..., 3:7] /= np.linalg.norm(xs[..., 3:7], axis=-1, keepdims=True)
    us = np.stack([host(us0)] * B) + rng.normal(size=(B, T, nu)) * 0.3
    kff = rng.normal(size=(B, T, nu)) * 0.3
    Kfb = rng.normal(size=(B, T, nu, ndx)) * 0.05
    fs = rng.normal(size=(B, T + 1, ndx)) * 0.01
    feas = np.array([False, True])
    pj = P.as_device(params)
    for name, box in (("fp", False), ("fpbox", True)):
        def fp(xs1, us1, k1, K1, fs1, f1):
            bp = fddp.BackwardPassData(k=k1, K=K1, Qu=k1, Quuk=k1, Vx=fs1,
                                       Vxx=None, ok=None)
            return jax.vmap(lambda a: fddp._forward_pass(
                spec, pj, xs1, us1, bp, fs1, a, f1, True, box=box,
                th_diverge=settings.th_diverge))(jnp.asarray(settings.alphas))
        r = jax.jit(jax.vmap(fp))(xs, us, kff, Kfb, fs, feas)
        out.update({f"{name}_{n}": host(a) for n, a in
                    zip(("xs_try", "us_try", "cost_try", "diverged"), r)})
    out.update(fp_xs=xs, fp_us=us, fp_k=kff, fp_K=Kfb, fp_fs=fs,
               fp_feasible=feas,
               tc_cost=host(jax.jit(jax.vmap(lambda a, b: P.total_cost(
                   spec, pj, a, b)))(xs, us)))
    r = jax.jit(lambda p: fddp.solve_fddp(spec, settings, p, xs0, us0, 3,
                                          1e-9))(params)
    out.update({f"it_{n}": host(getattr(r, n)) for n in OFFLINE_NAMES})
    r = jax.jit(lambda p: sbfddp.solve(spec, p, maxiter=100))(params)
    out.update({f"off_{n}": host(getattr(r, n))
                for n in OFFLINE_NAMES + ("us_squash",)})

    # a CarrotMpc with RK4 nodes on iris hover: update_problem, one tick
    with np.load(os.path.join(FIXTURES, "torch_port_closed_loop.npz")) as z:
        ixs, ius = z["iris_xs"], z["iris_us"]
    imp = specs.load_mpc_params("iris/mpc/mpc.yaml", yaml_dir=missions)
    ictrl = CarrotMpc(mpc_params=dataclasses.replace(
        imp, integration_method=RK4), trajectory=itraj, state_ref=ixs,
        dt_ref=40)
    assert ictrl.spec.integrator == P.RK4
    times = np.array([0.0, 500.0, 1090.0, 1300.0])
    upd = [ictrl.update_problem(tm, P.as_device(ictrl.params0))
           for tm in times]
    out.update(mpc_t=times,
               mpc_active=np.stack([host(u.node.active) for u in upd]),
               mpc_weight=np.stack([host(u.node.weight) for u in upd]))
    out.update({f"mpc_ref{k}": np.stack([host(u.node.refs[k]) for u in upd])
                for k in range(len(ictrl.spec.slots))})
    Ti = ictrl.spec.T
    pad = max(0, Ti + 1 - ixs.shape[0])
    xs_w = np.vstack([ixs, np.tile(ixs[-1], (pad, 1))])[:Ti + 1]
    us_w = np.vstack([ius, np.tile(ius[-1], (pad, 1))])[:Ti]
    isim = AerialSimulator.from_platform(imp.model, imp.platform, dt_ms=10)
    cl = jax.jit(lambda x0, a, b: run_closed_loop(
        ictrl, isim, x0, a, b, n_steps=1, dt_sim_ms=10.0))(
        jnp.asarray(ixs[0]), jnp.asarray(xs_w), jnp.asarray(us_w))
    out.update({f"mpc_cl_{n}": host(a) for n, a in zip(CL_NAMES, cl)})

    # monkey_bar's nodes with RK4 at the contact fixture's solution
    with np.load(os.path.join(FIXTURES, "torch_port_contacts.npz")) as z:
        mxs, mus = z["mb_xs"], z["mb_us"]
    spec, params = P.from_trajectory(specs.load_trajectory(
        f"{ROBOT}/trajectories/monkey_bar.yaml", yaml_dir=missions),
        dt_ms=40, use_squash=True, integrator=RK4)
    nodes = np.array([1, 15, 35])
    f = jax.jit(lambda view, x, s: P.node_calc_diff(spec, view, params.glob,
                                                    x, s))
    got = [f(P.node_view(params.node, t), mxs[t], mus[t]) for t in nodes]
    out["mb_nodes"] = nodes
    out.update({f"mb_cd_{n}": np.stack([host(getattr(g, n)) for g in got])
                for n in P.NodeDerivatives._fields})
    out.update(rk4_contacts_fixture(missions))
    return out


def rk4_contacts_fixture(missions):
    """The contact missions with RK4 nodes (module docstring: ``ecr4_*``,
    ``ecfp_*``, ``mbfp_*``, ``mbit_*``); reads ``torch_port_contacts.npz``."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from eagle_mpc_tpu.config import specs
    from eagle_mpc_tpu.ocp import problem as P
    from eagle_mpc_tpu.solvers import fddp

    host = lambda a: np.asarray(a)
    load = lambda name, dt_ms: P.from_trajectory(specs.load_trajectory(
        f"{ROBOT}/trajectories/{name}.yaml", yaml_dir=missions),
        dt_ms=dt_ms, use_squash=True, integrator=RK4)
    out = {}

    # eagle_catch's contact nodes at the contact fixture's rough candidate
    with np.load(os.path.join(FIXTURES, "torch_port_contacts.npz")) as z:
        xr, ur, nodes = z["ecr_xs"], z["ecr_us"], z["ecr_nodes"]
    spec, params = load("eagle_catch", 50)
    f = jax.jit(lambda view, x, s: P.node_calc_diff(spec, view, params.glob,
                                                    x, s))
    got = [f(P.node_view(params.node, t), xr[t], ur[t]) for t in nodes]
    out["ecr4_nodes"] = nodes
    out.update({f"ecr4_cd_{n}": np.stack([host(getattr(g, n)) for g in got])
                for n in P.NodeDerivatives._fields})
    settings = fddp.SolverSettings(record_trace=True)

    def forward_passes(key, spec, params, xs, us):
        """``fddp._forward_pass`` for the 10 alphas at each (xs, us) of a
        batch, infeasible, with ``fddp._compute_direction``'s gains and
        gaps there (regularization 1e-9): ``<key>_*``."""
        pj = P.as_device(params)
        feas = np.zeros(xs.shape[0], bool)

        def direction(xs1, us1):
            reg = jnp.asarray(1e-9, xs1.dtype)
            _, fs1, bp, _, _, _ = fddp._compute_direction(
                spec, settings, pj, xs1, us1, jnp.asarray(False), reg, reg)
            return bp.k, bp.K, fs1
        kff, Kfb, fs = (host(a) for a in jax.jit(jax.vmap(direction))(xs, us))

        def fp(xs1, us1, k1, K1, fs1, f1):
            bp = fddp.BackwardPassData(k=k1, K=K1, Qu=k1, Quuk=k1, Vx=fs1,
                                       Vxx=None, ok=None)
            return jax.vmap(lambda a: fddp._forward_pass(
                spec, pj, xs1, us1, bp, fs1, a, f1, True,
                th_diverge=settings.th_diverge))(jnp.asarray(settings.alphas))
        r = jax.jit(jax.vmap(fp))(xs, us, kff, Kfb, fs, feas)
        res = {f"{key}_{n}": host(a) for n, a in
               zip(("xs_try", "us_try", "cost_try", "diverged"), r)}
        res.update({f"{key}_xs": xs, f"{key}_us": us, f"{key}_k": kff,
                    f"{key}_K": Kfb, f"{key}_fs": fs, f"{key}_feasible": feas})
        return res

    # eagle_catch on a slippery surface (every cone's mu TIGHT_MU) at the
    # contact fixture's solution, where the cone's barrier is active along
    # the rollouts (at the rough candidate every alpha diverges)
    with np.load(os.path.join(FIXTURES, "torch_port_contacts.npz")) as z:
        xsol, usol = z["ec_xs"], z["ec_us"]
    traj = specs.load_trajectory(f"{ROBOT}/trajectories/eagle_catch.yaml",
                                 yaml_dir=missions)
    traj = dataclasses.replace(traj, stages=tuple(
        dataclasses.replace(st, costs=tuple(
            dataclasses.replace(c, mu=TIGHT_MU) if c.n_surf is not None
            else c for c in st.costs))
        for st in traj.stages))
    spec, params = P.from_trajectory(traj, dt_ms=50, use_squash=True,
                                     integrator=RK4)
    out.update(forward_passes("ecfp", spec, params, xsol[None], usol[None]))

    # monkey_bar at dt 100: 3 iterations, then forward passes with the
    # solver's own directions (random gains blow these stiff RK4 rollouts
    # up at every alpha). The start is default_init with every candidate
    # state's base turned by RK4_TURN about its y axis: the hanging base
    # is turned by pi from the state references, where the rotation log's
    # branch, and so the sign of Lu, Lx and Lxu, follows the round-off
    # sign of the quaternion's w at the RK4 stage points
    spec, params = load("monkey_bar", 100)
    xs0, us0 = fddp.default_init(spec, params)
    turn = jnp.zeros(spec.state.ndx).at[4].set(RK4_TURN)
    xs0 = jax.vmap(lambda x: spec.state.integrate(x, turn))(xs0)
    r = jax.jit(lambda p: fddp.solve_fddp(spec, settings, p, xs0, us0, 3,
                                          1e-9))(params)
    out.update({f"mbit_{n}": host(getattr(r, n)) for n in OFFLINE_NAMES})
    out.update({f"mbit_trace_{n}": host(a) for n, a in
                zip(fddp.IterTrace._fields, r.trace)})
    out.update(forward_passes("mbfp", spec, params,
                              np.stack([host(xs0), host(r.xs)]),
                              np.stack([host(us0), host(r.us)])))
    return out


def parallel_fixture(missions):
    """The scale-out layer's JAX values (module docstring)."""
    import jax
    import jax.numpy as jnp

    from eagle_mpc_tpu.config import specs
    from eagle_mpc_tpu.ocp import problem as P
    from eagle_mpc_tpu.parallel import (convergence_summary,
                                        make_batch_solver, perturbed_x0_batch)
    from eagle_mpc_tpu.solvers import fddp, priccati, sbfddp

    traj = specs.load_trajectory("iris/trajectories/hover.yaml",
                                 yaml_dir=missions)
    spec, params = P.from_trajectory(traj, dt_ms=100, use_squash=True,
                                     integrator="IntegratedActionModelEuler")
    host = lambda a: np.asarray(a)
    fields = ("xs", "us", "iters", "feasible", "failed", "cost")
    out = {"x0": host(params.x0)}

    bp = perturbed_x0_batch(params, 8, scale=0.02)
    out["batch_x0"] = host(bp.x0)
    solve = make_batch_solver(spec, maxiter=20)
    res = solve(bp)
    out.update({f"batch_{n}": host(getattr(res, n)) for n in fields})
    out.update({f"summary_{k}": np.asarray(v)
                for k, v in convergence_summary(res).items()})
    x0 = np.array(bp.x0)
    x0[3] = np.nan
    res = solve(bp._replace(x0=jnp.asarray(x0)))
    out.update({f"nan_{n}": host(getattr(res, n)) for n in fields})

    # tests/test_priccati.py's candidate
    rng = np.random.default_rng(0)
    T = spec.T
    xs = np.tile(np.asarray(params.x0), (T + 1, 1))
    xs[:, :3] += 0.1 * rng.standard_normal((T + 1, 3))
    xs[:, 7:] += 0.05 * rng.standard_normal((T + 1, xs.shape[1] - 7))
    us = 0.1 * rng.standard_normal((T, spec.nu))
    xs, us = jnp.asarray(xs), jnp.asarray(us)
    derivs, term = P.calc_diff_all(spec, params, xs, us)
    out.update(pr_xs=host(xs), pr_us=host(us))
    out.update({f"pr_d_{n}": host(getattr(derivs, n))
                for n in P.NodeDerivatives._fields})
    out.update({f"pr_term_{i}": host(a) for i, a in enumerate(term)})
    for feasible in (False, True):
        feas = jnp.asarray(feasible)
        fs = fddp._gaps(spec, params, xs, derivs, feas)
        out[f"pr_fs_{int(feasible)}"] = host(fs)
        for reg in PRICCATI_REGS:
            r = jnp.asarray(reg, xs.dtype)
            for kind, bp_fn in (("par", priccati.parallel_backward_pass),
                                ("seq", fddp._backward_pass)):
                got = bp_fn(spec, derivs, term, fs, r, r, feas)
                out.update({f"pr_{kind}_{int(feasible)}_{reg:g}_{n}":
                            host(getattr(got, n))
                            for n in fddp.BackwardPassData._fields})

    # the flagship at the offline reference's solution, last homotopy stage
    ftraj = specs.load_trajectory(f"{ROBOT}/trajectories/{MISSION}.yaml",
                                  yaml_dir=missions)
    fspec, fparams = P.from_trajectory(
        ftraj, dt_ms=DT_REF, use_squash=True,
        integrator="IntegratedActionModelEuler")
    st = sbfddp.SbFddpSettings()
    fparams = sbfddp._set_homotopy(
        fspec, fparams, st.smooth_init * st.smooth_mult ** (st.n_stages - 1))
    ref = np.load(os.path.join(ROOT, "missions", "refs",
                               f"{ROBOT}__{MISSION}__dt{DT_REF}.npz"))
    fxs, fus = jnp.asarray(ref["xs"]), jnp.asarray(ref["us"])
    fderivs, fterm = jax.jit(lambda p, a, b: P.calc_diff_all(fspec, p, a, b))(
        fparams, fxs, fus)
    out.update({f"flag_d_{n}": host(getattr(fderivs, n))
                for n in P.NodeDerivatives._fields})
    out.update({f"flag_term_{i}": host(a) for i, a in enumerate(fterm)})
    feas = jnp.asarray(False)
    ffs = fddp._gaps(fspec, fparams, fxs, fderivs, feas)
    out["flag_fs"] = host(ffs)
    r = jnp.asarray(1e-9, fxs.dtype)
    for kind, bp_fn in (("par", priccati.parallel_backward_pass),
                        ("seq", fddp._backward_pass)):
        got = jax.jit(lambda d, t, f: bp_fn(fspec, d, t, f, r, r, feas))(
            fderivs, fterm, ffs)
        out.update({f"flag_{kind}_{n}": host(getattr(got, n))
                    for n in fddp.BackwardPassData._fields})

    # tests/test_priccati.py's full solve, both passes
    xs0, us0 = fddp.default_init(spec, params)
    for kind, flag in (("par", True), ("seq", False)):
        st = fddp.SolverSettings(parallel_riccati=flag)
        r = jax.jit(lambda p: fddp.solve_fddp(
            spec, st, p, xs0, us0, jnp.asarray(30, jnp.int32),
            jnp.asarray(1e-9, xs0.dtype)))(params)
        out.update({f"full_{kind}_{n}": host(getattr(r, n)) for n in fields})

    # tests/distributed_worker.py's problem and global batch, one process
    wspec, wparams = P.from_trajectory(traj, dt_ms=200, use_squash=True,
                                       integrator="IntegratedActionModelEuler")
    rng = np.random.default_rng(0)
    noise = rng.normal(size=(8, wspec.model.nx)) * 0.03
    noise[:, 3:7] = 0.0
    wx0 = np.asarray(wparams.x0)[None] + noise
    res = jax.jit(jax.vmap(lambda x0: sbfddp.solve(
        wspec, wparams._replace(x0=x0), maxiter=40)))(jnp.asarray(wx0))
    out["worker_x0"] = wx0
    out.update({f"worker_{n}": host(getattr(res, n))
                for n in ("iters", "feasible", "failed", "cost")})
    out.update({f"worker_summary_{k}": np.asarray(v)
                for k, v in convergence_summary(res).items()})
    return out


def serving_fixture(missions, mp, traj, ref):
    """The serving layer's JAX values (module docstring); ``mp``, ``traj``
    and ``ref`` are the flagship's."""
    import dataclasses

    import jax

    from eagle_mpc_tpu.config import specs
    from eagle_mpc_tpu.dynamics import rbd
    from eagle_mpc_tpu.mpc import CarrotMpc
    from eagle_mpc_tpu.ocp import problem as P
    from eagle_mpc_tpu.sim import AerialSimulator
    from eagle_mpc_tpu.solvers import fddp, sbfddp
    from eagle_mpc_tpu.viz import MulticopterDisplay
    from tools.make_ref import load_ref

    settings = sbfddp.SbFddpSettings(convergence_init=1e-3,
                                     solver=fddp.SolverSettings())
    out = {"iris_knots": SERVING_IRIS_KNOTS}

    def chain(prefix, ctrl, sim, t0, x0, xs0, us0):
        params0 = P.as_device(ctrl.params0)

        @jax.jit
        def one_tick(t_ms, x, xs, us):   # tools/serving_bench.py's
            p = ctrl.update_problem(t_ms, params0._replace(x0=x))
            r = ctrl.solve(p, xs, us, settings=settings, fixed=True)
            u = r.us_squash[0]
            return (sim.step(x, u), r.xs, r.us, u, r.cost, r.iters,
                    r.feasible)

        rows = []
        for b in range(x0.shape[0]):
            x, xs, us = x0[b], xs0[b], us0[b]
            ticks = []
            for k in range(SERVING_TICKS):
                o = [np.asarray(a) for a in one_tick(t0 + 2.0 * k, x, xs, us)]
                ticks.append(o)
                x, xs, us = o[:3]
            rows.append([np.stack(a) for a in zip(*ticks)])
        out.update({f"{prefix}_{n}": np.stack(a)
                    for n, a in zip(SERVING_NAMES, zip(*rows))})
        out.update({f"{prefix}_t0": t0, f"{prefix}_x0": x0,
                    f"{prefix}_xs0": xs0, f"{prefix}_us0": us0})

    def start(ctrl, mpp, x):
        T, nu = ctrl.spec.T, ctrl.spec.nu
        hover = float(mpp.model.inertia[0][0, 0]) * 9.81 / mpp.platform.n_rotors
        us = np.zeros((x.shape[0], T, nu))
        us[..., :mpp.platform.n_rotors] = hover
        return np.tile(x[:, None], (1, T + 1, 1)), us

    # iris hover, the horizon cut, two starts
    itraj = specs.load_trajectory("iris/trajectories/hover.yaml",
                                  yaml_dir=missions)
    imp = dataclasses.replace(
        specs.load_mpc_params("iris/mpc/mpc.yaml", yaml_dir=missions),
        knots=SERVING_IRIS_KNOTS)
    iref, kind = load_ref("iris", "hover", 20, traj=itraj)
    assert kind == "synthetic"
    ictrl = CarrotMpc(mpc_params=imp, trajectory=itraj, state_ref=iref,
                      dt_ref=20)
    isim = AerialSimulator.from_platform(imp.model, imp.platform, dt_ms=2)
    rng = np.random.default_rng(4)
    x0 = np.tile(iref[0], (2, 1))
    noise = rng.normal(size=x0.shape[1]) * 0.05
    noise[3:7] = 0.0
    x0[1] += noise
    xs0, us0 = start(ictrl, imp, x0)
    xs0[1] += rng.normal(size=xs0[1].shape) * 0.3
    xs0[1, :, 3:7] /= np.linalg.norm(xs0[1, :, 3:7], axis=-1, keepdims=True)
    us0[1] += rng.normal(size=us0[1].shape) * 1.0
    chain("iris", ictrl, isim, 0.0, x0, xs0, us0)

    # the flagship bench start
    ctrl = CarrotMpc(mpc_params=mp, trajectory=traj, state_ref=ref,
                     dt_ref=DT_REF)
    sim = AerialSimulator.from_platform(mp.model, mp.platform, dt_ms=2)
    t0 = 3500.0
    x0 = ref[int(t0 // DT_REF)][None].copy()
    chain("flag", ctrl, sim, t0, x0, *start(ctrl, mp, x0))

    # the display's geometry at the offline reference's states
    frames = ("flying_arm_3__gripper", mp.platform.base_link_name)
    disp = MulticopterDisplay(mp.model, mp.platform, frame_names=frames,
                              cog=True)
    idx = np.array([0, 40, 80, 120, ref.shape[0] - 1])
    geo = {k: [] for k in ("R_drawn", "rotor_p", "rotor_d", "R_rbd",
                           "rbd_rotor_p", "rbd_rotor_d", "cog", "frame_p",
                           "frame_R")}
    for i in idx:
        x = ref[i]
        _, R = disp._base_pose(x)
        rp, rd = disp._world_rotors(x)
        q = jax.numpy.asarray(x[:mp.model.nq])
        R_rbd = np.asarray(rbd.body_world_placements(mp.model, q)[1][0])
        fp, fR = zip(*(rbd.frame_placement(mp.model, q, mp.model.frame_id(f))
                       for f in frames))
        for k, v in (("R_drawn", R), ("rotor_p", rp), ("rotor_d", rd),
                     ("R_rbd", R_rbd),
                     ("rbd_rotor_p", x[:3] + disp.rotor_pos @ R_rbd.T),
                     ("rbd_rotor_d", disp.rotor_dir @ R_rbd.T),
                     ("cog", disp._cog_world(x)),
                     ("frame_p", np.stack([np.asarray(a) for a in fp])),
                     ("frame_R", np.stack([np.asarray(a) for a in fR]))):
            geo[k].append(np.asarray(v))
    out.update({f"disp_{k}": np.stack(v) for k, v in geo.items()})
    out.update(disp_idx=idx, disp_frames=np.array(frames))
    return out


def main(names):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from eagle_mpc_tpu.config import specs
    from eagle_mpc_tpu.mpc import CarrotMpc, RailMpc, WeightedMpc
    from eagle_mpc_tpu.ocp import problem as P
    from eagle_mpc_tpu.sim import AerialSimulator
    from tools.make_ref import load_ref

    missions = os.path.join(ROOT, "missions")
    traj = specs.load_trajectory(f"{ROBOT}/trajectories/{MISSION}.yaml",
                                 yaml_dir=missions)
    mp = specs.load_mpc_params(f"{ROBOT}/mpc/mpc.yaml", yaml_dir=missions)
    ref, _ = load_ref(ROBOT, MISSION, DT_REF, traj=traj)
    sim = AerialSimulator.from_platform(mp.model, mp.platform, dt_ms=2)
    ctrls = {
        "flagship": CarrotMpc(mpc_params=mp, trajectory=traj, state_ref=ref,
                              dt_ref=DT_REF),
        "weighted": WeightedMpc(mpc_params=mp, trajectory=traj, dt_ref=DT_REF),
        "rail": RailMpc(mpc_params=mp, state_ref=ref, dt_ref=DT_REF),
    }
    os.makedirs(FIXTURES, exist_ok=True)
    names = names or list(ctrls) + ["offline", "closed_loop", "contacts",
                                    "rk4", "parallel", "serving"]
    if "serving" in names:
        path = os.path.join(FIXTURES, "torch_port_serving.npz")
        out = serving_fixture(missions, mp, traj, ref)
        np.savez_compressed(path, **out)
        print(f"wrote {path}")
        for n in ("iris", "flag"):
            print(f"  {n}: iters {out[n + '_iters'].tolist()} feasible "
                  f"{out[n + '_feasible'].tolist()} cost "
                  f"{out[n + '_cost'].tolist()}")
        print(f"  display: max |R drawn - R rbd| "
              f"{np.abs(out['disp_R_drawn'] - out['disp_R_rbd']).max():.3e}")
    if "parallel" in names:
        path = os.path.join(FIXTURES, "torch_port_parallel.npz")
        out = parallel_fixture(missions)
        np.savez_compressed(path, **out)
        print(f"wrote {path}")
        for n in ("batch", "nan", "full_par", "full_seq"):
            print(f"  {n}: iters {out[n + '_iters']} feasible "
                  f"{out[n + '_feasible']} cost {out[n + '_cost']}")
        for n in ("k", "K", "Vx", "Vxx"):
            a, b = out[f"flag_par_{n}"], out[f"flag_seq_{n}"]
            print(f"  flagship {n}: max |parallel - sequential| / max |seq| "
                  f"{np.abs(a - b).max() / np.abs(b).max():.3e}")
        print("  priccati ok: " + ", ".join(
            f"{k[3:-3]} {bool(v)}" for k, v in out.items()
            if k.startswith("pr_") and k.endswith("_ok")))
    if "rk4" in names:
        path = os.path.join(FIXTURES, "torch_port_rk4.npz")
        out = rk4_fixture(missions, mp, traj, ref, sim)
        np.savez_compressed(path, **out)
        print(f"wrote {path}")
        for n in ("warm", "tick"):
            print(f"  {n}: iters {out[n + '_iters']} feasible "
                  f"{out[n + '_feasible']} cost {out[n + '_cost']}")
        for n in ("it", "off"):
            print(f"  {n}: iters {out[n + '_iters']} feasible "
                  f"{out[n + '_feasible']} cost {out[n + '_cost']}")
        print(f"  max |Lxu| at the dt 20 states: "
              f"{np.abs(out['sp_cd_Lxu']).max(axis=(1, 2))}; mpc tick iters "
              f"{out['mpc_cl_solve_iters']}")
    if "contacts" in names:
        path = os.path.join(FIXTURES, "torch_port_contacts.npz")
        out = contacts_fixture(missions)
        np.savez_compressed(path, **out)
        print(f"wrote {path}")
        for k in ("mb", "ec", "mb_eps", "ec_eps", "it"):
            print(f"  {k}: iters {out[k + '_iters']} feasible "
                  f"{out[k + '_feasible']} failed {out[k + '_failed']} cost "
                  f"{out[k + '_cost']}")
        for k in ("mb", "ec"):
            print(f"  {k} f32 B=64: feasible {int(out[k + '_b64_feasible'].sum())}"
                  f", failed {int(out[k + '_b64_failed'].sum())}; from the "
                  f"round-off copies: feasible "
                  f"{out[k + '_b64_spread_feasible'].sum(1).tolist()}")
    if "closed_loop" in names:
        path = os.path.join(FIXTURES, "torch_port_closed_loop.npz")
        out = closed_loop_fixture(missions, mp, traj, ref, sim)
        np.savez_compressed(path, **out)
        print(f"wrote {path}")
        for n in ("cl_while", "cl_fixed", "flag"):
            print(f"  {n}: iters {out[n + '_solve_iters']} costs "
                  f"{out[n + '_costs']}")
        spread = np.abs(out["flag_states"] - out["flag_eps_states"]).max()
        cspread = np.abs(out["flag_costs"] / out["flag_eps_costs"] - 1).max()
        print(f"  flag x0 + 1e-12: iters equal "
              f"{np.array_equal(out['flag_solve_iters'], out['flag_eps_solve_iters'])}"
              f", max |states diff| {spread:.3e}, max cost rel diff {cspread:.3e}")
        print(f"  pw: iters {out['pw_iters']} feasible {out['pw_feasible']}; "
              f"off32: {out['off32_iters']} iters, cost {out['off32_cost']}, "
              f"feasible {out['off32_feasible']}")
    if "offline" in names:
        path = os.path.join(FIXTURES, "torch_port_offline.npz")
        out = offline_fixture(missions)
        np.savez_compressed(path, **out)
        print(f"wrote {path}")
        for n in ("smoke", "fddp", "ddp", "boxfddp", "boxddp", "batch"):
            print(f"  {n}: iters {out[n + '_iters']} feasible "
                  f"{out[n + '_feasible']} cost {out[n + '_cost']}")
        print(f"  esc: xreg {out['esc_xreg']} failed {out['esc_failed']}")
    for name in (n for n in names
                 if n not in ("offline", "closed_loop", "contacts", "rk4",
                              "parallel", "serving")):
        ctrl = ctrls[name]
        out = tick_fixture(ctrl, sim, ref, mp, *TIMES[name], SEEDS[name])
        if name == "flagship":
            x_base = ctrl.params0.x0
            xs, us = perturbed(ctrl.spec, x_base, 0)
            out.update(calc_diff_fixture(ctrl, np.array([500.0, 3500.0]),
                                         xs[:, 0], xs, us))
            xs, us = perturbed(ctrl.spec, x_base, 1)
            tc = jax.jit(jax.vmap(lambda x1, xs1, us1: P.total_cost(
                ctrl.spec, ctrl.update_problem(
                    3500.0, P.as_device(ctrl.params0)._replace(x0=x1)),
                xs1, us1)))
            out.update(tc_t=np.full((B,), 3500.0), tc_xs=xs, tc_us=us,
                       tc_cost=np.asarray(tc(xs[:, 0], xs, us)))
            rng = np.random.default_rng(11)
            x = rng.normal(size=(4, mp.model.nx))
            x[:, 3:7] /= np.linalg.norm(x[:, 3:7], axis=-1, keepdims=True)
            u = np.random.default_rng(12).uniform(0.0, 5.0,
                                                  size=(4, mp.platform.nu))
            out.update(sim_x=x, sim_u=u,
                       sim_x_next=np.asarray(jax.jit(jax.vmap(sim.step))(x, u)))
        if name == "weighted":
            out.update(calc_diff_fixture(ctrl, out["tick_t"], out["x0"],
                                         out["tick_xs_in"], out["tick_us_in"]))
            out.update(forward_pass_fixture(ctrl, out))
        path = os.path.join(FIXTURES, f"torch_port_{name}.npz")
        np.savez_compressed(path, **out)
        print(f"wrote {path}")
        for n in ("iters", "feasible", "failed", "cost"):
            print(f"  warm {n}: {out['warm_' + n]}  tick {n}: {out['tick_' + n]}")


if __name__ == "__main__":
    main(sys.argv[1:])
