#!/usr/bin/env python3
"""Drive the PyTorch port's MPC ticks (Carrot, Weighted, Rail), its
offline trajectory generation, its closed loop, its contact missions, its
RK4 integrator (with contacts too), its scale-out layer and its serving
layer on one NVIDIA GPU, and hold the kernels to their plain versions on
every robot of missions/.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no ``ok`` line; each prints
its seconds):

1. device: require CUDA; print the card's name and power limit
   (nvidia-smi) and the torch / CUDA versions;
2. build: compile the three hand-written kernels (K1 node linearization,
   K2 line-search rollout, K3 Riccati backward pass) from
   eagle_mpc_tpu_torch/csrc with nvcc into the git-ignored build directory;
3. paths, each with the kernels' launch counts set to 0 just before it and
   read just after (hexacopter370_flying_arm_3 displacement, offline
   reference, B=512, float32, a depth-30 warm start, then chunks of K=10
   chained ticks):
   - carrot (the main path): CarrotMpc from t0=3500 ms, one settle chunk,
     3 timed chunks; gates the tracking error against the reference;
   - weighted: WeightedMpc from t0=3200 ms, one settle chunk, 3 timed
     chunks; the only path on which the frame-cost branches of K1 and K2
     run (pose, velocity and rotation of the base and the gripper);
   - rail: RailMpc from t0=3200 ms, one timed chunk; gates the tracking
     error like carrot;
   each checks that every kernel launched during its timed ticks, finite
   costs and feasibility, and prints solves/s, tick time, warm start and
   peak memory;
4. parity: at the closed-loop state the carrot path ends in, and again at
   the one the weighted path ends in (B=512 scenarios, T=29 nodes, 10
   alphas), each kernel against its plain PyTorch version on the card, in
   float64 (the gate: <= 1e-9 relative to each output's max |entry|) and
   float32 (printed), with CUDA-event times of both and each kernel's
   bound: the larger of the bytes it must move (inputs read once, outputs
   written once) over the card's memory rate and its dense products'
   operations over the f32 rate (no single PyTorch call computes any of
   the three, so there is no library time); K3 also on a ragged batch (the
   first B-3 scenarios) and with an indefinite Quu on every 64th scenario
   (equal per-scenario failures), and its escalating entry on four kinds
   of scenario (as given, retrying, failing up to reg_max, non-finite
   derivatives: ``riccati_escalation_cases``; passes, regularizations and
   failures equal to its plain version's, f64 values under the gate, the
   scenarios without a retry bit for bit the one-pass kernel's, in both
   types); K1 also at the path's states with
   every quaternion renormalized and then with its norm moved to
   1 +- 1e-7;
5. reference: for each controller the float64 tick and warm start at B=2
   through the kernels against the JAX package's fixture
   (tests/fixtures/torch_port_{flagship,weighted,rail}.npz);
6. offline (trajectory generation: ``problem.from_trajectory`` and
   ``sbfddp.solve``, the while-loop FDDP stages and the DDP polish; the
   launch counts set to 0 before step 1 and read after step 4):
   1. the flagship mission at dt 30 ms (T=132, 10 cost slots) in float64
      at B=1 against the JAX package's offline solve
      (missions/refs/..._dt30.npz): feasible, the same iterations, cost to
      rtol 1e-8, xs and us_squash to OFFLINE_ATOL;
   2. the same in float32 at B=1 (feasible; the steady solve time, its
      iterations and ms per iteration, printed beside the JAX package's
      float32 solve of tests/fixtures/torch_port_closed_loop.npz);
   3. float32 at B=64 with x0 perturbed (sd 0.05, seed 0, quaternion
      untouched): every element feasible and finite;
   4. the box solvers on iris hover at dt 40 ms without the squash, float64:
      Box-FDDP (the while loop) and the fixed iteration with ``box=True``
      agree on iterations and controls (1e-8), the controls lie within
      their bounds, and both match tests/fixtures/torch_port_offline.npz;
      K2's box branch must have launched;
   5. parity in float64 of K1, K2 and K3 at the converged flagship state
      and of K1 and K2 (with the clip) at the converged box state (nj = 0,
      no squash), with the box spec's slots and without any (the zero-slot
      launch), and the kernels' and plain versions' times in float32 at
      the flagship state (B=1, T=132);
7. closed loop (``mpc.run_closed_loop`` through ``MpcAbstract.solve``; the
   launch counts set to 0 before step 1 and read after step 3): the
   flagship CarrotMpc, x0 the offline reference's first state, the warm
   start its first T+1 states and T controls, a 2 ms plant:
   1. float64, B=1, the while-loop route (``fixed=False``), 20 ticks,
      against tests/fixtures/torch_port_closed_loop.npz: iterations equal,
      states and controls to rtol 1e-6 / atol 1e-8, costs to rtol 1e-8;
   2. float32, B=1, the while-loop route, 100 ticks: costs finite, the last
      tick feasible, the tracking error under bench.py's envelope (mean
      0.16 m, max 0.35 m); prints ms per tick;
   3. float32, B=512, the fixed route (``fixed=True``: fixed-depth stages
      and the while-loop DDP polish), 10 ticks from the bench's perturbed
      initial states at 0 ms: costs finite, last tick feasible fraction
      >= 0.99; prints solves/s;
   4. parity in float64 of K1, K2 and K3 at the state step 1 ends in;
8. contacts (offline trajectory generation of the two contact missions of
   hexacopter370_flying_arm_3: monkey_bar at dt 40 ms, T=45, a 3-D gripper
   contact with Baumgarte gains [10, 5]; eagle_catch at dt 50 ms, T=70, a
   3-D contact without gains and a friction cone on its force; the launch
   counts, and the count of plain node dynamics run on the card, set to 0
   just before step 1's solves and read after step 2: the plain count must
   be 0):
   1. float64, B=1, against the JAX package
      (tests/fixtures/torch_port_contacts.npz): K1 through the kernel at
      JAX's solution of each mission (and at a rough candidate of
      eagle_catch, where the friction cone is active, and with monkey_bar's
      contact made 6-D) against JAX's node derivatives at its contact-active,
      inactive and cone nodes, to PARITY_RTOL relative to each output's
      largest entry; then ``sbfddp.solve`` at maxiter 150: feasible and
      failed as JAX's, and JAX's own invariants (tests/test_contacts.py):
      |J a + a0| <= 1e-6 at monkey_bar's hang nodes 1, 15 and 29, the
      gripper within 1e-2 / 6e-2 / 9e-2 m of its start there, the perch
      within 0.1 m of [1, 0, 0.5], eagle_catch's world normal force >= -1e-6
      at its middle contact node (the invariants evaluated on host
      copies). Its iterations, cost and states are printed beside JAX's,
      with JAX's own solve from x0 + 1e-12: these solves amplify round-off
      far past any tolerance (monkey_bar: 450 against 272 iterations,
      states 57 m apart), so no implementation that is not bitwise JAX's
      can match them;
   2. float32, each mission at B=1 and at B=64 (x0 perturbed as in phase
      6): every element finite; at B=1 feasible as the float64 solve; at
      B=64 feasible on no fewer starts than the fewest of the JAX
      package's own float32 solves of the same 64 starts and of four
      round-off copies of them (the fixture's ``*_b64_*``): which start
      ends feasible is as chaotic as the solves; solve ms, iterations and
      ms per iteration printed;
   3. parity in float64 of K1, K2 and K3 at each mission's solution, at
      its last homotopy stage, tiled to B=8 (element 0 the solution,
      feasible; element 1 the solution, infeasible; the others perturbed,
      infeasible), at eagle_catch's with every friction cone's mu 0.1
      (its barrier then active at the solution), and at monkey_bar's with
      its contact switched to a 6-D one: contact-active and inactive
      nodes, the cone slot with its barrier inactive and active, nonzero
      and zero gains; K2 on the lanes whose states and costs stay within
      CONTACT_RUNAWAY, which must include perturbed elements and, on the
      slippery spec, nodes where the cone's barrier is active; on the
      lanes past it (within the solver's 1e8) round-off grows with the
      states, and the plain version on the card is printed against the
      plain version on the host CPU beside the kernel;
   4. the kernels' and plain versions' times in float32 at B=1 at each
      mission's solution, with each kernel's bound;
9. rk4 (the RK4 integrator, crocoddyl's IntegratedActionModelRK4: four
   dynamics passes a node step, the cost quadrature dt/6 (l0 + 2 l1 + 2 l2
   + l3); K1's and K2's RK4 branch; the launch counts, their RK4 counts
   and the count of plain node dynamics run on the card set to 0 just
   before step 1's path and read after step 3: the plain count must be 0
   and every K1 and K2 launch an RK4 one):
   1. the carrot path of phase 3 with ``mpc.yaml``'s integration_method
      switched to IntegratedActionModelRK4 (B=512, float32, t0=3500 ms,
      one settle and 3 timed chunks): the same gates, tracking error
      included, and the same report;
   2. the float64 warm start and tick of that controller at B=2 against the
      JAX package's fixture (tests/fixtures/torch_port_rk4.npz), as phase
      5;
   3. offline: iris hover with RK4 nodes at dt 60 ms, float64, B=1,
      against the fixture (feasible, the same iterations, cost to rtol
      1e-8); the flagship mission with RK4 nodes at dt 30 ms in float32 at
      B=1 and at B=64 (x0 perturbed as in phase 6): every element finite
      and feasible; solve ms and ms per iteration printed;
   4. parity in float64: K1 through the kernel against the fixture's node
      derivatives of the JAX package (the carrot's perturbed candidates at
      B=2); then each kernel against its plain version at the end state of
      step 1, as phase 4 (K1 also at |q| = 1 and 1 +- 1e-7), and K2 also
      with the clip; the kernels' and plain versions' float32 times there,
      with each kernel's bound;
   5. RK4 nodes on the contact missions (K1's and K2's RK4 contact
      branch): K1 in float64 at the JAX fixture's RK4 contact nodes
      (monkey_bar's ``mb_cd_*`` at the contact fixture's solution,
      eagle_catch's ``ecr4_*`` at its rough candidate, where the cone's
      barrier is active) against JAX's node derivatives and, over the
      whole horizon, against its plain version (PARITY_RTOL); three FDDP
      iterations of monkey_bar at dt 100 ms in float64 from the fixture's
      start (``default_init`` with the bases turned RK4_CONTACT_TURN off
      the rotation log's branch cut) against its ``mbit_*`` (the same
      steps, costs, states and controls to RK4_CONTACT_COST_RTOL and
      RK4_CONTACT_XS_RTOL of the largest: a nudge of one unit in the last
      place on every operand moves them as far, and the same solve so
      nudged, RK4_CONTACT_NUDGES seeds, is printed beside them);
      ``sbfddp.solve`` of monkey_bar
      at dt 40 ms in float32 from the mission's start (RK4_CONTACT_MAXITER
      iterations a homotopy stage), the launch counts,
      their RK4 counts and the count of plain node dynamics on the card
      set to 0 just before it: finite, |J a + a0| <= 1e-6 at the hang
      nodes (host copies, float64), no plain node dynamics, every K1 and
      K2 launch an RK4 one; then at each mission's solution (the contact
      fixture's, at its last homotopy stage) the parity of phase 8 step 3
      in float64 at CONTACT_PARITY_B starts (noise RK4_CONTACT_NOISE), with
      eagle_catch also at mu CONTACT_TIGHT_MU, where the cone's barrier
      must be active at some of K1's nodes and K2's compared lanes (its
      rows outside their bounds at a stage point), and the kernels' and
      plain versions' float32 times at B=1 with each kernel's bound;
10. parallel (the scale-out layer: ``parallel.make_batch_solver``, ranks
    of ``parallel.worker`` joined by ``torch.distributed``, and
    ``priccati.parallel_backward_pass``; the launch counts set to 0 just
    before step 1 and read after it; the count of plain node dynamics on
    the card must not move across the phase, the comparisons with the
    plain versions aside):
    1. the batch path in float32: iris hover (examples/batch_scenarios.py's
       defaults: B=1024, dt 40 ms, maxiter 60, x0 noise sd 0.05, seed 0;
       one solve, the kernels warm from the earlier phases) with a
       feasible fraction >= 0.99, and the
       flagship offline problem (B=256, phase 6's settings) with every
       element feasible and finite; solves/s, ms per solve and peak memory
       printed; every kernel launched; then, after the counts are read,
       each kernel against its plain version in float64 at each solve's
       end state (the f32 params, states and controls cast, the final
       homotopy stage, the whole batch, even elements feasible and odd ones
       not), K2's diverged lanes filtered as phase 4 does;
    2. 2 worker ranks on the one card (gloo, ``cuda:0`` each), each
       materializing its half of a seeded global batch of iris hover
       starts (dt 200 ms, maxiter 40): in float64 at B=64 their
       ``all_reduce`` summary, and that of a world of 1 rank under NCCL
       (its init and collectives) run beside them, equal this process's
       ``convergence_summary`` of the same 64 starts, solved meanwhile
       (counts and iterations exactly, the mean cost to rtol 1e-10); in
       float32 at B=1024 the median solves/s of 3 runs of the 2 ranks,
       labelled as 2 ranks on one card, not scaling, beside this
       process's median of 3 runs of the same batch; every rank checks
       that the port imported no jax, JAX package or ``tools``, and
       reports its kernel launches, which must all be positive, and its
       plain node dynamics on the card, which must be none;
    3. the parallel Riccati pass in float64 against the sequential one
       (K3): at tests/test_priccati.py's candidates on iris hover at dt
       100 ms (both ``feasible`` flags, regularization 0 and 1e-3; Vxx and
       Vx to rtol 1e-8 / atol 1e-8, k, K and Qu to rtol 1e-8 / atol 1e-9)
       and at dt 2 ms (T=550; k to rtol 1e-6 / atol 1e-7); at the
       flagship's offline solution (T=132, its last homotopy stage) the
       largest relative error of each output printed; the flagship's
       offline solve with ``parallel_riccati=True`` feasible (iterations
       and cost printed beside the sequential solve's) and iris's
       ``solve_fddp`` at dt 100 equal to the sequential one's
       (tests/test_priccati.py's tolerances); then CUDA-event medians in
       float32 of both passes at the flagship's widths (ndx 18, nu 9) on
       seeded random data, B=1 and B=64, T in {29, 132, 550, 1100}, and
       the T from which the parallel pass is faster.
11. serving (the MPC tick captured in CUDA graphs: ``mpc.graph``, the
    fixed-depth solve's sync-free route, ``serving_bench``, ``realtime``
    with ``utils.rt_executor``):
    1. the serving bench's tick (the flagship CarrotMpc, B=1, float32,
       t0=3500 ms, a 2 ms plant; update, the sync-free solve, the plant
       step, written back into the graph's buffers) warmed up and captured
       in one graph, with ``torch.cuda.set_sync_debug_mode("error")`` over
       the warm-up after the first call and over the capture; each kernel's
       wrapper must have launched while it was captured, and no plain node
       dynamics ran on the card; a ``torch.profiler`` trace of one replay
       must hold each of the three kernels (their device names); K3's
       launches in it are printed (one a direction);
    2. the same tick captured in float64, 3 replays in a row, against the
       same 3 ticks eager on the solve's default route (iterations and
       feasibility equal, states, candidates, controls and costs within
       1e-12 of each one's largest entry, and every field bit for bit, as
       also 3 float32 replays against 3 float32 eager ticks: both routes
       run the same launches) and against the JAX package's
       chained ``one_tick`` of tools/serving_bench.py
       (tests/fixtures/torch_port_serving.npz, ``flag_*``: iterations and
       feasibility equal, states and controls to rtol 1e-6 / atol 1e-8,
       costs to rtol 1e-8);
    3. each kernel against its plain version in float64 at the state the
       replays end in (tiled to B=2, element 1 infeasible), as phase 4,
       and each kernel's bound at B=1 in float32 there;
    4. ``serving_bench.run`` in float32: the capture's seconds,
       ``device_tick`` (K=50 replays in a row, one fetch; median of 5),
       ``roundtrip_tick`` (x0 up, u0 down; median of 25) and
       ``eager_tick`` (K=50 eager ticks on the default route; median of
       2), and peak memory;
    5. the real-time twin (``realtime.serve``): iris hover, the offline
       solve at dt 40 ms, 100 ticks of the two captured graphs at a 20 ms
       period inside the native executor; its statistics printed, every
       tick counted and the plant finite.
12. robots: on the hover mission (dt 60 ms, T=25) of every robot of
    missions/ that no other phase runs (hexacopter370,
    hexacopter680_flying_arm_2, hextilt, hextilt_flying_arm_5 with nj=5 and
    nu=11, iris_px4), with Euler and with RK4 nodes, each kernel against
    its plain version in float64 at ROBOT_B seeded starts around the
    mission's (element 0 feasible), gated as phase 6 step 5; K2 on the
    lanes within CONTACT_RUNAWAY, at least half of them (past it round-off
    grows with the states), and on the lanes past it within RUNAWAY_FACTOR
    times the distance between its plain version on the card and on the
    CPU; K3 also against its recursion in numpy's extended precision,
    and where the plain version lies farther than PARITY_RTOL from that
    (hextilt_flying_arm_5's ill-conditioned Quu) the kernel within
    RICCATI_EXT_FACTOR times the plain version's distance from it.

The last two lines are the per-kernel JSON record and
``{"ok": true, "device": {...}}``.
"""

import functools
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
ROBOT = "hexacopter370_flying_arm_3"
MISSION = "displacement"
DT_REF = 30            # ms between offline reference samples
DT_SIM = 2.0           # ms between ticks
TICKS = 10
# per path: (controller, start of the timed region in ms, settle chunks,
# timed chunks, whether the tracking error is gated)
PATHS = {"carrot": ("carrot", 3500.0, 1, 3, True),
         "weighted": ("weighted", 3200.0, 1, 3, False),
         "rail": ("rail", 3200.0, 0, 1, True),
         "rk4": ("rk4", 3500.0, 1, 3, True)}
MPC_PATHS = ("carrot", "weighted", "rail")   # phase 3; rk4 runs in phase 9
FIXTURES = {"carrot": "torch_port_flagship.npz",
            "weighted": "torch_port_weighted.npz",
            "rail": "torch_port_rail.npz",
            "rk4": "torch_port_rk4.npz"}
RK4 = "IntegratedActionModelRK4"
RK4_PLAIN_REPS = 3     # phase 9: the plain versions take seconds a call
RK4_CONTACT_PLAIN_REPS = 1   # phase 9 step 5: K2's plain version, ~10 s a call
RK4_CONTACT_HANG = (1, 15, 29)   # monkey_bar's hang nodes at dt 40 ms
# phase 9 step 5: the f64 iterations against JAX's (costs, states and
# controls), a few times as far as a nudge of about one unit in the last
# place on every operand moves them (RK4_CONTACT_NUDGES seeds, printed)
RK4_CONTACT_COST_RTOL = 1e-7
RK4_CONTACT_XS_RTOL = 5e-5
RK4_CONTACT_NUDGES = 3
# phase 9 step 5's f32 monkey_bar solve, per homotopy stage: at phase 8's
# 150 both stages ran out of budget (300 iterations, 51 s), as phase 8's
# f32 Euler solve does; its gates do not depend on the budget
RK4_CONTACT_MAXITER = 50
RK4_CONTACT_TURN = 1e-3      # rad: the iterations' start, as the fixture's
RK4_CONTACT_NOISE = (2e-4, 2e-3)   # phase 9 step 5 parity: phase 8's / 10
BATCH = 512
WARM_DEPTH = 30
PARITY_RTOL = 1e-9     # float64 gate, relative to each output's max |entry|
OFFLINE_MAXITER = 400  # per homotopy stage, as the offline reference's solve
OFFLINE_BATCH = 64
OFFLINE_ATOL = 1e-6    # f64 flagship offline solve: xs and us_squash vs JAX
OFFLINE_PLAIN_REPS = 3  # the plain versions at T=132 take up to seconds a call
CL_FIXTURE = "torch_port_closed_loop.npz"
CL_TICKS_F64 = 20      # phase 7 step 1, held to the JAX fixture
CL_TICKS_F32 = 100     # step 2
CL_BATCH = 512         # step 3
CL_TICKS_BATCH = 10
CONTACT_FIXTURE = "torch_port_contacts.npz"
# fixture key -> (mission, dt in ms)
CONTACT_MISSIONS = {"mb": ("monkey_bar", 40), "ec": ("eagle_catch", 50)}
CONTACT_MAXITER = 150  # per homotopy stage, as tests/test_contacts.py
CONTACT_PARITY_B = 8
CONTACT_PLAIN_REPS = 2  # K2's plain version takes seconds a call at T=70
CONTACT_NOISE = (0.002, 0.02)  # phase 8 parity: sd on the states, controls
CONTACT_TIGHT_MU = 0.1  # a slippery eagle_catch: the cone's barrier active
CONTACT_RUNAWAY = 1e3   # phase 8 parity: a lane past it has run away
TIMING_REPS = 20
PAR_IRIS_DT = 40       # phase 10: examples/batch_scenarios.py's defaults
PAR_IRIS_BATCH = 1024
PAR_IRIS_MAXITER = 60
PAR_NOISE = 0.05
PAR_FLAGSHIP_BATCH = 256
PAR_RANKS = 2          # worker ranks sharing the one card (gloo)
PAR_F64_BATCH = 64
PAR_F32_BATCH = 1024
PAR_REPS = 3
PAR_FIXTURE = "torch_port_parallel.npz"
PRICCATI_REGS = (0.0, 1e-3)
PRICCATI_TOL = {"Vxx": (1e-8, 1e-8), "Vx": (1e-8, 1e-8), "k": (1e-8, 1e-9),
                "K": (1e-8, 1e-9), "Qu": (1e-8, 1e-9)}   # (rtol, atol)
PRICCATI_TS = (29, 132, 550, 1100)
PRICCATI_BS = (1, 64)
SERVE_FIXTURE = "torch_port_serving.npz"
SERVE_F64_TICKS = 3     # phase 11 step 2, as the fixture's chain
SERVE_REL = 1e-12       # phase 11 step 2: graph replays against eager ticks
SERVE_K = 50
SERVE_REPS = 5
SERVE_EAGER_REPS = 2
RT_MISSION = ("iris", "hover", 40)   # phase 11 step 5: robot, mission, dt
RT_PERIOD_MS = 20.0
RT_TICKS = 100
# phase 12: the robots of missions/ that no other phase runs, on hover
ROBOTS = ("hexacopter370", "hexacopter680_flying_arm_2", "hextilt",
          "hextilt_flying_arm_5", "iris_px4")
ROBOT_DT = 60          # ms: the 1500 ms mission in T = 25 nodes
ROBOT_B = 4
ROBOT_NOISE = (0.005, 0.01)  # sd on the states; on the controls, of the range
# phase 12's K3 on an ill-conditioned Quu: the kernel's distance from the
# recursion in extended precision, at most this many times the plain
# version's; the wrong K3s there (``_riccati_extended``'s faults) must
# read above that gate
RICCATI_EXT_FACTOR = 4
RICCATI_FAULTS = ("floor", "xreg", "gap")
# phase 12's K2 on the lanes that run away: the kernel's distance from the
# plain version on the card, at most this many times the distance between
# the plain versions on the card and on the CPU
RUNAWAY_FACTOR = 4
# device names of the kernels in a profiler trace
KERNEL_DEVICE_NAMES = {"node_linearization": "node_kernel",
                       "riccati_backward": "riccati_kernel",
                       "alpha_rollout": "rollout_kernel"}
# published peaks of one H100 SXM (NVIDIA's data sheet, 700 W): HBM3
# bytes/s and float32 FLOP/s outside the tensor cores (the kernels use none)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12

KERNELS = (
    ("node_linearization", "eagle_mpc_tpu_torch/csrc/node.cu",
     "eagle_mpc_tpu/ops/node_pallas.py:949"),
    ("riccati_backward", "eagle_mpc_tpu_torch/csrc/riccati.cu",
     "eagle_mpc_tpu/ops/riccati_pallas.py:301"),
    ("alpha_rollout", "eagle_mpc_tpu_torch/csrc/rollout.cu",
     "eagle_mpc_tpu/ops/rollout_pallas.py:170"),
)


class SmokeFailure(Exception):
    pass


def ptxas_summary(log):
    """Registers, stack frame and spills of each kernel entry from the
    build log (nvcc -Xptxas -v), one line per kernel, type and path (K1 and
    K2 have a free-flight and a contact instantiation, K3 a one-pass and an
    escalating one)."""
    import re

    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_Z\d+(\w+?)I([fd])((?:Lb[01]E)*)E",
                      line)
        if m:
            flags = re.findall(r"Lb([01])E", m[3])
            path = ""
            if m[1] == "riccati_kernel":
                path = ", escalating" if flags == ["1"] else ", one pass"
            elif flags:
                path = ", contact" if flags[0] == "1" else ", free"
            if len(flags) > 1 and flags[1] == "1" or m[1] == "node_rk4_kernel":
                path += ", rk4"
            name = f"{m[1]}<{'float' if m[2] == 'f' else 'double'}{path}>"
        elif name and ("stack frame" in line or "Used" in line):
            out.append(f"ptxas {name}: {line.split(':')[-1].strip()}")
            if "Used" in line:
                name = None
    return "\n".join(out)


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(*args):
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# setup shared by the phases
# ---------------------------------------------------------------------------

def flagship(device, dtype, controller="carrot"):
    """Controller (``carrot``, ``weighted`` or ``rail``; ``rk4``: the carrot
    with ``mpc.yaml``'s integration_method RK4), plant and offline
    reference of the bench workload."""
    import dataclasses

    from eagle_mpc_tpu_torch.config import (load_mpc_params, load_ref,
                                            load_trajectory)
    from eagle_mpc_tpu_torch.mpc import CarrotMpc, RailMpc, WeightedMpc
    from eagle_mpc_tpu_torch.sim import AerialSimulator

    missions = os.path.join(ROOT, "missions")
    traj = load_trajectory(f"{ROBOT}/trajectories/{MISSION}.yaml",
                           yaml_dir=missions)
    mp = load_mpc_params(f"{ROBOT}/mpc/mpc.yaml", yaml_dir=missions)
    ref, kind = load_ref(ROBOT, MISSION, DT_REF, traj=traj)
    check(kind == "offline", "offline reference missing from missions/refs")
    kw = dict(mpc_params=mp, dt_ref=DT_REF, device=device, dtype=dtype)
    rk4 = dict(kw, mpc_params=dataclasses.replace(mp, integration_method=RK4))
    ctrl = {"carrot": lambda: CarrotMpc(trajectory=traj, state_ref=ref, **kw),
            "rk4": lambda: CarrotMpc(trajectory=traj, state_ref=ref, **rk4),
            "weighted": lambda: WeightedMpc(trajectory=traj, **kw),
            "rail": lambda: RailMpc(state_ref=ref, **kw)}[controller]()
    sim = AerialSimulator.from_platform(mp.model, mp.platform, DT_SIM,
                                        device=device, dtype=dtype)
    hover = float(mp.model.inertia[0][0, 0]) * 9.81 / mp.platform.n_rotors
    return ctrl, sim, ref, hover, mp.platform.n_rotors


def initial_batch(ctrl, ref, hover, n_rot, B, t_ms, device, dtype):
    """Bench initial states: the reference at t_ms + seed-0 noise (sd 0.05,
    quaternion untouched); xs = x0 tiled, us = hover thrust."""
    import torch

    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    nx, T, nu = ctrl.spec.model.nx, ctrl.spec.T, ctrl.spec.nu
    x_at = ref[min(int(t_ms // DT_REF), ref.shape[0] - 1)].astype(np_dtype)
    rng = np.random.default_rng(0)
    noise = rng.normal(size=(B, nx)).astype(np_dtype) * 0.05
    noise[:, 3:7] = 0.0
    x0 = torch.as_tensor(x_at[None] + noise, device=device, dtype=dtype)
    xs = x0[:, None].expand(B, T + 1, nx).clone()
    us = torch.zeros(B, T, nu, device=device, dtype=dtype)
    us[:, :, :n_rot] = hover
    return x0, xs, us


def warm_start(ctrl, t_ms, x0, xs, us):
    """The bench's warm start: a depth-WARM_DEPTH fixed solve from (xs, us)
    at t_ms with the plant states x0 (B, nx)."""
    import torch

    from eagle_mpc_tpu_torch.ocp import problem as P
    from eagle_mpc_tpu_torch.solvers import sbfddp

    B = x0.shape[0]
    params = ctrl.update_problem(
        torch.full((B,), t_ms, device=x0.device, dtype=x0.dtype),
        P.expand_params(ctrl.params0, B)._replace(x0=x0))
    return sbfddp.solve_fixed(ctrl.spec, params, xs, us, depth=WARM_DEPTH,
                              polish="fixed")


def tick(ctrl, sim, t_ms, xb, xs, us):
    """One closed-loop tick of the bench: update the problem at t_ms from
    the plant states xb (B, nx), solve from the candidates (xs, us) and
    step the plant with the first control. Returns (the solve's result,
    the next plant states)."""
    import torch

    from eagle_mpc_tpu_torch.ocp import problem as P
    from eagle_mpc_tpu_torch.solvers import sbfddp
    from eagle_mpc_tpu_torch.utils import spans

    B = xb.shape[0]
    spans.tick()
    with spans.span("mpc.update"):
        params = ctrl.update_problem(
            torch.full((B,), t_ms, device=xb.device, dtype=xb.dtype),
            P.expand_params(ctrl.params0, B)._replace(x0=xb))
    r = sbfddp.solve_fixed(ctrl.spec, params, xs, us, depth=ctrl.iters,
                           settings=ctrl.solver_settings(), n_alphas=10,
                           polish="while_fixed", polish_maxiter=1)
    return r, sim.step(xb, r.us_squash[:, 0])


def parity_inputs(ctrl, state, device, dtype):
    """A real flagship solver state at B scenarios: the closed loop after the
    main path's ticks (time, plant states, warm-start candidates), with
    every other scenario marked infeasible so both gap-contraction branches
    run."""
    import torch

    from eagle_mpc_tpu_torch.ocp import problem as P

    t_ms, xb, xs, us = state
    B = xb.shape[0]
    cast = lambda a: a.to(device=device, dtype=dtype)
    params = ctrl.update_problem(
        torch.full((B,), t_ms, device=device, dtype=dtype),
        P.expand_params(ctrl.params0, B)._replace(x0=cast(xb)))
    feasible = torch.arange(B, device=device) % 2 == 0
    return params, cast(xs), cast(us), feasible


# ---------------------------------------------------------------------------
# phase 4: kernel vs plain on the card
# ---------------------------------------------------------------------------

def _err(a, b):
    """(max abs error, relative to max |a|) over entries finite in both;
    NaN patterns must agree."""
    import torch

    fa, fb = torch.isfinite(a), torch.isfinite(b)
    check(torch.equal(fa, fb), "kernel and plain version disagree on which "
          "entries are finite")
    if not bool(fa.any()):
        return 0.0, 0.0
    d = (a - b).abs()[fa].max().item()
    scale = max(a.abs()[fa].max().item(), 1e-30)
    return d, d / scale


def _healthy_lanes(outs, bound=1e8):
    """(B, A) lanes of a rollout that the solver would not call diverged:
    finite states, controls and costs below its 1e8 bound (or ``bound``)."""
    import torch

    xs_try, us_try, cs, xn = outs
    return (torch.isfinite(xs_try).all(-1).all(-1)
            & torch.isfinite(us_try).all(-1).all(-1)
            & torch.isfinite(xn).all(-1)
            & (xs_try.abs().amax(dim=(-2, -1)) < bound)
            & (torch.cumsum(cs, dim=-1).abs().amax(dim=-1) < bound))


def _time_ms(fn, reps=TIMING_REPS, warm_up=True):
    """Median ms of ``reps`` calls of ``fn`` (CUDA events), after one
    untimed call unless ``warm_up`` is false."""
    import torch

    if warm_up:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def kernel_calls(ctrl, params, xs, us, feasible, reg, box=False):
    """(kernel fn, plain fn, input tensors, dense operations) per kernel on
    one solver state; K3 and K2 get their inputs from the plain versions of
    the stages before them. The operations count the dense products each
    function must do (a floor: the dynamics and cost rows are left out):
    K1 the nz solves against M's factor, the Gauss-Newton products of the
    STATE slots' 6 x 6 base blocks and of the frame slots' full rows (Lx
    and Lxx), and the Euler step's base block times dD; K2 the feedback
    law, M's Cholesky factor and its two solves per step; K3 the Q terms
    Fx'VxxFx, Fu'VxxFu and Fu'VxxFx per node; on a contact spec with nc
    constraint rows also K1's and K2's products with the KKT factors (K1
    per direction: dJm' lam, Jm M^-1 r, M^-1 Jm' dlam and the solve against
    G's factor; K2 per step: M^-1 Jm', G, its factor and its solve). On an
    RK4 spec K1 does, per stage, the nz solves and the Gauss-Newton
    products of every slot's full rows (n_res x nz) and, on a contact
    spec, the KKT products per direction, and K2 the factorization and
    solves of each of its four stages. ``box`` runs K2 with the controls
    clipped to their bounds."""
    import torch

    from eagle_mpc_tpu_torch.ocp import costs as C
    from eagle_mpc_tpu_torch.ocp import problem as P
    from eagle_mpc_tpu_torch.ops import _cuda, node_cuda, riccati_cuda, rollout_cuda
    from eagle_mpc_tpu_torch.solvers import fddp

    spec = ctrl.spec
    B = xs.shape[0]
    derivs = P.map_params(lambda a: a.contiguous(),
                          node_cuda.calc_diff_running_plain(spec, params, xs, us))
    term = P.terminal_calc_diff(spec, P.terminal_view(params.node, spec.T),
                                params.glob, xs[:, spec.T])
    fs = fddp._gaps(spec, params, xs, derivs.xnext, feasible)
    regs = torch.full((B,), reg, device=xs.device, dtype=xs.dtype)
    eye = torch.eye(spec.state.ndx, device=xs.device, dtype=xs.dtype)
    VxxT = term[2] + regs[:, None, None] * eye
    VxT = term[1] + torch.where(feasible[:, None], torch.zeros_like(term[1]),
                                (VxxT @ fs[:, -1, :, None])[..., 0])
    bargs = (derivs.Fx, derivs.Fu, derivs.Lx, derivs.Lu, derivs.Lxx,
             derivs.Lxu, derivs.Luu, fs[:, :-1].contiguous(), VxT, VxxT,
             regs, regs, feasible)
    k, K = riccati_cuda.backward_plain(*bargs)[:2]
    alphas = torch.tensor(fddp.SolverSettings().alphas, device=xs.device,
                          dtype=xs.dtype)
    keep = (~feasible[:, None]) & (alphas != 1.0)[None, :]
    rargs = (spec, params, xs, us, k, K, fs, alphas, keep, box)
    rows = _cuda.pack_params(spec, params, xs.dtype, xs.device)
    T, A = spec.T, alphas.shape[0]
    nv, ndx, nu = spec.model.nv, spec.state.ndx, spec.nu
    nz, n_state = ndx + nu, sum(s.kind == C.STATE for s in spec.slots)
    nc = spec.nc_rows
    n_frame = sum(s.nr for s in spec.slots if s.kind in C.REF_DIMS)
    n_res = sum(s.nr for s in spec.slots)
    rk4 = spec.integrator == P.RK4
    kkt_ops = nz * (2 * 3 * nc * nv + 2 * 2 * nc * nc)
    k1_ops = (4 * (2 * 2 * nv * nv * nz + 2 * n_res * nz * (nz + 1) + kkt_ops)
              if rk4 else (2 * 2 * nv * nv * nz + 2 * 6 * 6 * 6 * n_state
                           + 2 * n_frame * ndx * (ndx + 1) + 2 * 6 * 6 * nz
                           + kkt_ops))
    step_ops = (nv ** 3 // 3 * 2 + 2 * 2 * nv * nv + 2 * 2 * nv * nv * nc
                + 2 * nc * nc * nv + nc ** 3 // 3 * 2 + 2 * 2 * nc * nc)
    return {
        "node_linearization": (
            lambda: node_cuda.calc_diff_running(spec, params, xs, us),
            lambda: node_cuda.calc_diff_running_plain(spec, params, xs, us),
            (xs[:, :T], us) + rows, B * T * k1_ops),
        "riccati_backward": (
            lambda: riccati_cuda.backward(*bargs),
            lambda: riccati_cuda.backward_plain(*bargs), bargs,
            B * T * (2 * 2 * ndx ** 3 + 2 * ndx * ndx * nu + 2 * ndx * nu * nu
                     + 2 * nu * ndx * ndx)),
        "alpha_rollout": (
            lambda: rollout_cuda.rollout(*rargs),
            lambda: rollout_cuda.rollout_plain(*rargs),
            (xs, us, k, K, fs, params.x0, alphas, keep) + rows,
            B * A * T * (2 * nu * ndx + (4 if rk4 else 1) * step_ops)),
    }


def riccati_cases(bargs, n_ragged, every):
    """K3 against its plain version on the cases its problems-per-block
    design can break: (a) "ragged", the first ``n_ragged`` scenarios, an odd
    count, so the last block is ragged for any even number of problems per
    block (the launcher fits 4 at the flagship in both types); (b)
    "indefinite", ureg = -1e3 on every ``every``-th scenario, whose Quu is
    then indefinite: the per-scenario ok pattern (k, K and Vx all finite,
    as ``fddp._backward_pass`` reads it) must be equal, and the values are
    compared on the ok scenarios. Returns {case: (max abs error, max
    relative error, ok scenarios, scenarios)}."""
    import torch

    from eagle_mpc_tpu_torch.ops import riccati_cuda

    def ok_of(out):
        k, K, _, _, Vx, _ = out
        return (torch.isfinite(k).flatten(1).all(1)
                & torch.isfinite(K).flatten(1).all(1)
                & torch.isfinite(Vx).flatten(1).all(1))

    B = bargs[0].shape[0]
    check(n_ragged % 2 == 1, f"{n_ragged} scenarios: not an odd count")
    bad = torch.arange(B, device=bargs[0].device) % every == every - 1
    ureg = torch.where(bad, torch.full_like(bargs[11], -1e3), bargs[11])
    cases = {"ragged": tuple(a[:n_ragged].contiguous() for a in bargs),
             "indefinite": bargs[:11] + (ureg,) + bargs[12:]}
    out = {}
    for name, args in cases.items():
        got = riccati_cuda.backward(*args)
        want = riccati_cuda.backward_plain(*args)
        ok = ok_of(want)
        check(torch.equal(ok, ok_of(got)), f"riccati_backward {name}: kernel "
              "and plain version disagree on which scenarios fail")
        if name == "indefinite":
            check(not bool(ok[bad].any()), "riccati_backward: ureg = -1e3 left "
                  "a scenario's Quu positive definite")
        errs = [_err(w[ok], g[ok]) for w, g in zip(want, got)]
        out[name] = (max(e[0] for e in errs), max(e[1] for e in errs),
                     int(ok.sum()), ok.numel())
    return out


def riccati_escalation_cases(bargs, reg_factor=10.0, reg_max=1e9):
    """K3's escalating entry (``riccati_cuda.backward_escalating``) on four
    kinds of scenario, kind i % 4 for scenario i, from backward's arguments
    ``bargs`` (their terminal value taken as the terminal cost's gradient
    and Hessian, the last node's gap repeated as the terminal gap):
    0 as given; 1 Luu shifted by -(1 + 2 max diag Quu) I, Quu the last
    node's at the given regularization, so the pass fails and passes again
    after some retries; 2 Luu shifted by -1e15 I, which fails up to
    reg_max; 3 a NaN in Lx and its derivatives marked non-finite, which
    fails without a retry. Checked here: the kernel and the plain version
    (``backward_escalating_plain``) agree exactly on the passes, the final
    regularizations and which scenarios are ok; each kind does what it is
    made for; and the scenarios that did not retry equal the one-pass
    kernel (``riccati_cuda.backward``) on the same terminal value bit for
    bit, NaNs included. Returns {"max_abs", "max_rel" (over the ok
    scenarios' outputs), "passes" (per scenario), "bitwise" (scenarios
    compared bit for bit)}."""
    import torch

    from eagle_mpc_tpu_torch.ops import riccati_cuda
    from eagle_mpc_tpu_torch.solvers import fddp

    (Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs, LxT, LxxT, xreg, ureg,
     feasible) = bargs
    B, dev = Lx.shape[0], Lx.device
    kind = torch.arange(B, device=dev) % 4
    eye = torch.eye(Luu.shape[-1], dtype=Luu.dtype, device=dev)
    fu = Fu[:, -1]
    quu = Luu[:, -1] + fu.mT @ LxxT @ fu
    big = quu.diagonal(dim1=-2, dim2=-1).abs().amax(dim=-1)
    shift = torch.where(kind == 1, 1.0 + 2.0 * big,
                        torch.where(kind == 2, 1e15, 0.0))
    Luu = Luu - shift[:, None, None, None] * eye
    Lx = torch.where((kind == 3)[:, None, None], float("nan"), Lx)
    derivs_ok = kind != 3
    fs = torch.cat([fs, fs[:, -1:]], dim=1)
    settings = fddp.SolverSettings(reg_factor=reg_factor, reg_max=reg_max)
    bound = fddp.escalation_bound(settings, float(xreg.min()), Lx.dtype)
    args = (Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs, LxT, LxxT, xreg, ureg,
            feasible, derivs_ok, reg_factor, reg_max, bound)
    got = riccati_cuda.backward_escalating(*args)
    want = riccati_cuda.backward_escalating_plain(*args)
    for i, name in ((-1, "passes"), (-2, "ok"), (-3, "ureg"), (-4, "xreg")):
        check(torch.equal(got[i], want[i]), f"riccati escalation: kernel and "
              f"plain version disagree on {name}: {got[i].tolist()} against "
              f"{want[i].tolist()}")
    passes, ok = got[-1], got[-2]
    check(bool((ok & (passes == 1))[kind == 0].all()),
          "riccati escalation: a scenario as given retried or failed")
    check(bool(((passes > 1) & ok)[kind == 1].any()), "riccati escalation: "
          "no shifted scenario retried and passed again")
    check(bool(((got[-4] == reg_max) & ~ok)[kind == 2].all()),
          "riccati escalation: a scenario that fails everywhere did not "
          "reach reg_max")
    check(bool(((passes == 1) & ~ok)[kind == 3].all()), "riccati escalation:"
          " a scenario with non-finite derivatives retried or passed")
    errs = [_err(w[ok], g[ok]) for w, g in zip(want[:8], got[:8])]
    # the scenarios that did not retry against the one-pass kernel
    VxT, VxxT = riccati_cuda.terminal_value(LxT, LxxT, fs[:, -1], xreg,
                                            feasible)
    one = riccati_cuda.backward(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs[:, :-1],
                                VxT, VxxT, xreg, ureg, feasible) + (VxT, VxxT)
    first = passes == 1
    bits = {torch.float32: torch.int32, torch.float64: torch.int64}[Lx.dtype]
    for n, (a, b) in enumerate(zip(got[:8], one)):
        check(torch.equal(a[first].view(bits), b[first].view(bits)),
              f"riccati escalation: output {n} of the scenarios that did not "
              "retry differs from the one-pass kernel's")
    return {"max_abs": max(e[0] for e in errs),
            "max_rel": max(e[1] for e in errs),
            "passes": passes.tolist(), "bitwise": int(first.sum())}


def bound_ms(inputs, outputs, flops):
    """(least time in ms, what sets it): bytes moved (each input read once,
    each output written once) over the memory rate, or the operations over
    the f32 rate, whichever is larger."""
    nbytes = sum(t.numel() * t.element_size() for t in inputs + tuple(outputs))
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def quat_norm_parity(spec, params, xs, us):
    """K1 against its plain version in f64 at the states xs with every
    quaternion renormalized (|q| = 1 to f64 precision) and then scaled by
    1 + 1e-7 (even scenarios) or 1 - 1e-7 (odd ones), as a state born in
    f32 has it: {label: max relative error over the outputs}."""
    import torch

    from eagle_mpc_tpu_torch.ops import node_cuda

    q = xs[..., 3:7]
    unit = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    even = torch.arange(xs.shape[0], device=xs.device) % 2 == 0
    scale = torch.where(even, 1 + 1e-7, 1 - 1e-7).to(xs.dtype)[:, None, None]
    out = {}
    for label, qq in (("|q| = 1", unit), ("|q| = 1 +- 1e-7", unit * scale)):
        x = torch.cat([xs[..., :3], qq, xs[..., 7:]], dim=-1)
        got = node_cuda.calc_diff_running(spec, params, x, us)
        want = node_cuda.calc_diff_running_plain(spec, params, x, us)
        out[label] = max(_err(w, g)[1] for w, g in zip(want, got))
    return out


def phase_parity(device, state, controller="carrot", plain_reps=TIMING_REPS):
    """Each kernel against its plain version at the end state of a path
    (module docstring, phase 4; for ``rk4`` K2 with the clip too, phase 9);
    returns {kernel: its numbers}."""
    import torch

    results, k1_f64 = {}, None
    for dtype in (torch.float64, torch.float32):
        ctrl = flagship(device, dtype, controller)[0]
        params, xs, us, feasible = parity_inputs(ctrl, state, device, dtype)
        # a moderate regularization keeps Quu well conditioned, so two
        # Cholesky implementations can agree to 1e-9 (at 1e-9 they differ
        # by cond(Quu) * eps ~ 1e-9 at these states)
        calls = kernel_calls(ctrl, params, xs, us, feasible, reg=1e-2)
        if dtype == torch.float64 and controller == "rk4":
            # K2's clip: the calls with box, for alpha_rollout alone
            clip = kernel_calls(ctrl, params, xs, us, feasible, reg=1e-2,
                                box=True)["alpha_rollout"]
            calls["alpha_rollout (clip)"] = clip
        if dtype == torch.float64:
            for label, rel in quat_norm_parity(ctrl.spec, params, xs,
                                               us).items():
                say(f"{controller} parity f64 node_linearization at states "
                    f"with {label}: max rel {rel:.3e} (gate {PARITY_RTOL:g})")
                check(rel <= PARITY_RTOL, f"{controller} node_linearization "
                      f"at {label}: kernel differs from its plain version")
        for name, (kern, plain, ins, flops) in calls.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            r = results.setdefault(name, {})
            if dtype == torch.float32:
                r["bound_ms"], r["bound_by"] = bound_ms(ins, got, flops)
            if name.startswith("alpha_rollout"):
                # diverged lanes are chaotic and the solver only reads their
                # flag: they must agree, and the values are compared on the
                # lanes that did not diverge
                lanes = _healthy_lanes(want)
                check(torch.equal(lanes, _healthy_lanes(got)),
                      "alpha_rollout: kernel and plain version disagree on "
                      "which lanes diverge")
                say(f"{controller} alpha_rollout {dtype}: {int(lanes.sum())} "
                    f"of {lanes.numel()} lanes did not diverge")
                got = [g[lanes] for g in got]
                want = [w[lanes] for w in want]
            errs = [_err(w, g) for w, g in zip(want, got)]
            abs_err = max(e[0] for e in errs)
            rel_err = max(e[1] for e in errs)
            worst = ""
            if name == "node_linearization":
                worst = (f", worst output "
                         f"{want._fields[max(range(len(errs)), key=lambda i: errs[i][1])]}")
            if dtype == torch.float64:
                r["max_abs_err"] = abs_err
                if name == "node_linearization":
                    k1_f64 = want
                say(f"{controller} parity f64 {name}: max abs {abs_err:.3e}, "
                    f"max rel {rel_err:.3e}{worst} (gate {PARITY_RTOL:g})")
                check(rel_err <= PARITY_RTOL,
                      f"{controller} {name}: kernel differs from its plain "
                      f"version ({rel_err:.3e} > {PARITY_RTOL:g})")
                if name == "riccati_backward":
                    cases = riccati_cases(ins, n_ragged=BATCH - 3, every=64)
                    for case, (a, rel, n_ok, n) in cases.items():
                        say(f"{controller} parity f64 {name} {case}: {n_ok} of {n} "
                            f"scenarios ok in both, max abs {a:.3e}, max rel "
                            f"{rel:.3e} (gate {PARITY_RTOL:g})")
                        check(rel <= PARITY_RTOL, f"{name} {case}: kernel "
                              f"differs from its plain version ({rel:.3e})")
            else:
                say(f"{controller} parity f32 {name}: max abs {abs_err:.3e}, "
                    f"max rel {rel_err:.3e}{worst}")
                if name == "node_linearization":
                    # both f32 versions against the f64 plain version: how
                    # much of their difference is f32 round-off in each
                    acc = [max(_err(w, g.double())[1] for w, g in zip(k1_f64, o))
                           for o in (got, want)]
                    say(f"{controller} f32 {name} against the f64 plain "
                        f"version: kernel max rel {acc[0]:.3e}, plain "
                        f"{acc[1]:.3e}")
                r["ms"] = _time_ms(kern)
                r["plain_ms"] = _time_ms(plain, reps=plain_reps)
                say(f"{controller} time f32 B={BATCH} {name}: kernel "
                    f"{r['ms']:.3f} ms, "
                    f"plain {r['plain_ms']:.3f} ms (medians of {TIMING_REPS} "
                    f"and {plain_reps}), bound {r['bound_ms']:.4f} ms by "
                    f"{r['bound_by']}")
            if name == "riccati_backward":
                esc = riccati_escalation_cases(ins)
                prec = "f64" if dtype == torch.float64 else "f32"
                say(f"{controller} parity {prec} {name} escalation: passes "
                    f"{sorted(set(esc['passes']))}, {esc['bitwise']} "
                    f"scenarios without a retry equal the one-pass kernel "
                    f"bit for bit, max abs {esc['max_abs']:.3e}, max rel "
                    f"{esc['max_rel']:.3e}")
                if dtype == torch.float64:
                    check(esc["max_rel"] <= PARITY_RTOL, f"{name} escalation:"
                          " kernel differs from its plain version "
                          f"({esc['max_rel']:.3e})")
    return results


# ---------------------------------------------------------------------------
# phase 5: float64 slice through the kernels vs the JAX fixture
# ---------------------------------------------------------------------------

def phase_reference(device, controller="carrot"):
    import torch

    from eagle_mpc_tpu_torch.ocp import problem as P
    from eagle_mpc_tpu_torch.solvers import sbfddp

    fx = np.load(os.path.join(ROOT, "tests", "fixtures", FIXTURES[controller]))
    dtype = torch.float64
    ctrl, sim, _, _, _ = flagship(device, dtype, controller)
    t = lambda a: torch.as_tensor(fx[a], device=device, dtype=dtype)
    x0 = t("x0")
    B = x0.shape[0]

    def compare(prefix, res, extra=()):
        for n in ("feasible", "iters", "failed"):
            got = getattr(res, n).cpu().numpy()
            check(np.array_equal(got.astype(fx[f"{prefix}_{n}"].dtype),
                                 fx[f"{prefix}_{n}"]),
                  f"{controller} {prefix} {n}: {got} vs JAX "
                  f"{fx[prefix + '_' + n]}")
        np.testing.assert_allclose(res.cost.cpu().numpy(), fx[f"{prefix}_cost"],
                                   rtol=1e-8)
        for n, a in (("xs", res.xs), ("us", res.us)) + tuple(extra):
            np.testing.assert_allclose(a.cpu().numpy(), fx[f"{prefix}_{n}"],
                                       rtol=1e-6, atol=1e-8)

    base = P.expand_params(ctrl.params0, B)._replace(x0=x0)
    res = sbfddp.solve_fixed(ctrl.spec, ctrl.update_problem(t("warm_t"), base),
                             t("warm_xs_in"), t("warm_us_in"), depth=4,
                             polish="fixed")
    compare("warm", res)
    res = sbfddp.solve_fixed(ctrl.spec, ctrl.update_problem(t("tick_t"), base),
                             t("tick_xs_in"), t("tick_us_in"), depth=2,
                             settings=ctrl.solver_settings(), n_alphas=10,
                             polish="while_fixed", polish_maxiter=1)
    x_next = sim.step(x0, res.us_squash[:, 0])
    compare("tick", res, (("x_next", x_next),))
    say(f"{controller} reference f64 B={B}: warm start and tick match the "
        f"JAX fixture (feasible {fx['tick_feasible'].tolist()}, iters "
        f"{fx['tick_iters'].tolist()})")


# ---------------------------------------------------------------------------
# phase 6: the offline path (trajectory generation, box solvers)
# ---------------------------------------------------------------------------

def offline_problem(device, dtype, robot=ROBOT, mission=MISSION, dt_ms=DT_REF,
                    use_squash=True, integrator="IntegratedActionModelEuler"):
    """(spec, params batched at B = 1) of a mission, as the entry point
    ``eagle_mpc_tpu_torch.trajectory`` builds them (the integrator as
    ``from_trajectory`` names it)."""
    from eagle_mpc_tpu_torch.config import load_trajectory
    from eagle_mpc_tpu_torch.ocp import problem as P

    traj = load_trajectory(f"{robot}/trajectories/{mission}.yaml",
                           yaml_dir=os.path.join(ROOT, "missions"))
    spec, params = P.from_trajectory(
        traj, dt_ms=dt_ms, use_squash=use_squash, integrator=integrator,
        dtype=dtype, device=device)
    return spec, P.expand_params(params, 1)


def _solve_timed(fn):
    """(result, seconds) of fn() with the device synchronized."""
    import torch

    torch.cuda.synchronize()
    t0 = time.time()
    res = fn()
    torch.cuda.synchronize()
    return res, time.time() - t0


def phase_offline(device):
    """The offline path (module docstring, phase 6). Returns (launches per
    kernel, {kernel: numbers at the converged flagship state}, {kernel:
    parity at the box spec})."""
    import torch

    from eagle_mpc_tpu_torch.ocp import problem as P
    from eagle_mpc_tpu_torch.ops import node_cuda, riccati_cuda, rollout_cuda
    from eagle_mpc_tpu_torch.parallel import perturbed_x0_batch
    from eagle_mpc_tpu_torch.solvers import fddp, sbfddp

    mods = {"node_linearization": node_cuda, "riccati_backward": riccati_cuda,
            "alpha_rollout": rollout_cuda}
    f64, f32 = torch.float64, torch.float32
    for m in mods.values():
        m.LAUNCHES = 0
    rollout_cuda.BOX_LAUNCHES = 0

    # 1. the flagship in f64 against the JAX package's offline solve
    spec, params = offline_problem(device, f64)
    check(spec.T == 132 and len(spec.slots) == 10,
          f"flagship offline spec: T {spec.T}, {len(spec.slots)} slots")
    res, sec = _solve_timed(lambda: sbfddp.solve(spec, params,
                                                 maxiter=OFFLINE_MAXITER))
    ref = np.load(os.path.join(ROOT, "missions", "refs",
                               f"{ROBOT}__{MISSION}__dt{DT_REF}.npz"))
    dx = float(np.abs(res.xs[0].cpu().numpy() - ref["xs"]).max())
    du = float(np.abs(res.us_squash[0].cpu().numpy() - ref["us_squash"]).max())
    cost = float(res.cost[0])
    say(f"offline flagship f64 B=1 T={spec.T}: {sec:.3f} s, iters "
        f"{int(res.iters[0])} (JAX {int(ref['iters'])}), cost {cost!r} (JAX "
        f"{float(ref['cost'])!r}), feasible {bool(res.feasible[0])}, max "
        f"|xs - JAX| {dx:.3e}, max |us_squash - JAX| {du:.3e}")
    check(bool(res.feasible[0]) and not bool(res.failed[0]),
          "offline flagship f64: not feasible")
    check(int(res.iters[0]) == int(ref["iters"]),
          "offline flagship f64: iterations differ from the JAX solve")
    check(abs(cost - float(ref["cost"])) <= 1e-8 * abs(float(ref["cost"])),
          "offline flagship f64: cost differs from the JAX solve (rtol 1e-8)")
    check(dx <= OFFLINE_ATOL and du <= OFFLINE_ATOL,
          f"offline flagship f64: xs / us_squash differ from the JAX solve "
          f"by more than {OFFLINE_ATOL:g}")
    converged = (res.xs, res.us)

    # 2. the flagship in f32 at B = 1, the examples' default
    spec32, params32 = offline_problem(device, f32)
    sbfddp.solve(spec32, params32, maxiter=OFFLINE_MAXITER)
    res1, sec = _solve_timed(lambda: sbfddp.solve(spec32, params32,
                                                  maxiter=OFFLINE_MAXITER))
    it = int(res1.iters[0])
    say(f"offline flagship f32 B=1: steady solve {sec * 1e3:.1f} ms, iters "
        f"{it}, {sec * 1e3 / max(it, 1):.2f} ms per iteration, cost "
        f"{float(res1.cost[0])!r}, feasible {bool(res1.feasible[0])}")
    check(bool(res1.feasible[0]) and bool(torch.isfinite(res1.xs).all()),
          "offline flagship f32 B=1: not feasible")
    fxc = np.load(os.path.join(ROOT, "tests", "fixtures", CL_FIXTURE))
    say(f"offline flagship f32 B=1 beside the JAX package's f32 solve on a "
        f"CPU: iters {it} (JAX {int(fxc['off32_iters'])}), cost "
        f"{float(res1.cost[0])!r} (JAX {float(fxc['off32_cost'])!r}), "
        f"feasible {bool(res1.feasible[0])} (JAX "
        f"{bool(fxc['off32_feasible'])}); f64: iters {int(ref['iters'])}, "
        f"cost {float(ref['cost'])!r}")

    # 3. the flagship in f32 at B = 64, x0 perturbed
    pb = perturbed_x0_batch(params32, OFFLINE_BATCH, 0.05, 0)
    resb, sec = _solve_timed(lambda: sbfddp.solve(spec32, pb,
                                                  maxiter=OFFLINE_MAXITER))
    end = resb.xs[:, -1, :3].double().cpu().numpy()
    end1 = res1.xs[0, -1, :3].double().cpu().numpy()
    say(f"offline flagship f32 B={OFFLINE_BATCH}: {sec * 1e3:.1f} ms, iters "
        f"{resb.iters.min().item()}-{resb.iters.max().item()}, feasible "
        f"{int(resb.feasible.sum())} of {OFFLINE_BATCH}; final base position "
        f"of the unperturbed solve {end1.round(6).tolist()}, each element's "
        f"distance from it (m): {np.linalg.norm(end - end1, axis=1).round(6).tolist()}")
    check(bool(resb.feasible.all()) and bool(torch.isfinite(resb.xs).all())
          and bool(torch.isfinite(resb.cost).all()),
          f"offline flagship f32 B={OFFLINE_BATCH}: not every element "
          "feasible and finite")

    # 4. the box solvers: iris hover, raw controls, f64
    bspec, bparams = offline_problem(device, f64, "iris", "hover", 40, False)
    settings = fddp.SolverSettings()
    xs0, us0 = fddp.default_init(bspec, bparams)
    rw = fddp.solve_box_fddp(bspec, settings, bparams, xs0, us0, 60, 1e-9)
    rf = fddp.solve_fixed(bspec, settings, bparams, xs0, us0,
                          int(rw.iters[0]) + 6, 1e-9, box=True)
    fx = np.load(os.path.join(ROOT, "tests", "fixtures",
                              "torch_port_offline.npz"))
    lb, ub = bparams.glob.s_lb[0], bparams.glob.s_ub[0]
    d_fixed = float((rf.us - rw.us).abs().max())
    d_jax = float(np.abs(rw.us[0].cpu().numpy() - fx["boxfddp_us"]).max())
    say(f"offline box f64 iris T={bspec.T}: Box-FDDP iters {int(rw.iters[0])} "
        f"(JAX {int(fx['boxfddp_iters'])}), fixed box iters "
        f"{int(rf.iters[0])}, max |us fixed - while| {d_fixed:.3e}, max |us "
        f"- JAX| {d_jax:.3e}, cost {float(rw.cost[0])!r} (JAX "
        f"{float(fx['boxfddp_cost'])!r})")
    check(int(rf.iters[0]) == int(rw.iters[0]) == int(fx["boxfddp_iters"]),
          "offline box: iterations differ")
    check(d_fixed <= 1e-8 and d_jax <= 1e-8, "offline box: controls differ")
    check(bool(((rw.us >= lb - 1e-9) & (rw.us <= ub + 1e-9)).all()),
          "offline box: controls outside their bounds")
    check(abs(float(rw.cost[0]) - float(fx["boxfddp_cost"]))
          <= 1e-8 * abs(float(fx["boxfddp_cost"])), "offline box: cost differs")
    box_state = (rw.xs, rw.us)
    torch.cuda.synchronize()
    launches = {n: m.LAUNCHES for n, m in mods.items()}
    box_launches = rollout_cuda.BOX_LAUNCHES
    say(f"offline launches during the path: {json.dumps(launches)}, of K2 "
        f"with the box clip: {box_launches}")
    for n in mods:
        check(launches[n] > 0, f"offline: {n}: no kernel launch")
    check(box_launches > 0, "offline: K2's box branch never launched")

    # 5. parity at the converged flagship state and at the box spec
    stats = _offline_parity(spec, params, converged, "flagship", box=False)
    box_stats = _offline_parity(bspec, bparams, box_state, "iris box",
                                box=True, kernels=("node_linearization",
                                                   "alpha_rollout"))
    # the zero-slot launch of K1 and K2: the box spec with its slots removed
    sl_stats = _offline_parity(*without_slots(bspec, bparams), box_state,
                               "iris slot-less", box=True,
                               kernels=("node_linearization", "alpha_rollout"))
    for name, r in sl_stats.items():
        box_stats[name]["slotless_max_abs_err"] = r["max_abs_err"]
    _offline_times(spec32, params32, converged, stats)
    return launches, stats, box_stats


def without_slots(spec, params):
    """(spec, params) with every cost slot removed: the dynamics alone."""
    import dataclasses

    node, glob = params.node, params.glob
    return dataclasses.replace(spec, slots=()), params._replace(
        node=node._replace(weight=node.weight[..., :0],
                           active=node.active[..., :0], refs=()),
        glob=glob._replace(act_w=(), lb=(), ub=()))


def _kernel_parity(spec, params, xs, us, feasible, label, box=False,
                   kernels=None, witnesses=False):
    """Each kernel (or those named) against its plain version in f64 at
    (xs, us), K2's diverged lanes filtered as phase 4 does: {kernel: max
    abs error}. With ``witnesses`` (phase 12) K2 is compared on the lanes
    within CONTACT_RUNAWAY (kernel and plain version must agree on which
    lanes pass it and the solver's 1e8; at least half the lanes), and on
    the lanes between the two bounds through :func:`_runaway_witness`
    with RUNAWAY_FACTOR; and K3 is also held to its recursion in extended
    precision
    (:func:`_riccati_extended`): where the plain version lies within
    PARITY_RTOL of it the kernel is gated at PARITY_RTOL from the plain
    version, elsewhere (an ill-conditioned Quu) at RICCATI_EXT_FACTOR
    times the plain version's own distance from it."""
    import torch

    calls = kernel_calls(SimpleNamespace(spec=spec), params, xs, us, feasible,
                         reg=1e-2, box=box)
    bound = CONTACT_RUNAWAY if witnesses else 1e8
    out = {}
    for name in kernels or calls:
        kern, plain = calls[name][:2]
        got, want = kern(), plain()
        note = ""
        if name == "alpha_rollout":
            for b in {1e8, bound}:
                check(torch.equal(_healthy_lanes(want, b),
                                  _healthy_lanes(got, b)),
                      f"{label} alpha_rollout: kernel and plain version "
                      f"disagree on which lanes pass {b:g}")
            lanes = _healthy_lanes(want, bound)
            note = (f", {int(lanes.sum())} of {lanes.numel()} lanes within "
                    f"{bound:g} ({lanes.sum(1).tolist()} per element)")
            if witnesses:
                check(2 * int(lanes.sum()) >= lanes.numel(),
                      f"{label} alpha_rollout: {int(lanes.sum())} lanes "
                      f"within {bound:g}, fewer than half")
                _runaway_witness(spec, params, calls[name][2], got, want,
                                 _healthy_lanes(want) & ~lanes, label,
                                 factor=RUNAWAY_FACTOR)
            got, want = [g[lanes] for g in got], [w[lanes] for w in want]
        errs = [_err(w, g) for w, g in zip(want, got)]
        abs_err, rel_err = max(e[0] for e in errs), max(e[1] for e in errs)
        gate, dist = PARITY_RTOL, rel_err
        if witnesses and name == "riccati_backward":
            ref = _riccati_extended(calls[name][2])
            to_ref = lambda outs: max(_err(r, o.cpu())[1]
                                      for r, o in zip(ref, outs))
            plain_ext, kern_ext = to_ref(want), to_ref(got)
            note = (f"; against its recursion in extended precision: plain "
                    f"{plain_ext:.3e}, kernel {kern_ext:.3e}")
            if plain_ext > PARITY_RTOL:
                gate, dist = RICCATI_EXT_FACTOR * plain_ext, kern_ext
                wrong = {f: to_ref(_riccati_extended(calls[name][2], f))
                         for f in RICCATI_FAULTS}
                note += (", a wrong K3 " + ", ".join(
                    f"{f} {e:.3e}" for f, e in wrong.items())
                    + " (the kernel's distance gated)")
                check(min(wrong.values()) > gate, f"{label} {name}: the "
                      "gate does not tell a wrong K3 at this state")
        say(f"{label} parity f64 {name} (B={xs.shape[0]}, T={spec.T}): max abs "
            f"{abs_err:.3e}, max rel {rel_err:.3e}{note} (gate {gate:.3g})")
        check(dist <= gate, f"{label} {name}: kernel differs from its "
              f"plain version ({dist:.3e} > {gate:.3g})")
        out[name] = abs_err
    return out


def _riccati_extended(bargs, fault=None):
    """K3's recursion (``riccati_cuda.backward_plain``: the Q terms, the PD
    floor, the Cholesky gains, the value update) on the host in numpy's
    extended precision from the same f64 inputs: (k, K, Qu, Quuk, Vx, Vxx)
    as float64 tensors. ``fault`` makes it a wrong K3 (RICCATI_FAULTS):
    "floor" without the PD floor, "xreg" without xreg on Vxx, "gap" with
    the next node's gap in Vx."""
    import torch

    ld = np.longdouble
    check(np.finfo(ld).eps < 1e-18, "numpy's longdouble on this host is no "
          "wider than float64")
    a = [t.detach().cpu().numpy() for t in bargs]
    Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs, Vx, Vxx, xreg, ureg = (
        t.astype(ld) for t in a[:12])
    feasible = a[12].astype(bool)
    T, ndx, nu = Lx.shape[1], Lx.shape[2], Lu.shape[2]
    rel_eps = (fault != "floor") * 100.0 * np.finfo(np.float64).eps
    mT = lambda m: np.swapaxes(m, -1, -2)
    mv = lambda m, v: np.einsum("bij,bj->bi", m, v)
    outs = []
    for t in reversed(range(T)):
        fx, fu = Fx[:, t], Fu[:, t]
        Qx, Qu = Lx[:, t] + mv(mT(fx), Vx), Lu[:, t] + mv(mT(fu), Vx)
        Qxx = Lxx[:, t] + mT(fx) @ Vxx @ fx
        Qxu = Lxu[:, t] + mT(fx) @ Vxx @ fu
        Quu = Luu[:, t] + mT(fu) @ Vxx @ fu
        floor = rel_eps * np.abs(np.diagonal(Quu, axis1=-2, axis2=-1)).max(-1)
        Quu = Quu + (ureg + floor)[:, None, None] * np.eye(nu, dtype=ld)
        gains = _cholesky_solve(Quu, np.concatenate([Qu[..., None], mT(Qxu)],
                                                    axis=-1))
        k, K = gains[..., 0], gains[..., 1:]
        Quuk = mv(Quu, k)
        Vx = Qx + mv(mT(K), Quuk) - 2.0 * mv(mT(K), Qu)
        Vxx = Qxx - Qxu @ K
        Vxx = 0.5 * (Vxx + mT(Vxx)) + (fault != "xreg") * xreg[
            :, None, None] * np.eye(ndx, dtype=ld)
        gap = fs[:, min(t + 1, T - 1) if fault == "gap" else t]
        Vx = Vx + np.where(feasible[:, None], 0.0, mv(Vxx, gap))
        outs.append((k, K, Qu, Quuk, Vx, Vxx))
    return tuple(torch.from_numpy(np.stack(o[::-1], axis=1).astype(np.float64))
                 for o in zip(*outs))


def _cholesky_solve(A, rhs):
    """A^-1 rhs for batched symmetric positive definite A (B, n, n) and rhs
    (B, n, m) by a Cholesky factor, in the arrays' own precision (numpy's
    linear algebra has no longdouble)."""
    n = A.shape[-1]
    L = np.zeros_like(A)
    for j in range(n):
        L[:, j, j] = np.sqrt(A[:, j, j] - (L[:, j, :j] ** 2).sum(-1))
        for i in range(j + 1, n):
            L[:, i, j] = (A[:, i, j] - (L[:, i, :j] * L[:, j, :j]).sum(-1)
                          ) / L[:, j, j]
    y, x = np.zeros_like(rhs), np.zeros_like(rhs)
    for i in range(n):
        y[:, i] = (rhs[:, i] - np.einsum("bj,bjm->bm", L[:, i, :i], y[:, :i])
                   ) / L[:, i, i, None]
    for i in reversed(range(n)):
        x[:, i] = (y[:, i] - np.einsum("bj,bjm->bm", L[:, i + 1:, i],
                                       x[:, i + 1:])) / L[:, i, i, None]
    return x


def _offline_parity(spec, params, state, label, box, kernels=None):
    """:func:`_kernel_parity` at a solved state tiled to B = 2 (element 0
    feasible, element 1 not, so both gap branches run)."""
    import torch

    from eagle_mpc_tpu_torch.ocp import problem as P

    xs, us = (torch.cat([a, a]) for a in state)
    pb = P.map_params(lambda a: torch.cat([a, a]), params)
    feasible = torch.tensor([True, False], device=xs.device)
    errs = _kernel_parity(spec, pb, xs, us, feasible, label, box, kernels)
    return {name: {"max_abs_err": e} for name, e in errs.items()}


def _offline_times(spec, params, state, stats):
    """Kernel and plain times in f32 at B = 1 at the converged flagship
    state (feasible), with each kernel's bound."""
    import torch

    xs, us = (a.to(torch.float32) for a in state)
    feasible = torch.tensor([True], device=xs.device)
    calls = kernel_calls(SimpleNamespace(spec=spec), params, xs, us, feasible,
                         reg=1e-2)
    for name, (kern, plain, ins, flops) in calls.items():
        r = stats[name]
        r["bound_ms"], r["bound_by"] = bound_ms(ins, kern(), flops)
        r["ms"] = _time_ms(kern)
        r["plain_ms"] = _time_ms(plain, reps=OFFLINE_PLAIN_REPS)
        say(f"offline time f32 B=1 T={spec.T} {name}: kernel {r['ms']:.3f} ms, "
            f"plain {r['plain_ms']:.3f} ms (medians of {TIMING_REPS} and "
            f"{OFFLINE_PLAIN_REPS}), bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}")


# ---------------------------------------------------------------------------
# phase 7: the closed loop (run_closed_loop, MpcAbstract.solve's two routes)
# ---------------------------------------------------------------------------

def _recording(ctrl):
    """Wrap the controller's solve so that each tick's feasibility is kept
    (run_closed_loop returns iterations and costs only); returns the list."""
    feasible, solve = [], ctrl.solve

    def recorded(*args, **kw):
        res = solve(*args, **kw)
        feasible.append(res.feasible)
        return res
    ctrl.solve = recorded
    return feasible


def closed_loop_setup(device, dtype):
    """The flagship closed loop of phase 7: (controller, plant, offline
    reference, hover thrust, rotors, x0 (1, nx) the reference's first
    state, the warm start: its first T+1 states (1, T+1, nx) and T controls
    (1, T, nu))."""
    import torch

    with np.load(os.path.join(ROOT, "missions", "refs",
                              f"{ROBOT}__{MISSION}__dt{DT_REF}.npz")) as z:
        ref_us = z["us"]
    ctrl, sim, ref, hover, n_rot = flagship(device, dtype)
    T = ctrl.spec.T
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return (ctrl, sim, ref, hover, n_rot, t(ref[:1]), t(ref[None, :T + 1]),
            t(ref_us[None, :T]))


def phase_closed_loop(device):
    """The closed loop (module docstring, phase 7). Returns (launches per
    kernel in steps 1 to 3, {kernel: f64 parity at step 1's end state})."""
    import torch

    from eagle_mpc_tpu_torch.mpc import run_closed_loop
    from eagle_mpc_tpu_torch.ocp import problem as P
    from eagle_mpc_tpu_torch.ops import node_cuda, riccati_cuda, rollout_cuda

    mods = {"node_linearization": node_cuda, "riccati_backward": riccati_cuda,
            "alpha_rollout": rollout_cuda}
    fx = np.load(os.path.join(ROOT, "tests", "fixtures", CL_FIXTURE))
    setup = functools.partial(closed_loop_setup, device)

    for m in mods.values():
        m.LAUNCHES = 0

    # 1. float64, B = 1, the while-loop route, against the JAX fixture
    ctrl, sim, ref, _, _, x0, xs_w, us_w = setup(torch.float64)
    t0 = time.time()
    out = run_closed_loop(ctrl, sim, x0, xs_w, us_w, n_steps=CL_TICKS_F64,
                          dt_sim_ms=DT_SIM)
    sec = time.time() - t0
    got = {"states": out.states[0], "controls": out.controls[0],
           "costs": out.costs[0]}
    d = {n: float(np.abs(a.numpy() - fx[f"flag_{n}"]).max())
         for n, a in got.items()}
    spread = {n: float(np.abs(fx[f"flag_{n}"] - fx[f"flag_eps_{n}"]).max())
              for n in got}
    say(f"closed loop f64 B=1 fixed=False {CL_TICKS_F64} ticks: {sec:.3f} s, "
        f"iters {out.solve_iters[0].tolist()} (JAX "
        f"{fx['flag_solve_iters'].tolist()}), max |diff| from JAX "
        f"{json.dumps(d)}; JAX's own spread from x0 + 1e-12: "
        f"{json.dumps(spread)}")
    check(np.array_equal(out.solve_iters[0].numpy(), fx["flag_solve_iters"]),
          "closed loop f64: iterations differ from the JAX fixture")
    for n in ("states", "controls"):
        np.testing.assert_allclose(got[n].numpy(), fx[f"flag_{n}"], rtol=1e-6,
                                   atol=1e-8, err_msg=f"closed loop f64 {n}")
    np.testing.assert_allclose(got["costs"].numpy(), fx["flag_costs"],
                               rtol=1e-8, err_msg="closed loop f64 costs")
    end = (CL_TICKS_F64 * DT_SIM, out.states[:, -1], out.xs, out.us)

    # 2. float32, B = 1, the while-loop route, tracking the reference
    ctrl, sim, ref, hover, n_rot, x0, xs_w, us_w = setup(torch.float32)
    feas = _recording(ctrl)
    torch.cuda.synchronize()
    t0 = time.time()
    out = run_closed_loop(ctrl, sim, x0, xs_w, us_w, n_steps=CL_TICKS_F32,
                          dt_sim_ms=DT_SIM)
    sec = time.time() - t0
    pos = out.states[0, 1:, :3].double().numpy()
    err = np.linalg.norm(pos - np.stack([_ref_pos(ref, (i + 1) * DT_SIM)
                                         for i in range(CL_TICKS_F32)]), axis=1)
    costs = out.costs[0].numpy()
    health = {"last_feasible": bool(feas[-1][0]),
              "track_err_mean_m": float(err.mean()),
              "track_err_max_m": float(err.max()),
              "iters_total": int(out.solve_iters.sum())}
    say(f"closed loop f32 B=1 fixed=False {CL_TICKS_F32} ticks: {sec:.3f} s, "
        f"{sec / CL_TICKS_F32 * 1e3:.3f} ms per tick; {json.dumps(health)}")
    check(np.all(np.isfinite(costs)), "closed loop f32: non-finite tick costs")
    check(health["last_feasible"], "closed loop f32: last tick infeasible")
    check(health["track_err_mean_m"] < 0.16 and health["track_err_max_m"] < 0.35,
          f"closed loop f32: tracking error {health}")

    # 3. float32, B = 512, the fixed route (polish "while"), perturbed starts
    x0b, xsb, usb = initial_batch(ctrl, ref, hover, n_rot, CL_BATCH, 0.0,
                                  device, torch.float32)
    feas.clear()
    torch.cuda.synchronize()
    t0 = time.time()
    out = run_closed_loop(ctrl, sim, x0b, xsb, usb, n_steps=CL_TICKS_BATCH,
                          dt_sim_ms=DT_SIM, fixed=True)
    sec = time.time() - t0
    frac = float(feas[-1].float().mean())
    say(f"closed loop f32 B={CL_BATCH} fixed=True {CL_TICKS_BATCH} ticks: "
        f"{sec:.3f} s, {CL_BATCH * CL_TICKS_BATCH / sec:.1f} solves/s, "
        f"{sec / CL_TICKS_BATCH * 1e3:.3f} ms per tick, last tick feasible "
        f"{frac:.4f}, iters per tick {out.solve_iters.float().mean(0).tolist()}")
    check(bool(torch.isfinite(out.costs).all()),
          "closed loop fixed: non-finite tick costs")
    check(frac >= 0.99, f"closed loop fixed: feasible fraction {frac}")
    torch.cuda.synchronize()
    launches = {n: m.LAUNCHES for n, m in mods.items()}
    say(f"closed_loop launches during steps 1 to 3: {json.dumps(launches)}")
    for n in mods:
        check(launches[n] > 0, f"closed_loop: {n}: no kernel launch")

    # 4. f64 parity at step 1's end state (B = 1 tiled to 2: element 0
    # feasible, element 1 not)
    ctrl = flagship(device, torch.float64)[0]
    t_ms, xb, xs, us = end
    params = ctrl.update_problem(
        torch.full((1,), t_ms, device=device, dtype=torch.float64),
        P.expand_params(ctrl.params0, 1)._replace(x0=xb.to(device)))
    stats = _offline_parity(ctrl.spec, params, (xs, us), "closed_loop",
                            box=False)
    return launches, stats


# ---------------------------------------------------------------------------
# phase 8: the contact missions (masked KKT dynamics, friction cone)
# ---------------------------------------------------------------------------

def contact_problem(device, dtype, mission, dt_ms, six=False, mu=None,
                    integrator="IntegratedActionModelEuler"):
    """(spec, params batched at B = 1) of a contact mission, as the entry
    point builds them (optionally with its contacts made 6-D, or every
    friction cone's coefficient set to ``mu``; the integrator as
    ``from_trajectory`` names it)."""
    import dataclasses

    from eagle_mpc_tpu_torch.config import load_trajectory
    from eagle_mpc_tpu_torch.ocp import problem as P

    traj = load_trajectory(f"{ROBOT}/trajectories/{mission}.yaml",
                           yaml_dir=os.path.join(ROOT, "missions"))
    if six:
        traj = P.contact_6d(traj)
    if mu is not None:
        traj = dataclasses.replace(traj, stages=tuple(
            dataclasses.replace(st, costs=tuple(
                dataclasses.replace(c, mu=mu) if c.n_surf is not None else c
                for c in st.costs))
            for st in traj.stages))
    spec, params = P.from_trajectory(
        traj, dt_ms=dt_ms, use_squash=True, integrator=integrator,
        dtype=dtype, device=device)
    return spec, P.expand_params(params, 1)


def _contact_invariants(key, spec, params, res):
    """tests/test_contacts.py's checks on a float64 solve (phase 8 step 1),
    evaluated on host copies by the plain version."""
    import torch

    from eagle_mpc_tpu_torch.dynamics import rbd
    from eagle_mpc_tpu_torch.ocp import problem as P
    from eagle_mpc_tpu_torch.solvers import sbfddp

    host = lambda a: a.detach().cpu()
    solved = sbfddp._set_homotopy(spec, P.map_params(host, params),
                                  float(res.smooth[0]))
    xs, us = host(res.xs), host(res.us)
    nq, fid = spec.model.nq, spec.contacts[0].frame_id
    if key == "mb":
        hold = P.contact_violation(spec, solved, xs, us)[0]
        p0 = rbd.frame_placement(spec.model, xs[0, 0, :nq], fid)[0]
        for t, tol in ((1, 1e-2), (15, 6e-2), (29, 9e-2)):
            p = rbd.frame_placement(spec.model, xs[0, t, :nq], fid)[0]
            dp = float((p - p0).abs().max())
            say(f"contacts monkey_bar node {t}: |J a + a0| "
                f"{float(hold[t]):.3e}, gripper {dp:.3e} m from its start "
                f"(tolerance {tol:g})")
            check(float(hold[t]) <= 1e-6 and dp <= tol,
                  f"contacts monkey_bar: the contact does not hold at node {t}")
        perch = float((xs[0, -1, :3] - torch.tensor(
            [1.0, 0.0, 0.5], dtype=xs.dtype)).abs().max())
        say(f"contacts monkey_bar: perch {perch:.3e} m from [1, 0, 0.5]")
        check(perch <= 0.1, "contacts monkey_bar: the perch misses its target")
    else:
        ca = solved.node.contact_active[0, :, 0].numpy()
        nodes = np.where(ca == 1.0)[0]
        t = int(nodes[len(nodes) // 2])
        view = P.node_views(solved.node, (0, t))
        glob = P.map_params(lambda a: a[0], solved.glob)
        _, _, forces = P._dam(spec, view, glob, xs[0, t], us[0, t])
        R = rbd.frame_placement(spec.model, xs[0, t, :nq], fid)[1]
        fz = float((R @ forces[0][:3])[2])
        say(f"contacts eagle_catch node {t}: world normal force {fz:.6g}")
        check(fz >= -1e-6, "contacts eagle_catch: negative normal force")


def _contact_parity(spec, params, state, label, cone=False,
                    noise=CONTACT_NOISE):
    """K1 and K2 against their plain versions in f64 at a solved state
    (``params`` at the solve's last homotopy stage) tiled to B =
    CONTACT_PARITY_B: element 0 the solution, feasible; element 1 the
    solution, infeasible (the gap branch); the others the solution plus
    seeded noise (``noise``: sd on the states, quaternions renormalized,
    and on the controls), infeasible. K3, which the contacts
    do not reach, is printed beside them: at these states cond(Quu) puts
    two correct Cholesky implementations about 1e-9 apart (ROADMAP Queue
    3), and phases 4, 6 and 7 gate it. K2 is compared on the lanes whose
    states and costs stay within CONTACT_RUNAWAY; kernel and plain version
    must agree on which lanes pass it and the solver's 1e8. The compared
    lanes must include perturbed elements and run through contact-active
    and inactive nodes, and with ``cone`` through nodes where the friction
    cone's barrier is active (on an Euler spec K1's Lxu at the lanes'
    states nonzero, which the cone's rows alone make; an RK4 spec's Lxu is
    never zero, so there :func:`_cone_barrier_nodes`). The lanes between
    the two bounds go to :func:`_runaway_witness`."""
    import torch

    from eagle_mpc_tpu_torch.ocp import problem as P
    from eagle_mpc_tpu_torch.ops import node_cuda

    B = CONTACT_PARITY_B
    xs, us = (a.expand((B,) + a.shape[1:]).clone() for a in state)
    g = torch.Generator(device=xs.device).manual_seed(0)
    draw = lambda a, sd: sd * torch.randn(a[2:].shape, generator=g,
                                          device=a.device, dtype=a.dtype)
    xs[2:] += draw(xs, noise[0])
    xs[2:, :, 3:7] /= xs[2:, :, 3:7].norm(dim=-1, keepdim=True)
    us[2:] += draw(us, noise[1])
    pb = P.map_params(lambda a: a.expand((B,) + a.shape[1:]).contiguous(),
                      params)
    pb = pb._replace(x0=xs[:, 0].contiguous())
    feasible = torch.arange(B, device=xs.device) == 0
    rk4 = spec.integrator == P.RK4
    active = pb.node.contact_active[0, :spec.T]
    check(bool((active == 1).any()) and bool((active == 0).any()),
          f"{label}: no contact-active and inactive nodes")
    calls = kernel_calls(SimpleNamespace(spec=spec), pb, xs, us, feasible,
                         reg=1e-2)
    out = {}
    for name, (kern, plain, _, _) in calls.items():
        got, want = kern(), plain()
        if name == "alpha_rollout":
            for bound in (1e8, CONTACT_RUNAWAY):
                check(torch.equal(_healthy_lanes(want, bound),
                                  _healthy_lanes(got, bound)),
                      f"{label} alpha_rollout: kernel and plain version "
                      f"disagree on which lanes pass {bound:g}")
            lanes = _healthy_lanes(want, CONTACT_RUNAWAY)
            check(bool(lanes[2:].any()), f"{label} alpha_rollout: no "
                  "perturbed element's lane is compared")
            _runaway_witness(spec, pb, calls[name][2], got, want,
                             _healthy_lanes(want) & ~lanes, label)
            xl = torch.cat([want[0], want[3][:, :, None]], dim=2)[lanes]
            n = xl.shape[0]
            pl = P.map_params(lambda a: a[:1].expand((n,) + a.shape[1:])
                              .contiguous(), pb)
            pl = pl._replace(x0=xl[:, 0].contiguous())
            if rk4:
                barrier = _cone_barrier_nodes(spec, pl, xl, want[1][lanes])
            else:
                barrier = node_cuda.calc_diff_running(
                    spec, pl, xl, want[1][lanes]).Lxu.abs().amax(
                        dim=(-2, -1)) > 0
            say(f"{label} alpha_rollout: {n} of {lanes.numel()} lanes "
                f"within {CONTACT_RUNAWAY:g} compared ({lanes.sum(1).tolist()}"
                f" per element); the cone's barrier active at "
                f"{int(barrier.sum())} of their nodes, on "
                f"{int(barrier.any(1).sum())} lanes")
            check(not cone or bool(barrier.any()), f"{label} alpha_rollout:"
                  " the friction cone's barrier is active on no compared lane")
            got, want = [g[lanes] for g in got], [w[lanes] for w in want]
        errs = [_err(w, g) for w, g in zip(want, got)]
        abs_err, rel_err = max(e[0] for e in errs), max(e[1] for e in errs)
        gated = name != "riccati_backward"
        say(f"{label} parity f64 {name} (B={B}, T={spec.T}): max abs "
            f"{abs_err:.3e}, max rel {rel_err:.3e}"
            + (f" (gate {PARITY_RTOL:g})" if gated else " (not gated here)"))
        check(rel_err <= PARITY_RTOL or not gated, f"{label} {name}: kernel "
              f"differs from its plain version ({rel_err:.3e} > "
              f"{PARITY_RTOL:g})")
        if name == "node_linearization":
            nodes = int((_cone_barrier_nodes(spec, pb, xs, us) if rk4 else
                         want.Lxu.abs().amax(dim=(-2, -1)) > 0).sum())
            say(f"{label} node_linearization: the cone's barrier active at "
                f"{nodes} of {B * spec.T} nodes ("
                + ("cone rows outside their bounds at a stage point)" if rk4
                   else "Lxu nonzero)"))
            check(not cone or nodes > 0, f"{label} node_linearization: the "
                  "friction cone's barrier is active at no node")
        out[name] = {"max_abs_err": abs_err}
    return out


def _cone_barrier_nodes(spec, params, xs, us):
    """(B, T) nodes where a friction cone's barrier is active under the
    spec's integrator: the cone is weighted there and its rows at one of
    the node's stage points (each with that stage's forces, from the plain
    stage points) lie outside their bounds."""
    import torch

    from eagle_mpc_tpu_torch.ocp import costs as C
    from eagle_mpc_tpu_torch.ocp import problem as P

    B, T = us.shape[:2]
    flat = lambda a: a.reshape((B * T,) + a.shape[2:])
    view = P.map_params(flat, P.running_views(params.node, T))
    glob = P.map_params(
        lambda a: flat(a[:, None].expand((B, T) + a.shape[1:])), params.glob)
    s = flat(us)
    pts, _, _ = P._stage_points(spec, view, glob, flat(xs[:, :T]), s)
    res = [P._point_residuals(spec, view, x, s, False, f) for _, x, f in pts]
    hit = torch.zeros(B * T, dtype=torch.bool, device=us.device)
    for k, slot in enumerate(spec.slots):
        if slot.kind == C.FRICTION_CONE:
            on = view.weight[..., k] * view.active[..., k] != 0
            for r in res:
                hit |= on & ((r[k] < glob.lb[k]) | (r[k] > glob.ub[k])).any(-1)
    return hit.reshape(B, T)


def _runaway_witness(spec, params, ins, got, want, away, label,
                     factor=None):
    """On the lanes that run away (past CONTACT_RUNAWAY, within the
    solver's 1e8), print how far the plain version on the card and on the
    host CPU (float64, the same inputs) lie apart, beside the kernel's
    distance from each: round-off grows along such a lane, so two correct
    implementations part there. With ``factor`` the kernel's distance from
    the plain version on the card is gated at PARITY_RTOL or ``factor``
    times the two plain versions' distance, whichever is larger."""
    import torch

    from eagle_mpc_tpu_torch.ocp import problem as P
    from eagle_mpc_tpu_torch.ops import rollout_cuda

    if not bool(away.any()):
        return
    sel = away.any(1).nonzero().flatten()
    xs, us, k, K, fs, _, alphas, keep = (a[sel].cpu() if a.dim() > 1
                                         else a.cpu() for a in ins[:8])
    host = rollout_cuda.rollout_plain(
        spec, P.map_params(lambda a: a[sel].cpu(), params), xs, us, k, K,
        fs, alphas, keep)
    lanes = away[sel].cpu()
    pick = lambda outs: [o[sel].cpu()[lanes] for o in outs]
    h, w, g = [o[lanes] for o in host], pick(want), pick(got)
    dist = lambda a, b: max(_err(x, y)[1] for x, y in zip(a, b))
    gate = None if factor is None else max(PARITY_RTOL, factor * dist(h, w))
    say(f"{label} alpha_rollout: {int(away.sum())} lanes run past "
        f"{CONTACT_RUNAWAY:g} (largest |entry| {float(w[0].abs().max()):.3e}"
        f"); on them, plain on the card against plain on the CPU "
        f"{dist(h, w):.3e} relative, kernel against either "
        f"{dist(h, g):.3e} / {dist(w, g):.3e} "
        + ("(not gated)" if gate is None else f"(gate {gate:.3g})"))
    check(gate is None or dist(w, g) <= gate, f"{label} alpha_rollout: on the"
          " lanes that run away the kernel lies farther from its plain "
          "version than the plain versions on the card and CPU allow")


def phase_contacts(device):
    """The contact missions (module docstring, phase 8). Returns (launches
    per kernel in steps 1 and 2, {mission: {kernel: its numbers}})."""
    import torch

    from eagle_mpc_tpu_torch.ocp import problem as P
    from eagle_mpc_tpu_torch.ops import node_cuda, riccati_cuda, rollout_cuda
    from eagle_mpc_tpu_torch.parallel import perturbed_x0_batch
    from eagle_mpc_tpu_torch.solvers import sbfddp

    mods = {"node_linearization": node_cuda, "riccati_backward": riccati_cuda,
            "alpha_rollout": rollout_cuda}
    f64, f32 = torch.float64, torch.float32
    fx = np.load(os.path.join(ROOT, "tests", "fixtures", CONTACT_FIXTURE))

    # 1. float64 at B = 1 against the JAX package: K1 at JAX's nodes, then
    # (the counts set to 0) the solves
    for key, sol, six in (("mb", "mb", False), ("ec", "ec", False),
                          ("ecr", "ecr", False), ("m6", "mb", True)):
        mission, dt_ms = CONTACT_MISSIONS[{"ecr": "ec", "m6": "mb"}.get(key, key)]
        spec, params = contact_problem(device, f64, mission, dt_ms, six)
        xs, us = (torch.as_tensor(fx[f"{sol}_{n}"], device=device)[None]
                  for n in ("xs", "us"))
        got = node_cuda.calc_diff_running(spec, params, xs, us)
        nodes = fx[f"{key}_nodes"].tolist()
        errs = {n: _err(torch.as_tensor(fx[f"{key}_cd_{n}"], device=device),
                        getattr(got, n)[0, nodes])[1] for n in got._fields}
        worst = max(errs.values())
        say(f"contacts {mission}{' 6-D' if six else ''} K1 f64 at nodes "
            f"{nodes} of {'a rough candidate' if key == 'ecr' else 'its JAX solution'}"
            f" against JAX's node derivatives: max rel {worst:.3e} (gate "
            f"{PARITY_RTOL:g}); max |Lxu| {float(got.Lxu[0, nodes].abs().max()):.3e}")
        check(worst <= PARITY_RTOL, f"contacts {mission} K1 differs from "
              f"JAX's node derivatives: {errs}")
    for m in mods.values():
        m.LAUNCHES = 0
    P.PLAIN_ON_CARD = 0
    solved, feasible64, smooth = {}, {}, {}
    for key, (mission, dt_ms) in CONTACT_MISSIONS.items():
        spec, params = contact_problem(device, f64, mission, dt_ms)
        res, sec = _solve_timed(lambda: sbfddp.solve(
            spec, params, maxiter=CONTACT_MAXITER))
        diff = lambda a, ref: float(np.abs(a.cpu().numpy() - ref).max())
        say(f"contacts {mission} f64 B=1 T={spec.T}: {sec:.3f} s, iters "
            f"{int(res.iters[0])}, cost {float(res.cost[0])!r}, feasible "
            f"{bool(res.feasible[0])}, failed {bool(res.failed[0])}; JAX: "
            f"iters {int(fx[key + '_iters'])}, cost "
            f"{float(fx[key + '_cost'])!r}, max |xs - JAX| "
            f"{diff(res.xs[0], fx[key + '_xs']):.3e}; JAX from x0 + 1e-12: "
            f"iters {int(fx[key + '_eps_iters'])}, cost "
            f"{float(fx[key + '_eps_cost'])!r}, max |xs - JAX| "
            f"{np.abs(fx[key + '_eps_xs'] - fx[key + '_xs']).max():.3e}")
        for n in ("feasible", "failed"):
            check(bool(getattr(res, n)[0]) == bool(fx[f"{key}_{n}"]),
                  f"contacts {mission} f64: {n} differs from the JAX solve")
        _contact_invariants(key, spec, params, res)
        smooth[key] = float(res.smooth[0])
        solved[key] = (spec, sbfddp._set_homotopy(spec, params, smooth[key]),
                       (res.xs, res.us))
        feasible64[key] = bool(res.feasible[0])

    # 2. float32 at B = 1 and B = OFFLINE_BATCH (x0 perturbed)
    for key, (mission, dt_ms) in CONTACT_MISSIONS.items():
        spec32, p32 = contact_problem(device, f32, mission, dt_ms)
        pb = perturbed_x0_batch(p32, OFFLINE_BATCH, 0.05, 0)
        for B, params in ((1, p32), (OFFLINE_BATCH, pb)):
            res, sec = _solve_timed(lambda: sbfddp.solve(
                spec32, params, maxiter=CONTACT_MAXITER))
            it = int(res.iters.max())
            finite = all(bool(torch.isfinite(a).all())
                         for a in (res.xs, res.us, res.cost))
            n_feas = int(res.feasible.sum())
            say(f"contacts {mission} f32 B={B}: {sec * 1e3:.1f} ms, iters "
                f"{res.iters.min().item()}-{it}, {sec * 1e3 / max(it, 1):.2f} "
                f"ms per iteration, feasible {n_feas} of {B}, failed "
                f"{int(res.failed.sum())}, cost of element 0 "
                f"{float(res.cost[0])!r}")
            check(finite, f"contacts {mission} f32 B={B}: non-finite values")
            if B == 1:
                check(n_feas == int(feasible64[key]), f"contacts {mission} "
                      "f32 B=1: feasibility differs from the f64 solve")
                continue
            jax_feas = [int(fx[f"{key}_b64_feasible"].sum())] + [
                int(c) for c in fx[f"{key}_b64_spread_feasible"].sum(1)]
            idx = lambda m: np.where(np.asarray(m))[0].tolist()
            say(f"contacts {mission} f32 B={B}: infeasible starts "
                f"{idx(~res.feasible.cpu())}, failed {idx(res.failed.cpu())};"
                f" the JAX package's f32 solve of the same starts: feasible "
                f"{jax_feas[0]}, infeasible {idx(~fx[key + '_b64_feasible'])},"
                f" failed {idx(fx[key + '_b64_failed'])}; of their round-off "
                f"copies: feasible {jax_feas[1:]}")
            check(n_feas >= min(jax_feas), f"contacts {mission} f32 B={B}: "
                  f"{n_feas} feasible, JAX {jax_feas}")
    torch.cuda.synchronize()
    launches = {n: m.LAUNCHES for n, m in mods.items()}
    say(f"contacts launches during steps 1 and 2: {json.dumps(launches)}; "
        f"plain node dynamics on the card: {P.PLAIN_ON_CARD}")
    for n in mods:
        check(launches[n] > 0, f"contacts: {n}: no kernel launch")
    check(P.PLAIN_ON_CARD == 0, f"contacts: the solves ran the plain node "
          f"dynamics on the card {P.PLAIN_ON_CARD} times")

    # 3. parity in f64: both missions, eagle_catch on a slippery surface
    # and monkey_bar with a 6-D contact
    stats = {}
    for key, (spec, params, state) in solved.items():
        stats[key] = _contact_parity(spec, params, state,
                                     f"contacts {CONTACT_MISSIONS[key][0]}")
    for key, label, kw in (
            ("ec", f"eagle_catch mu {CONTACT_TIGHT_MU:g}",
             dict(mu=CONTACT_TIGHT_MU)),
            ("mb", "monkey_bar 6-D", dict(six=True))):
        spec, params = contact_problem(device, f64, *CONTACT_MISSIONS[key],
                                       **kw)
        check(kw.get("six") is None or spec.contacts[0].dim == 6,
              "the 6-D variant has no 6-D contact")
        params = sbfddp._set_homotopy(spec, params, smooth[key])
        for name, r in _contact_parity(spec, params, solved[key][2],
                                       f"contacts {label}",
                                       cone="mu" in kw).items():
            stats[key][name]["max_abs_err_" + ("cone" if "mu" in kw
                                               else "6d")] = r["max_abs_err"]

    # 4. times in f32 at B = 1 at each mission's solution
    for key, (spec, params, state) in solved.items():
        p32 = P.map_params(lambda a: a.to(f32), params)
        xs, us = (a.to(f32) for a in state)
        calls = kernel_calls(SimpleNamespace(spec=spec), p32, xs, us,
                             torch.tensor([True], device=device), reg=1e-2)
        for name, (kern, plain, ins, flops) in calls.items():
            r = stats[key][name]
            r["bound_ms"], r["bound_by"] = bound_ms(ins, kern(), flops)
            r["ms"] = _time_ms(kern)
            r["plain_ms"] = _time_ms(plain, reps=CONTACT_PLAIN_REPS)
            say(f"contacts time f32 B=1 {CONTACT_MISSIONS[key][0]} "
                f"T={spec.T} {name}: kernel {r['ms']:.3f} ms, plain "
                f"{r['plain_ms']:.3f} ms (medians of {TIMING_REPS} and "
                f"{CONTACT_PLAIN_REPS}), bound {r['bound_ms']:.4f} ms by "
                f"{r['bound_by']}")
    return launches, stats


# ---------------------------------------------------------------------------
# phase 9: the RK4 integrator
# ---------------------------------------------------------------------------

def _rk4_offline(device, mods):
    """Step 3 of phase 9: the offline solves with RK4 nodes."""
    import torch

    from eagle_mpc_tpu_torch.ocp import problem as P
    from eagle_mpc_tpu_torch.parallel import perturbed_x0_batch
    from eagle_mpc_tpu_torch.solvers import sbfddp

    fx = np.load(os.path.join(ROOT, "tests", "fixtures", FIXTURES["rk4"]))
    spec, params = offline_problem(device, torch.float64, "iris", "hover", 60,
                                   integrator=RK4)
    check(spec.integrator == P.RK4, "iris hover: not an RK4 spec")
    res, sec = _solve_timed(lambda: sbfddp.solve(spec, params, maxiter=100))
    it, cost = int(res.iters[0]), float(res.cost[0])
    say(f"rk4 offline iris hover f64 B=1 T={spec.T}: {sec:.3f} s, iters {it} "
        f"(JAX {int(fx['off_iters'])}), cost {cost!r} (JAX "
        f"{float(fx['off_cost'])!r}), feasible {bool(res.feasible[0])}, final "
        f"position {res.xs[0, -1, :3].cpu().numpy().round(6).tolist()}")
    check(bool(res.feasible[0]) and not bool(res.failed[0]),
          "rk4 offline iris hover f64: not feasible")
    check(it == int(fx["off_iters"]), "rk4 offline iris hover f64: "
          "iterations differ from the JAX solve")
    check(abs(cost - float(fx["off_cost"])) <= 1e-8 * abs(float(fx["off_cost"])),
          "rk4 offline iris hover f64: cost differs from the JAX solve")
    spec, params = offline_problem(device, torch.float32, integrator=RK4)
    sbfddp.solve(spec, params, maxiter=OFFLINE_MAXITER)
    for B in (1, OFFLINE_BATCH):
        pb = perturbed_x0_batch(params, B, 0.05, 0) if B > 1 else params
        res, sec = _solve_timed(lambda: sbfddp.solve(spec, pb,
                                                     maxiter=OFFLINE_MAXITER))
        it = int(res.iters.max())
        say(f"rk4 offline flagship f32 B={B} T={spec.T}: {sec * 1e3:.1f} ms, "
            f"iters {int(res.iters.min())}-{it}, {sec * 1e3 / max(it, 1):.2f} "
            f"ms per iteration of the slowest element, feasible "
            f"{int(res.feasible.sum())} of {B}, cost "
            f"{float(res.cost.mean())!r} (mean)")
        check(bool(res.feasible.all()) and bool(torch.isfinite(res.xs).all())
              and bool(torch.isfinite(res.cost).all()),
              f"rk4 offline flagship f32 B={B}: not every element feasible "
              "and finite")


def _rk4_jax_parity(device):
    """Step 4 of phase 9, first part: K1 through the kernel against the JAX
    package's node derivatives (the fixture's ``cd_*``), float64."""
    import torch

    from eagle_mpc_tpu_torch.ocp import problem as P
    from eagle_mpc_tpu_torch.ops import node_cuda

    fx = np.load(os.path.join(ROOT, "tests", "fixtures", FIXTURES["rk4"]))
    dtype = torch.float64
    ctrl = flagship(device, dtype, "rk4")[0]
    t = lambda a: torch.as_tensor(fx[a], device=device, dtype=dtype)
    B = fx["cd_xs"].shape[0]
    params = ctrl.update_problem(t("cd_t"), P.expand_params(
        ctrl.params0, B)._replace(x0=t("cd_x0")))
    got = node_cuda.calc_diff_running(ctrl.spec, params, t("cd_xs"), t("cd_us"))
    torch.cuda.synchronize()
    errs = {n: _err(t(f"cd_{n}"), getattr(got, n)) for n in got._fields}
    rel = max(e[1] for e in errs.values())
    lxu = float(got.Lxu.abs().max())
    say(f"rk4 parity f64 node_linearization against the JAX package (B={B}, "
        f"T={ctrl.spec.T}): max rel {rel:.3e} (gate {PARITY_RTOL:g}), max "
        f"|Lxu| {lxu:.3e}")
    check(rel <= PARITY_RTOL, f"rk4 node_linearization differs from the JAX "
          f"package's node derivatives ({rel:.3e})")
    check(lxu > 0.0, "rk4 node_linearization: Lxu is zero")
    return max(e[0] for e in errs.values())


def _rk4_contact_jax_parity(device, fx_rk4, fx_con):
    """Step 5 of phase 9, first part: K1 through the kernel in f64 at the
    RK4 contact nodes of the JAX fixture (monkey_bar's ``mb_cd_*`` at the
    contact fixture's solution, eagle_catch's ``ecr4_*`` at its rough
    candidate, where the cone's barrier is active) against JAX's node
    derivatives and against its plain version over the whole horizon:
    {mission: max abs error against JAX}."""
    import torch

    from eagle_mpc_tpu_torch.ops import node_cuda

    out = {}
    for key, sol, mission, dt_ms in (("mb", "mb", "monkey_bar", 40),
                                     ("ecr4", "ecr", "eagle_catch", 50)):
        spec, params = contact_problem(device, torch.float64, mission, dt_ms,
                                       integrator=RK4)
        xs, us = (torch.as_tensor(fx_con[f"{sol}_{n}"], device=device)[None]
                  for n in ("xs", "us"))
        got = node_cuda.calc_diff_running(spec, params, xs, us)
        want = node_cuda.calc_diff_running_plain(spec, params, xs, us)
        torch.cuda.synchronize()
        nodes = fx_rk4[f"{key}_nodes"].tolist()
        jax = {n: _err(torch.as_tensor(fx_rk4[f"{key}_cd_{n}"], device=device),
                       getattr(got, n)[0, nodes]) for n in got._fields}
        rel_jax = max(e[1] for e in jax.values())
        rel_plain = max(_err(w, g)[1] for w, g in zip(want, got))
        say(f"rk4 contacts {mission} K1 f64 at nodes {nodes} against JAX's "
            f"node derivatives: max rel {rel_jax:.3e}; the whole horizon "
            f"(T={spec.T}) against the plain version: max rel "
            f"{rel_plain:.3e} (gate {PARITY_RTOL:g}); max |Lxu| "
            f"{float(got.Lxu[0, nodes].abs().max()):.3e}")
        check(rel_jax <= PARITY_RTOL and rel_plain <= PARITY_RTOL,
              f"rk4 contacts {mission} K1 differs from JAX's node derivatives "
              f"or its plain version: {jax}")
        out[mission] = max(e[0] for e in jax.values())
    return out


def _rk4_contact_iterations(device, fx):
    """Step 5 of phase 9: three FDDP iterations of monkey_bar with RK4 nodes
    at dt 100 ms (T = 18) in f64 through the kernels against the JAX
    package's (``mbit_*``), beside the same solve with every operand nudged
    by about one unit in the last place."""
    import torch

    from eagle_mpc_tpu_torch.ocp import problem as P
    from eagle_mpc_tpu_torch.solvers import fddp

    spec, params = contact_problem(device, torch.float64, "monkey_bar", 100,
                                   integrator=RK4)
    check(spec.T == 18, f"monkey_bar at dt 100: T {spec.T}")
    xs0, us0 = fddp.default_init(spec, params)
    # the fixture's start: every candidate state's base turned about its y
    # axis, off the rotation log's branch cut (tests/test_torch_rk4_contacts.py)
    turn = torch.zeros(spec.state.ndx, device=device, dtype=torch.float64)
    turn[4] = RK4_CONTACT_TURN
    xs0 = spec.state.integrate(xs0, turn)
    solve = lambda p, x, u: fddp.solve_fddp(
        spec, fddp.SolverSettings(record_trace=True), p, x, u, 3, 1e-9)
    r = solve(params, xs0, us0)
    tr = fddp.IterTrace(*(a[0].cpu().numpy() for a in r.trace))
    for n in ("iters", "feasible", "failed"):
        check(getattr(r, n)[0].item() == fx[f"mbit_{n}"].item(),
              f"rk4 contacts monkey_bar 3 iterations: {n} differs from JAX's")
    for n in ("accepted", "phase", "steplength"):
        check(np.array_equal(getattr(tr, n), fx[f"mbit_trace_{n}"]),
              f"rk4 contacts monkey_bar 3 iterations: trace {n} differs")
    rel = lambda a, ref: float(np.abs(a - ref).max() / np.abs(ref).max())
    dcost = rel(tr.cost, fx["mbit_trace_cost"])
    dxs = max(rel(getattr(r, n)[0].cpu().numpy(), fx[f"mbit_{n}"])
              for n in ("xs", "us"))
    # the witness: every operand nudged by about one unit in the last place
    moved = []
    for seed in range(RK4_CONTACT_NUDGES):
        g = torch.Generator(device=device).manual_seed(seed)
        nudge = lambda a: (a * (1 + 1e-16 * torch.randn(
            a.shape, generator=g, device=device, dtype=a.dtype))
            if torch.is_floating_point(a) else a)
        r2 = solve(P.map_params(nudge, params), nudge(xs0), nudge(us0))
        tr2 = fddp.IterTrace(*(a[0].cpu().numpy() for a in r2.trace))
        moved.append((rel(tr2.cost, tr.cost), max(
            rel(getattr(r2, n)[0].cpu().numpy(), getattr(r, n)[0].cpu().numpy())
            for n in ("xs", "us"))))
    say(f"rk4 contacts monkey_bar f64 T={spec.T}: 3 FDDP iterations through "
        f"the kernels, steps {tr.steplength.tolist()} as JAX's, costs within "
        f"{dcost:.3e} (gate {RK4_CONTACT_COST_RTOL:g}), states and controls "
        f"within {dxs:.3e} of the largest (gate {RK4_CONTACT_XS_RTOL:g}); "
        f"every operand nudged by about one unit in the last place "
        f"({RK4_CONTACT_NUDGES} seeds) moves the costs "
        f"{', '.join(f'{c:.3e}' for c, _ in moved)} and the states and "
        f"controls {', '.join(f'{x:.3e}' for _, x in moved)} (not gated)")
    check(dcost <= RK4_CONTACT_COST_RTOL and dxs <= RK4_CONTACT_XS_RTOL,
          "rk4 contacts monkey_bar 3 iterations: costs or states differ")


def _rk4_contact_solve(device):
    """Step 5 of phase 9: ``sbfddp.solve`` of monkey_bar with RK4 nodes at dt
    40 ms in f32 from the mission's start, the launch counts, their RK4
    counts and the count of plain node dynamics on the card set to 0 just
    before it: finite, the contact held at the hang nodes (|J a + a0| from
    host copies, in f64, within phase 8's bound), no plain node dynamics,
    every K1 and K2 launch an RK4 one. Returns the launches per kernel."""
    import torch

    from eagle_mpc_tpu_torch.ocp import problem as P
    from eagle_mpc_tpu_torch.ops import node_cuda, riccati_cuda, rollout_cuda
    from eagle_mpc_tpu_torch.solvers import sbfddp

    mods = {"node_linearization": node_cuda, "riccati_backward": riccati_cuda,
            "alpha_rollout": rollout_cuda}
    spec, params = contact_problem(device, torch.float32, "monkey_bar", 40,
                                   integrator=RK4)
    check(spec.integrator == P.RK4 and spec.T == 45 and spec.nc_rows == 3,
          f"monkey_bar RK4: T {spec.T}, {spec.nc_rows} contact rows")
    torch.cuda.synchronize()
    for m in mods.values():
        m.LAUNCHES = 0
    node_cuda.RK4_LAUNCHES = rollout_cuda.RK4_LAUNCHES = 0
    P.PLAIN_ON_CARD = 0
    res, sec = _solve_timed(lambda: sbfddp.solve(
        spec, params, maxiter=RK4_CONTACT_MAXITER))
    launches = {n: m.LAUNCHES for n, m in mods.items()}
    rk4 = {"node_linearization": node_cuda.RK4_LAUNCHES,
           "alpha_rollout": rollout_cuda.RK4_LAUNCHES}
    plain = P.PLAIN_ON_CARD
    it = int(res.iters[0])
    say(f"rk4 contacts monkey_bar f32 B=1 T={spec.T}: {sec * 1e3:.1f} ms, "
        f"iters {it}, {sec * 1e3 / max(it, 1):.2f} ms per iteration, cost "
        f"{float(res.cost[0])!r}, feasible {bool(res.feasible[0])}, failed "
        f"{bool(res.failed[0])}; launches {json.dumps(launches)}, RK4 ones "
        f"of K1 and K2 {json.dumps(rk4)}; plain node dynamics on the card "
        f"{plain}")
    check(all(bool(torch.isfinite(a).all()) for a in (res.xs, res.us,
                                                      res.cost)),
          "rk4 contacts monkey_bar f32: non-finite values")
    check(plain == 0, f"rk4 contacts: {plain} plain node dynamics on the card")
    for n in rk4:
        check(rk4[n] == launches[n] > 0, f"rk4 contacts: {n}: {rk4[n]} RK4 "
              f"launches of {launches[n]}")
    check(launches["riccati_backward"] > 0, "rk4 contacts: K3 never launched")
    host = lambda a: a.detach().cpu().double()
    solved = sbfddp._set_homotopy(spec, P.map_params(host, params),
                                  float(res.smooth[0]))
    hold = P.contact_violation(spec, solved, host(res.xs), host(res.us))[0]
    worst = max(float(hold[t]) for t in RK4_CONTACT_HANG)
    say(f"rk4 contacts monkey_bar f32: |J a + a0| at hang nodes "
        f"{list(RK4_CONTACT_HANG)} (f64, host copies) at most {worst:.3e} "
        f"(bound 1e-6)")
    check(worst <= 1e-6, "rk4 contacts monkey_bar: the contact does not hold")
    return launches


def _rk4_contacts(device):
    """Step 5 of phase 9 (module docstring): RK4 nodes on the contact
    missions through K1 and K2. Returns (launches of the f32 solve,
    {mission: {kernel: its numbers}})."""
    import torch

    from eagle_mpc_tpu_torch.ocp import problem as P
    from eagle_mpc_tpu_torch.solvers import sbfddp

    fx = np.load(os.path.join(ROOT, "tests", "fixtures", FIXTURES["rk4"]))
    fxc = np.load(os.path.join(ROOT, "tests", "fixtures", CONTACT_FIXTURE))
    f64, f32 = torch.float64, torch.float32
    jax_err = _rk4_contact_jax_parity(device, fx, fxc)
    _rk4_contact_iterations(device, fx)
    launches = _rk4_contact_solve(device)
    stats = {}
    for key, (mission, dt_ms) in CONTACT_MISSIONS.items():
        spec, params = contact_problem(device, f64, mission, dt_ms,
                                       integrator=RK4)
        smooth = float(fxc[f"{key}_smooth"])
        params = sbfddp._set_homotopy(spec, params, smooth)
        state = tuple(torch.as_tensor(fxc[f"{key}_{n}"], device=device)[None]
                      for n in ("xs", "us"))
        stats[mission] = _contact_parity(spec, params, state,
                                         f"rk4 contacts {mission}",
                                         noise=RK4_CONTACT_NOISE)
        stats[mission]["node_linearization"]["jax_max_abs_err"] = jax_err[mission]
        if key == "ec":
            # on a slippery surface, as phase 8 step 3: the cone's barrier
            # active at the compared lanes' stage points
            tight, tp = contact_problem(device, f64, mission, dt_ms,
                                        mu=CONTACT_TIGHT_MU, integrator=RK4)
            for name, r in _contact_parity(
                    tight, sbfddp._set_homotopy(tight, tp, smooth), state,
                    f"rk4 contacts {mission} mu {CONTACT_TIGHT_MU:g}",
                    cone=True, noise=RK4_CONTACT_NOISE).items():
                stats[mission][name]["max_abs_err_cone"] = r["max_abs_err"]
        # times in f32 at B = 1 at the mission's solution
        p32 = P.map_params(lambda a: a.to(f32), params)
        xs, us = (a.to(f32) for a in state)
        calls = kernel_calls(SimpleNamespace(spec=spec), p32, xs, us,
                             torch.tensor([True], device=device), reg=1e-2)
        for name, (kern, plain, ins, flops) in calls.items():
            r = stats[mission][name]
            r["bound_ms"], r["bound_by"] = bound_ms(ins, kern(), flops)
            r["ms"] = _time_ms(kern)
            # the plain version ran in the parity above: no warm-up call
            # (seconds here)
            r["plain_ms"] = _time_ms(plain, reps=RK4_CONTACT_PLAIN_REPS,
                                     warm_up=False)
            say(f"rk4 contacts time f32 B=1 {mission} T={spec.T} {name}: "
                f"kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms "
                f"(medians of {TIMING_REPS} and {RK4_CONTACT_PLAIN_REPS}), "
                f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}")
    return launches, stats


def phase_rk4(device):
    """The RK4 integrator (module docstring, phase 9). Returns (launches in
    steps 1 to 3 per kernel, launches per timed tick of step 1, {kernel:
    its numbers at step 1's end state}, step 5's launches and {mission:
    {kernel: its numbers}})."""
    import torch

    from eagle_mpc_tpu_torch.ocp import problem as P
    from eagle_mpc_tpu_torch.ops import node_cuda, riccati_cuda, rollout_cuda

    mods = {"node_linearization": node_cuda, "riccati_backward": riccati_cuda,
            "alpha_rollout": rollout_cuda}
    rk4_mods = {"node_linearization": node_cuda, "alpha_rollout": rollout_cuda}
    P.PLAIN_ON_CARD = 0
    for m in rk4_mods.values():
        m.RK4_LAUNCHES = 0
    # 1. the carrot path with RK4 nodes (it zeroes the launch counts)
    launches, per_tick, end = phase_path(device, "rk4")
    # 2. the f64 warm start and tick against the JAX package
    phase_reference(device, "rk4")
    # 3. the offline solves
    _rk4_offline(device, mods)
    torch.cuda.synchronize()
    total = {n: m.LAUNCHES for n, m in mods.items()}
    rk4 = {n: m.RK4_LAUNCHES for n, m in rk4_mods.items()}
    say(f"rk4 launches in steps 1-3: {json.dumps(total)}; RK4 launches of K1 "
        f"and K2: {json.dumps(rk4)}; plain node dynamics on the card: "
        f"{P.PLAIN_ON_CARD}")
    check(P.PLAIN_ON_CARD == 0, f"rk4: {P.PLAIN_ON_CARD} plain node dynamics "
          "ran on the card")
    for n in rk4_mods:
        check(rk4[n] == total[n] > 0, f"rk4: {n}: {rk4[n]} RK4 launches of "
              f"{total[n]}")
    # 4. parity: against JAX, then against the plain versions
    jax_err = _rk4_jax_parity(device)
    stats = phase_parity(device, end, "rk4", plain_reps=RK4_PLAIN_REPS)
    stats["node_linearization"]["jax_max_abs_err"] = jax_err
    stats["alpha_rollout"]["clip_max_abs_err"] = stats.pop(
        "alpha_rollout (clip)")["max_abs_err"]
    # 5. RK4 nodes on the contact missions
    con_launches, con_stats = _rk4_contacts(device)
    return launches, per_tick, stats, con_launches, con_stats


# ---------------------------------------------------------------------------
# phase 12: kernel parity on the other robots of missions/
# ---------------------------------------------------------------------------

def robot_inputs(spec, params, B, seed):
    """A solver state of B elements around the hover mission's start: x0
    tiled plus seeded noise (sd ROBOT_NOISE[0], quaternions renormalized),
    the controls at the middle of their bounds, the rotor thrusts plus
    noise (ROBOT_NOISE[1] of their range; a joint torque that far off
    throws a light link past any RK4 step); x0 each element's first
    state. Returns (params, xs, us)."""
    import torch

    from eagle_mpc_tpu_torch.ocp import problem as P

    rng = np.random.default_rng(seed)
    T, nx, nu = spec.T, spec.model.nx, spec.nu
    x0 = params.x0[0].cpu().numpy()
    xs = np.tile(x0, (B, T + 1, 1)) + rng.normal(size=(B, T + 1, nx)) * ROBOT_NOISE[0]
    xs[..., 3:7] /= np.linalg.norm(xs[..., 3:7], axis=-1, keepdims=True)
    lb, ub = (a[0].cpu().numpy() for a in (params.glob.s_lb, params.glob.s_ub))
    rotor = np.arange(nu) < len(spec.tau_f[0])
    us = (0.5 * (lb + ub) + rng.normal(size=(B, T, nu)) * ROBOT_NOISE[1]
          * (ub - lb) * rotor)
    t = lambda a: torch.as_tensor(a, device=params.x0.device,
                                  dtype=params.x0.dtype)
    xs, us = t(xs), t(us)
    pb = P.map_params(lambda a: a.expand((B,) + a.shape[1:]).contiguous(),
                      params)
    return pb._replace(x0=xs[:, 0].contiguous()), xs, us


def phase_robots(device):
    """Each kernel against its plain version in f64 on the hover mission of
    every robot in missions/ that no other phase runs (module docstring,
    phase 12), Euler and RK4 nodes: {robot: {kernel: max abs error}}."""
    import torch

    out = {}
    for robot in ROBOTS:
        errs = {}
        for integrator in ("IntegratedActionModelEuler", RK4):
            spec, params = offline_problem(device, torch.float64, robot,
                                           "hover", ROBOT_DT,
                                           integrator=integrator)
            pb, xs, us = robot_inputs(spec, params, ROBOT_B, seed=0)
            feasible = torch.arange(ROBOT_B, device=device) == 0
            label = (f"robots {robot} {spec.integrator} (nv {spec.model.nv}, "
                     f"nu {spec.nu}, {len(spec.slots)} slots)")
            for name, e in _kernel_parity(spec, pb, xs, us, feasible, label,
                                          witnesses=True).items():
                errs[name] = max(errs.get(name, 0.0), e)
        out[robot] = errs
    return out


# ---------------------------------------------------------------------------
# phase 10: the scale-out layer (batches, ranks, the parallel Riccati pass)
# ---------------------------------------------------------------------------

def _par_batch(device):
    """Step 1 of phase 10: ``make_batch_solver`` on the example's workload
    and on the flagship offline problem. Returns {label: (spec, batch
    params, result)}."""
    import torch

    from eagle_mpc_tpu_torch.parallel import (convergence_summary,
                                              make_batch_solver,
                                              perturbed_x0_batch)

    f32 = torch.float32
    solved = {}
    for label, args, B, maxiter in (
            ("iris hover", (f32, "iris", "hover", PAR_IRIS_DT), PAR_IRIS_BATCH,
             PAR_IRIS_MAXITER),
            ("flagship", (f32,), PAR_FLAGSHIP_BATCH, OFFLINE_MAXITER)):
        spec, params = offline_problem(device, *args)
        pb = perturbed_x0_batch(params, B, PAR_NOISE, 0)
        solve = make_batch_solver(spec, maxiter=maxiter)
        torch.cuda.reset_peak_memory_stats()
        res, sec = _solve_timed(lambda: solve(pb))
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        s = convergence_summary(res)
        say(f"parallel batch {label} f32 B={B} T={spec.T}: "
            f"{sec * 1e3:.1f} ms, {B / sec:.1f} solves/s, "
            f"{sec * 1e3 / B:.4f} ms per solve, peak memory {peak:.1f} MiB, "
            f"summary {json.dumps(s)}")
        finite = (bool(torch.isfinite(res.xs).all())
                  and bool(torch.isfinite(res.cost).all()))
        if label == "flagship":
            check(bool(res.feasible.all()) and finite,
                  f"parallel batch flagship B={B}: not every element feasible "
                  "and finite")
        else:
            check(s["feasible_frac"] >= 0.99,
                  f"parallel batch {label} B={B}: feasible fraction {s}")
        solved[label] = (spec, pb, res)
    return solved


def _par_batch_parity(solved):
    """:func:`_kernel_parity` at the end state of each batch solve of step
    1, in f64 on the whole batch at its last homotopy stage (even elements
    feasible, odd ones not): {kernel: {label: max abs error}}."""
    import torch

    from eagle_mpc_tpu_torch.ocp import problem as P
    from eagle_mpc_tpu_torch.solvers import sbfddp

    f64 = torch.float64
    wide = lambda a: a.to(f64) if a.is_floating_point() else a
    out = {}
    for label, (spec, pb, res) in solved.items():
        params = sbfddp._set_homotopy(spec, P.map_params(wide, pb),
                                      float(res.smooth[0]))
        xs = res.xs.to(f64)
        feasible = torch.arange(xs.shape[0], device=xs.device) % 2 == 0
        errs = _kernel_parity(spec, params, xs, res.us.to(f64), feasible,
                              f"parallel batch {label}")
        for name, e in errs.items():
            out.setdefault(name, {})[label] = e
    return out


def _par_ranks(device):
    """Step 2 of phase 10: ranks of ``parallel.worker`` sharing the card."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from eagle_mpc_tpu_torch.parallel import (convergence_summary,
                                              make_batch_solver,
                                              perturbed_x0_batch, scaling,
                                              worker)

    def one_process(dtype, B, reps=0):
        """(summary, median seconds) of the worker's batch solved here."""
        spec, params = offline_problem(device, dtype, "iris", "hover",
                                       worker.DT_MS)
        pb = perturbed_x0_batch(params, B, worker.NOISE, 0)
        if reps:
            make_batch_solver(spec, maxiter=1)(pb)   # as the worker warms up
        times = []
        for _ in range(max(reps, 1)):
            res, sec = _solve_timed(lambda: make_batch_solver(
                spec, maxiter=worker.MAXITER)(pb))
            s = convergence_summary(res)
            times.append(sec)
        return s, float(np.median(times))

    def on_kernels(label, r):
        """A rank on the card launched K1, K2 and K3 and evaluated no plain
        node dynamics there."""
        check(r["topo"]["device"].startswith("cuda"),
              f"parallel ranks ({label}): rank on {r['topo']['device']}")
        for n, c in r["launches"].items():
            check(c > 0, f"parallel ranks ({label}): rank "
                  f"{r['topo']['process_index']}: {n}: no kernel launch")
        check(r["plain_on_card"] == 0, f"parallel ranks ({label}): rank "
              f"{r['topo']['process_index']}: {r['plain_on_card']} plain node "
              "dynamics ran on the card")

    # f64: 2 ranks under gloo and a world of 1 under NCCL, while this
    # process solves the same 64 starts
    t0 = time.time()
    with ThreadPoolExecutor(2) as ex:
        jobs = {label: ex.submit(scaling.run_job, n, PAR_F64_BATCH,
                                 device="cuda", backend=backend,
                                 dtype="float64", timeout=300)
                for label, n, backend in (("2 ranks, gloo", PAR_RANKS, "gloo"),
                                          ("1 rank, nccl", 1, "nccl"))}
        want = one_process(torch.float64, PAR_F64_BATCH)[0]
        ranks = {label: job.result() for label, job in jobs.items()}
    say(f"parallel ranks f64 B={PAR_F64_BATCH}: one process "
        f"{json.dumps(want)} ({time.time() - t0:.1f} s)")
    for label, results in ranks.items():
        for r in results:
            got = r["summary"]
            say(f"parallel ranks f64 ({label}): rank "
                f"{r['topo']['process_index']} of {r['topo']['process_count']}"
                f" on {r['topo']['device']} ({r['topo']['backend']}), "
                f"{r['local_rows']} rows, launches {json.dumps(r['launches'])}"
                f", plain on the card {r['plain_on_card']}, summary "
                f"{json.dumps(got)}")
            on_kernels(f"f64, {label}", r)
            for k in ("n", "feasible_frac", "failed_frac", "iters_mean",
                      "iters_max"):
                check(got[k] == want[k], f"parallel ranks f64 ({label}): {k} "
                      f"{got[k]} against one process's {want[k]}")
            check(abs(got["cost_mean"] - want["cost_mean"])
                  <= 1e-10 * abs(want["cost_mean"]),
                  f"parallel ranks f64 ({label}): cost_mean "
                  f"{got['cost_mean']!r} against one process's "
                  f"{want['cost_mean']!r} (rtol 1e-10)")
    # f32: the median solves/s of 2 ranks beside one process's
    t0 = time.time()
    ranks = scaling.run_job(PAR_RANKS, PAR_F32_BATCH, reps=PAR_REPS,
                            device="cuda", backend="gloo", dtype="float32",
                            timeout=300)
    r = ranks[0]
    for x in ranks:
        on_kernels("f32", x)
    check(all(x["summary"] == r["summary"] for x in ranks),
          "parallel ranks f32: the ranks' summaries differ")
    check(r["summary"]["feasible_frac"] >= 0.99,
          f"parallel ranks f32: {r['summary']}")
    t1 = time.time()
    s1, sec1 = one_process(torch.float32, PAR_F32_BATCH, PAR_REPS)
    name = torch.cuda.get_device_name(0)
    say(f"parallel ranks f32 B={PAR_F32_BATCH} ({PAR_RANKS} ranks on one "
        f"{name}; not scaling; gloo): median {r['median_s'] * 1e3:.1f} ms of "
        f"{PAR_REPS}, {r['solves_per_s']:.1f} solves/s, summary "
        f"{json.dumps(r['summary'])} ({t1 - t0:.1f} s); one process: median "
        f"{sec1 * 1e3:.1f} ms, {PAR_F32_BATCH / sec1:.1f} solves/s, summary "
        f"{json.dumps(s1)} ({time.time() - t1:.1f} s)")


def _riccati_candidate(spec, params, seed):
    """tests/test_priccati.py's ``_candidate``: (xs, us) batched at B=1."""
    import torch

    rng = np.random.default_rng(seed)
    T = spec.T
    xs = np.tile(params.x0[0].cpu().numpy(), (T + 1, 1))
    xs[:, :3] += 0.1 * rng.standard_normal((T + 1, 3))
    xs[:, 7:] += 0.05 * rng.standard_normal((T + 1, xs.shape[1] - 7))
    us = 0.1 * rng.standard_normal((T, spec.nu))
    dev, dt = params.x0.device, params.x0.dtype
    return (torch.as_tensor(xs, dtype=dt, device=dev)[None],
            torch.as_tensor(us, dtype=dt, device=dev)[None])


def _riccati_pair(spec, params, xs, us, feasible, reg):
    """(parallel pass, sequential pass through K3) at one candidate."""
    import torch

    from eagle_mpc_tpu_torch.ocp import problem as P
    from eagle_mpc_tpu_torch.solvers import fddp, priccati

    dev, dt = xs.device, xs.dtype
    derivs, term = P.calc_diff_all(spec, params, xs, us)
    feas = torch.tensor([feasible], device=dev)
    fs = fddp._gaps(spec, params, xs, derivs.xnext, feas)
    r = torch.full((1,), reg, dtype=dt, device=dev)
    return (priccati.parallel_backward_pass(spec, derivs, term, fs, r, r, feas),
            fddp._backward_pass(spec, derivs, term, fs, r, r, feas))


def _par_riccati(device):
    """Step 3 of phase 10: ``priccati.parallel_backward_pass`` against the
    sequential pass (K3), its solves, and the T-crossover."""
    import torch

    from eagle_mpc_tpu_torch.solvers import fddp, priccati, sbfddp

    f64, f32 = torch.float64, torch.float32
    fx = np.load(os.path.join(ROOT, "tests", "fixtures", PAR_FIXTURE))
    # a. tests/test_priccati.py's candidates on iris hover, dt 100
    spec, params = offline_problem(device, f64, "iris", "hover", 100)
    xs, us = (torch.as_tensor(fx[k], dtype=f64, device=device)[None]
              for k in ("pr_xs", "pr_us"))
    for feasible in (False, True):
        for reg in PRICCATI_REGS:
            par, seq = _riccati_pair(spec, params, xs, us, feasible, reg)
            check(bool(par.ok.all()) and bool(seq.ok.all()),
                  f"priccati iris feasible {feasible} reg {reg:g}: not ok")
            worst = {}
            for n, (rtol, atol) in PRICCATI_TOL.items():
                a, b = getattr(par, n), getattr(seq, n)
                excess = ((a - b).abs() - atol - rtol * b.abs()).max().item()
                worst[n] = (a - b).abs().max().item()
                check(excess <= 0, f"priccati iris feasible {feasible} reg "
                      f"{reg:g}: {n} differs from K3's pass (rtol {rtol:g} "
                      f"atol {atol:g})")
            say(f"priccati f64 iris T={spec.T} feasible {feasible} reg "
                f"{reg:g}: max |parallel - K3| "
                + ", ".join(f"{n} {v:.3e}" for n, v in worst.items()))
    # iris dt 2 (T=550), tests/test_priccati.py's long horizon
    spec2, params2 = offline_problem(device, f64, "iris", "hover", 2)
    xs2, us2 = _riccati_candidate(spec2, params2, 1)
    par, seq = _riccati_pair(spec2, params2, xs2, us2, False, 1e-9)
    excess = ((par.k - seq.k).abs() - 1e-7 - 1e-6 * seq.k.abs()).max().item()
    say(f"priccati f64 iris T={spec2.T}: ok {bool(par.ok[0])}, max |k "
        f"parallel - K3| {(par.k - seq.k).abs().max().item():.3e}")
    check(spec2.T >= 500 and bool(par.ok.all()) and excess <= 0,
          f"priccati iris T={spec2.T}: k differs from K3's pass (rtol 1e-6 "
          "atol 1e-7)")

    # b. the flagship at the offline reference's solution, last stage
    specf, paramsf = offline_problem(device, f64)
    st = sbfddp.SbFddpSettings()
    pf = sbfddp._set_homotopy(specf, paramsf, st.smooth_init
                              * st.smooth_mult ** (st.n_stages - 1))
    ref = np.load(os.path.join(ROOT, "missions", "refs",
                               f"{ROBOT}__{MISSION}__dt{DT_REF}.npz"))
    xsf, usf = (torch.as_tensor(ref[k], dtype=f64, device=device)[None]
                for k in ("xs", "us"))
    for feasible in (True, False):
        par, seq = _riccati_pair(specf, pf, xsf, usf, feasible, 1e-9)
        rel = {n: _err(getattr(seq, n), getattr(par, n))[1]
               for n in ("k", "K", "Qu", "Quuk", "Vx", "Vxx")}
        say(f"priccati f64 flagship T={specf.T} at the offline solution "
            f"(feasible {feasible}): ok {bool(par.ok[0])} / {bool(seq.ok[0])}"
            f", largest error relative to each output's max |entry|: "
            + ", ".join(f"{n} {v:.3e}" for n, v in rel.items()))

    # c. the solves with parallel_riccati=True
    pset = fddp.SolverSettings(parallel_riccati=True)
    res, sec = _solve_timed(lambda: sbfddp.solve(
        specf, paramsf, maxiter=OFFLINE_MAXITER,
        settings=sbfddp.SbFddpSettings(solver=pset)))
    say(f"priccati offline flagship f64 B=1: {sec:.3f} s, iters "
        f"{int(res.iters[0])} (sequential pass: {int(ref['iters'])}), cost "
        f"{float(res.cost[0])!r} (sequential: {float(ref['cost'])!r}), "
        f"feasible {bool(res.feasible[0])}")
    check(bool(res.feasible[0]) and not bool(res.failed[0]),
          "priccati offline flagship f64: not feasible")
    xs0, us0 = fddp.default_init(spec, params)
    full = {kind: fddp.solve_fddp(spec, s, params, xs0, us0, 30, 1e-9)
            for kind, s in (("par", pset), ("seq", fddp.SolverSettings()))}
    p, q = full["par"], full["seq"]
    say(f"priccati iris f64 solve_fddp: parallel iters {int(p.iters[0])} cost "
        f"{float(p.cost[0])!r}, sequential iters {int(q.iters[0])} cost "
        f"{float(q.cost[0])!r}, max |xs diff| "
        f"{(p.xs - q.xs).abs().max().item():.3e}")
    check(bool(p.feasible[0]) == bool(q.feasible[0]),
          "priccati iris solve: feasibility differs")
    check(abs(float(p.cost[0]) - float(q.cost[0]))
          <= 1e-8 + 1e-6 * abs(float(q.cost[0])), "priccati iris solve: cost "
          "differs from the sequential solve's")
    check(bool(((p.xs - q.xs).abs() <= 1e-6 + 1e-4 * q.xs.abs()).all()),
          "priccati iris solve: xs differ from the sequential solve's")

    # d. times in f32: the parallel pass against K3's, flagship widths
    dims = SimpleNamespace(nu=specf.nu, state=SimpleNamespace(
        ndx=specf.state.ndx))
    rows = {}
    for B in PRICCATI_BS:
        for T in PRICCATI_TS:
            derivs, term, fs = priccati.random_lqr(B, T, dims.state.ndx,
                                                   dims.nu, T, f32, device)
            reg = torch.full((B,), 1e-9, dtype=f32, device=device)
            feas = torch.zeros(B, dtype=torch.bool, device=device)
            args = (dims, derivs, term, fs, reg, reg, feas)
            par_ms = _time_ms(lambda: priccati.parallel_backward_pass(*args))
            seq_ms = _time_ms(lambda: fddp._backward_pass(*args))
            ok = bool(priccati.parallel_backward_pass(*args).ok.all())
            rows[B, T] = (par_ms, seq_ms)
            say(f"priccati time f32 B={B} T={T} (ndx {dims.state.ndx}, nu "
                f"{dims.nu}): parallel {par_ms:.3f} ms, sequential (K3) "
                f"{seq_ms:.3f} ms, ratio {par_ms / seq_ms:.2f}, parallel ok "
                f"{ok} (medians of {TIMING_REPS})")
        cross = [T for T in PRICCATI_TS if rows[B, T][0] < rows[B, T][1]]
        say(f"priccati crossover f32 B={B}: "
            + (f"the parallel pass is faster from T={cross[0]}" if cross
               else f"none up to {PRICCATI_TS[-1]}"))


def phase_parallel(device):
    """The scale-out layer (module docstring, phase 10). Returns the
    launches per kernel in step 1 and {kernel: {label: max abs error}} of
    its parity at the batch solves' end states."""
    import torch

    from eagle_mpc_tpu_torch.ocp import problem as P
    from eagle_mpc_tpu_torch.ops import node_cuda, riccati_cuda, rollout_cuda

    mods = {"node_linearization": node_cuda, "riccati_backward": riccati_cuda,
            "alpha_rollout": rollout_cuda}
    plain0 = P.PLAIN_ON_CARD
    for m in mods.values():
        m.LAUNCHES = 0
    solved = _par_batch(device)
    torch.cuda.synchronize()
    launches = {n: m.LAUNCHES for n, m in mods.items()}
    say(f"parallel launches during the batch path: {json.dumps(launches)}")
    for n in mods:
        check(launches[n] > 0, f"parallel: {n}: no kernel launch")
    check(P.PLAIN_ON_CARD == plain0, f"parallel: {P.PLAIN_ON_CARD - plain0} "
          "plain node dynamics ran on the card in the batch path")
    errs = _par_batch_parity(solved)   # the plain versions run on the card
    del solved
    plain0 = P.PLAIN_ON_CARD
    _par_ranks(device)
    _par_riccati(device)
    check(P.PLAIN_ON_CARD == plain0, f"parallel: {P.PLAIN_ON_CARD - plain0} "
          "plain node dynamics ran on the card")
    return launches, errs


# ---------------------------------------------------------------------------
# phase 11: the serving layer (the tick in CUDA graphs, the real-time twin)
# ---------------------------------------------------------------------------

def _trace_launches(fn):
    """{kernel: launches} in a ``torch.profiler`` trace of ``fn()``, found
    by the kernels' device names."""
    import torch

    from eagle_mpc_tpu_torch.profile_tick import device_us

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    return {n: sum(e.count for e in events
                   if dev in e.key and device_us(e) > 0)
            for n, dev in KERNEL_DEVICE_NAMES.items()}


def _serving_rows(step_fn, buf, n):
    """``n`` ticks of ``step_fn`` (a replay or an eager tick over ``buf``):
    per field, the ticks' values stacked (B, n, ...)."""
    import torch

    rows = []
    for _ in range(n):
        o = step_fn()
        rows.append({"x": buf.x.clone(), "xs": buf.xs.clone(),
                     "us": buf.us.clone(), "u0": o.u0.clone(),
                     "cost": o.cost.clone(), "iters": o.iters.clone(),
                     "feasible": o.feasible.clone()})
    return {k: torch.stack([r[k] for r in rows], dim=1).cpu()
            for k in rows[0]}


def phase_serving(device):
    """The serving layer (module docstring, phase 11). Returns (launches
    per kernel in one replayed tick, launches per kernel in the traced
    replay, {kernel: f64 parity max abs error}, the bench's numbers)."""
    import torch

    from eagle_mpc_tpu_torch import realtime
    from eagle_mpc_tpu_torch import serving_bench as sb
    from eagle_mpc_tpu_torch.mpc import graph as G
    from eagle_mpc_tpu_torch.ocp import problem as P

    def captured(w):
        buf = w.start.clone()
        step = G.CapturedStep(G.serving_tick(w.ctrl, w.sim, w.settings,
                                             sb.DT_PLANT, buf),
                              device, state=buf)
        return step, buf

    # 1. capture in float32, the launches at capture and in a traced replay
    plain0 = P.PLAIN_ON_CARD
    w = sb.workload(device=device, dtype=torch.float32)
    t0 = time.time()
    step, buf = captured(w)
    torch.cuda.synchronize()
    say(f"serving capture f32 B=1 (sync debug mode error over the warm-up "
        f"and the capture): {time.time() - t0:.3f} s; kernel launches at "
        f"capture, per replayed tick: {json.dumps(step.launches)}")
    check(P.PLAIN_ON_CARD == plain0, f"serving: {P.PLAIN_ON_CARD - plain0} "
          "plain node dynamics ran on the card in the warm-up or capture")
    for n in KERNEL_DEVICE_NAMES:
        check(step.launches.get(n, 0) > 0,
              f"serving: {n}: no launch at capture")
    traced = _trace_launches(step.replay)
    say(f"serving launches in the profiler trace of one replay: "
        f"{json.dumps(traced)}")
    say(f"serving: K3 launches a served tick {traced['riccati_backward']} "
        "(one a direction: the regularization escalation runs inside it)")
    for n in KERNEL_DEVICE_NAMES:
        check(traced[n] > 0, f"serving: {n} ({KERNEL_DEVICE_NAMES[n]}) not "
              "in the trace of a replayed tick")
    out = step.replay()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out.cost).all() & torch.isfinite(buf.x).all()),
          "serving f32: non-finite replay")
    launches = step.launches
    del step, buf

    # 2. float64: 3 replays against 3 eager ticks and the JAX fixture
    fx = np.load(os.path.join(ROOT, "tests", "fixtures", SERVE_FIXTURE))
    w64 = sb.workload(device=device, dtype=torch.float64)
    step, gbuf = captured(w64)
    ebuf = w64.start.clone()
    eager = G.serving_tick(w64.ctrl, w64.sim, w64.settings, sb.DT_PLANT,
                           ebuf, sync_free=False)
    got = _serving_rows(step.replay, gbuf, SERVE_F64_TICKS)
    ref = _serving_rows(eager, ebuf, SERVE_F64_TICKS)
    check(P.PLAIN_ON_CARD == plain0, "serving: plain node dynamics ran on "
          "the card")
    rel = {}
    for k in ("iters", "feasible"):
        check(torch.equal(got[k], ref[k]), f"serving f64 {k}: replays "
              f"{got[k].tolist()}, eager {ref[k].tolist()}")
        check(np.array_equal(got[k].numpy().astype(fx[f"flag_{k}"].dtype),
                             fx[f"flag_{k}"]),
              f"serving f64 {k}: {got[k].tolist()} vs JAX "
              f"{fx['flag_' + k].tolist()}")
    for k in ("x", "xs", "us", "u0", "cost"):
        rel[k] = _err(ref[k], got[k])[1]
        check(rel[k] <= SERVE_REL, f"serving f64 {k}: replays {rel[k]:.3e} "
              f"from the eager ticks (> {SERVE_REL:g})")
        if k == "cost":
            np.testing.assert_allclose(got[k].numpy(), fx["flag_cost"],
                                       rtol=1e-8, err_msg="serving f64 cost")
        else:
            np.testing.assert_allclose(got[k].numpy(), fx[f"flag_{k}"],
                                       rtol=1e-6, atol=1e-8,
                                       err_msg=f"serving f64 {k}")
    jax_d = {k: float(np.abs(got[k].numpy() - fx[f"flag_{k}"]).max())
             for k in ("x", "xs", "us", "u0", "cost")}
    say(f"serving f64 B=1 {SERVE_F64_TICKS} replays: iters "
        f"{got['iters'].tolist()}, feasible {got['feasible'].tolist()}; max "
        f"rel from the eager ticks {json.dumps(rel)}; max |diff| from JAX "
        f"{json.dumps(jax_d)}")
    # both routes run the same launches (K3 escalates inside its own), so
    # the replays equal the eager ticks bit for bit, in float32 too
    step32, gbuf32 = captured(w)
    ebuf32 = w.start.clone()
    eager32 = G.serving_tick(w.ctrl, w.sim, w.settings, sb.DT_PLANT, ebuf32,
                             sync_free=False)
    rows32 = (_serving_rows(step32.replay, gbuf32, SERVE_F64_TICKS),
              _serving_rows(eager32, ebuf32, SERVE_F64_TICKS))
    for prec, (g, e) in (("f64", (got, ref)), ("f32", rows32)):
        diff = [k for k in g if not torch.equal(g[k], e[k])]
        say(f"serving {prec} B=1 {SERVE_F64_TICKS} replays against the eager "
            f"ticks: {'bit for bit' if not diff else 'differ in ' + str(diff)}")
        check(not diff, f"serving {prec}: replays differ from the eager ticks "
              f"in {diff}")
    del step32, gbuf32, ebuf32

    # 3. each kernel against its plain version at the replayed end state
    ctrl = w64.ctrl
    params = ctrl.update_problem(gbuf.t, P.expand_params(
        ctrl.params0, 1)._replace(x0=gbuf.x))
    errs = _offline_parity(ctrl.spec, params, (gbuf.xs, gbuf.us), "serving",
                           box=False)
    # each kernel's bound at the served tick's shapes (B=1, T=29, f32)
    p32 = P.map_params(lambda a: a.to(torch.float32), params)
    calls = kernel_calls(SimpleNamespace(spec=ctrl.spec), p32,
                         gbuf.xs.to(torch.float32), gbuf.us.to(torch.float32),
                         torch.tensor([True], device=device), reg=1e-2)
    for name, (kern, _, ins, flops) in calls.items():
        errs[name]["bound_ms"], errs[name]["bound_by"] = bound_ms(
            ins, kern(), flops)
        say(f"serving bound f32 B=1 T={ctrl.spec.T} {name}: "
            f"{errs[name]['bound_ms']:.5f} ms by {errs[name]['bound_by']}")
    del step, gbuf, ebuf

    # 4. the bench's numbers in float32
    plain0 = P.PLAIN_ON_CARD
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    r = sb.run(w, K=SERVE_K, reps=SERVE_REPS, eager_reps=SERVE_EAGER_REPS)
    r["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    say(f"serving bench f32 B=1 (flagship, t0=3500 ms, 2 ms plant): capture "
        f"{r['capture_s']:.3f} s, device_tick {r['device_tick_ms']:.3f} ms "
        f"(K={SERVE_K}, median of {SERVE_REPS}), roundtrip_tick "
        f"{r['roundtrip_tick_ms']:.3f} ms (median of {5 * SERVE_REPS}), "
        f"eager_tick {r['eager_tick_ms']:.3f} ms (default route, K={SERVE_K}"
        f", median of {SERVE_EAGER_REPS}), budget {w.budget_ms} ms, final "
        f"cost {r['final_cost']:.4f}, peak memory {r['peak_mib']:.1f} MiB")
    check(r["captured"], "serving bench: the tick was not captured")
    check(np.isfinite(r["final_cost"]), "serving bench: non-finite cost")

    # 5. the real-time twin
    robot, mission, dt_ms = RT_MISSION
    t0 = time.time()
    stats, x, _ = realtime.serve(robot, mission, dt_ms, RT_PERIOD_MS,
                                 RT_TICKS, device, torch.float32)
    say(f"realtime {robot}/{mission} f32 {RT_TICKS} ticks at "
        f"{RT_PERIOD_MS:g} ms ({time.time() - t0:.1f} s with the offline "
        f"solve and the capture): {stats}; real time "
        f"{stats.total_avg * 1e3 <= RT_PERIOD_MS}")
    check(stats.n == RT_TICKS, f"realtime: {stats.n} ticks counted")
    check(bool(np.all(np.isfinite(x))), "realtime: the plant diverged")
    check(P.PLAIN_ON_CARD == plain0, "serving: plain node dynamics ran on "
          "the card in the bench or the real-time twin")
    return launches, traced, errs, r


# ---------------------------------------------------------------------------
# phase 3: the bench workload
# ---------------------------------------------------------------------------

def _ref_pos(ref, t_ms):
    t_ref = np.arange(ref.shape[0], dtype=np.float64) * DT_REF
    i = int(np.searchsorted(t_ref, t_ms, side="right"))
    if i >= len(t_ref):
        return ref[-1, :3]
    i1 = max(i, 1)
    a = (t_ms - t_ref[i1 - 1]) / (t_ref[i1] - t_ref[i1 - 1])
    return (1 - a) * ref[i1 - 1, :3] + a * ref[i1, :3]


def phase_path(device, name):
    """One path of phase 3 (module docstring). Returns (launches in the
    whole path, launches per timed tick, end state (t, plant states, xs,
    us))."""
    import torch

    from eagle_mpc_tpu_torch.ops import node_cuda, riccati_cuda, rollout_cuda

    controller, t0, settle, reps, gate_tracking = PATHS[name]
    mods = {"node_linearization": node_cuda, "riccati_backward": riccati_cuda,
            "alpha_rollout": rollout_cuda}
    dtype = torch.float32
    ctrl, sim, ref, hover, n_rot = flagship(device, dtype, controller)
    B = BATCH
    t_warm = t0 - settle * TICKS * DT_SIM
    x0, xs, us = initial_batch(ctrl, ref, hover, n_rot, B, t_warm, device,
                               dtype)

    def chunk(t_ms, xb, xs, us):
        costs, feas = [], []
        for _ in range(TICKS):
            r, xb = tick(ctrl, sim, t_ms, xb, xs, us)
            xs, us = r.xs, r.us
            costs.append(r.cost.mean())
            feas.append(r.feasible.to(dtype).mean())
            t_ms += DT_SIM
        return t_ms, xb, xs, us, torch.stack(costs), torch.stack(feas)

    for m in mods.values():
        m.LAUNCHES = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_start = time.time()
    w = warm_start(ctrl, t_warm, x0, xs, us)
    torch.cuda.synchronize()
    warm_s = time.time() - t_start
    say(f"{name} warm start f32 B={B}: {warm_s:.3f} s, feasible "
        f"{w.feasible.float().mean().item():.4f}, mean cost "
        f"{w.cost.mean().item():.4f}")
    t_ms, xb, xs, us = t_warm, x0, w.xs, w.us
    for _ in range(settle):
        t_ms, xb, xs, us, _, _ = chunk(t_ms, xb, xs, us)
    torch.cuda.synchronize()
    before = {n: m.LAUNCHES for n, m in mods.items()}

    times, costs, feas = [], [], []
    for _ in range(reps):
        t_rep = time.time()
        t_ms, xb, xs, us, c, f = chunk(t_ms, xb, xs, us)
        torch.cuda.synchronize()
        times.append(time.time() - t_rep)
        costs.append(c)
        feas.append(f)
    launches = {n: m.LAUNCHES for n, m in mods.items()}
    peak = torch.cuda.max_memory_allocated()
    for n in mods:
        check(launches[n] > before[n],
              f"{name}: {n}: no kernel launch during the ticks")
    per_tick = {n: (launches[n] - before[n]) / (reps * TICKS) for n in mods}

    med = float(np.median(times))
    costs_h = torch.cat(costs).cpu().numpy()
    feas_h = torch.cat(feas).cpu().numpy()
    pos_err = np.linalg.norm(xb[:, :3].double().cpu().numpy()
                             - _ref_pos(ref, t_ms)[None], axis=1)
    health = {"feasible_frac": float(feas_h[-1]),
              "track_err_mean_m": float(pos_err.mean()),
              "track_err_max_m": float(pos_err.max()),
              "final_mean_cost": float(costs_h[-1])}
    say(f"{name} path f32 B={B} K={TICKS} reps={reps}: "
        f"{B * TICKS / med:.1f} solves/s, tick {med / TICKS * 1e3:.3f} ms "
        f"(chunk times {[round(x, 4) for x in times]} s), warm start "
        f"{warm_s:.3f} s, peak memory {peak / 2**20:.1f} MiB")
    say(f"{name} health: {json.dumps(health)}")
    say(f"{name} launches during the path: {json.dumps(launches)}; per "
        f"timed tick: {json.dumps(per_tick)}")
    check(np.all(np.isfinite(costs_h)), f"{name}: non-finite tick costs")
    check(health["feasible_frac"] >= 0.99, f"{name}: feasible fraction {health}")
    if gate_tracking:
        check(health["track_err_mean_m"] < 0.16,
              f"{name}: mean tracking error {health}")
        check(health["track_err_max_m"] < 0.35,
              f"{name}: max tracking error {health}")
    return launches, per_tick, (t_ms, xb, xs, us)


def main():
    t_start = time.time()
    import torch

    if not torch.cuda.is_available():
        say("FAIL: torch.cuda.is_available() is False; this script needs an "
            "NVIDIA GPU")
        return 1
    sys.path.insert(0, ROOT)
    from eagle_mpc_tpu_torch.ops import _cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    say(smi.splitlines()[0])
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    device = torch.device("cuda", 0)

    t0 = time.time()
    lib = _cuda.build(verbose=True)
    say(f"kernels built in {time.time() - t0:.1f} s: {lib.name}")
    say(ptxas_summary(lib.with_suffix(".log").read_text()))

    paths, stats = {}, {}
    for name in MPC_PATHS:
        t_phase = time.time()
        paths[name] = phase_path(device, name)
        say(f"phase path {name}: {time.time() - t_phase:.1f} s")
    for name in ("carrot", "weighted"):
        t_phase = time.time()
        stats[name] = phase_parity(device, paths[name][2], PATHS[name][0])
        say(f"phase parity {name}: {time.time() - t_phase:.1f} s")
    for name in MPC_PATHS:
        t_phase = time.time()
        phase_reference(device, PATHS[name][0])
        say(f"phase reference {name}: {time.time() - t_phase:.1f} s")
    t_phase = time.time()
    off_launches, off_stats, box_stats = phase_offline(device)
    say(f"phase offline: {time.time() - t_phase:.1f} s")
    t_phase = time.time()
    cl_launches, cl_stats = phase_closed_loop(device)
    say(f"phase closed_loop: {time.time() - t_phase:.1f} s")
    t_phase = time.time()
    con_launches, con_stats = phase_contacts(device)
    say(f"phase contacts: {time.time() - t_phase:.1f} s")
    t_phase = time.time()
    (rk4_launches, rk4_per_tick, rk4_stats, rk4c_launches,
     rk4c_stats) = phase_rk4(device)
    say(f"phase rk4: {time.time() - t_phase:.1f} s")
    t_phase = time.time()
    par_launches, par_errs = phase_parallel(device)
    say(f"phase parallel: {time.time() - t_phase:.1f} s")
    t_phase = time.time()
    srv_launches, srv_traced, srv_errs, _ = phase_serving(device)
    say(f"phase serving: {time.time() - t_phase:.1f} s")
    t_phase = time.time()
    robot_errs = phase_robots(device)
    say(f"phase robots: {time.time() - t_phase:.1f} s")
    foreign = sorted(m for m in sys.modules
                     if m in ("jax", "eagle_mpc_tpu", "tools")
                     or m.startswith(("jax.", "eagle_mpc_tpu.", "tools.")))
    check(not foreign, f"the port imported {foreign}")

    main_stats = stats["carrot"]
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": paths["carrot"][0][name],
         "launches_per_tick": paths["carrot"][1][name],
         "launches_per_path": dict({p: paths[p][0][name] for p in MPC_PATHS},
                                   offline=off_launches[name],
                                   closed_loop=cl_launches[name],
                                   contacts=con_launches[name],
                                   rk4=rk4_launches[name],
                                   parallel=par_launches[name],
                                   serving=srv_launches[name]),
         "max_abs_err": main_stats[name]["max_abs_err"],
         "ms": main_stats[name]["ms"], "plain_ms": main_stats[name]["plain_ms"],
         "bound_ms": main_stats[name]["bound_ms"],
         "bound_by": main_stats[name]["bound_by"], "library_ms": None,
         "weighted": {k: stats["weighted"][name][k] for k in
                      ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
         "offline": {k: off_stats[name][k] for k in
                     ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
         "closed_loop_max_abs_err": cl_stats[name]["max_abs_err"],
         "parallel_max_abs_err": par_errs[name],
         "serving": {"launches_per_replayed_tick": srv_launches[name],
                     "launches_in_traced_replay": srv_traced[name],
                     **{k: srv_errs[name][k] for k in
                        ("max_abs_err", "bound_ms", "bound_by")}},
         "contacts": {CONTACT_MISSIONS[key][0]: con_stats[key][name]
                      for key in CONTACT_MISSIONS},
         "rk4": dict({k: rk4_stats[name][k] for k in
                      ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
                     launches=rk4_launches[name],
                     launches_per_tick=rk4_per_tick[name],
                     **{k: rk4_stats[name][k] for k in
                        ("jax_max_abs_err", "clip_max_abs_err")
                        if k in rk4_stats[name]},
                     contacts=dict({m: rk4c_stats[m][name] for m in rk4c_stats},
                                   launches=rk4c_launches[name])),
         "robots_max_abs_err": {r: robot_errs[r][name] for r in robot_errs},
         **({"offline_box_max_abs_err": box_stats[name]["max_abs_err"],
             "slotless_max_abs_err": box_stats[name]["slotless_max_abs_err"]}
            if name in box_stats else {})}
        for name, src, rep in KERNELS]}
    say(f"chip_smoke.py: {time.time() - t_start:.1f} s in all")
    say(json.dumps(record))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        sys.exit(1)
