"""Build, load and feed the hand-written Hopper kernels (csrc/*.cu).

The kernels are compiled with ``nvcc`` for ``sm_90a``, one compiler
process per source, all started together, and linked into one shared
library with a plain C interface, bound with ``ctypes``. The build runs on
first use, into ``csrc/build/``, keyed by a hash of the sources and the
flags; nothing is built or imported while this module is imported.

The robot is not compiled into the kernels: each problem spec is packed
into a ``ModelDesc`` (mirrored field for field from ``csrc/model.cuh``)
that stays on the device, and the problem parameters into two row
tables, one row per node and one per problem.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..dynamics.model import REVOLUTE
from ..ocp import costs as C
from ..ocp import problem as P

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("node.cu", "riccati.cu", "rollout.cu")
HEADERS = ("dual.cuh", "model.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# compile-time maxima of csrc/model.cuh
MAX_NJ = 6
MAX_BODIES = MAX_NJ + 1
MAX_NV = 6 + MAX_NJ
MAX_NU = 12
MAX_SLOTS = 12
MAX_CONTACTS = 2
MAX_NC = 6          # constraint rows: one 6-D contact or two 3-D ones
CONE_ROWS = 5

_KIND = {C.STATE: 0, C.CONTROL: 1, C.FRAME_PLACEMENT: 2,
         C.FRAME_TRANSLATION: 3, C.FRAME_ROTATION: 4, C.FRAME_VELOCITY: 5,
         C.FRICTION_CONE: 6}
_ACT = {C.QUAD: 0, C.WQUAD: 1, C.QBARRIER: 2, C.WQBARRIER: 3}
_INTEGRATOR = {P.EULER: 0, P.RK4: 1}


class ModelDesc(ctypes.Structure):
    _fields_ = [
        ("joint_p", ctypes.c_double * (MAX_NJ * 3)),
        ("joint_R", ctypes.c_double * (MAX_NJ * 9)),
        ("joint_axis", ctypes.c_double * (MAX_NJ * 3)),
        ("inertia", ctypes.c_double * (MAX_BODIES * 36)),
        ("tau_f", ctypes.c_double * (6 * MAX_NU)),
        ("gravity", ctypes.c_double),
        ("dt", ctypes.c_double),
        ("slot_fp", ctypes.c_double * (MAX_SLOTS * 3)),
        ("slot_fR", ctypes.c_double * (MAX_SLOTS * 9)),
        ("slot_cone", ctypes.c_double * (MAX_SLOTS * 3 * CONE_ROWS)),
        ("con_fp", ctypes.c_double * (MAX_CONTACTS * 3)),
        ("con_fR", ctypes.c_double * (MAX_CONTACTS * 9)),
        ("con_gain", ctypes.c_double * (MAX_CONTACTS * 2)),
        ("parent", ctypes.c_int * MAX_NJ),
        ("joint_type", ctypes.c_int * MAX_NJ),
        ("nj", ctypes.c_int), ("nq", ctypes.c_int), ("nv", ctypes.c_int),
        ("nu", ctypes.c_int), ("n_rot", ctypes.c_int),
        ("use_squash", ctypes.c_int),
        ("n_slots", ctypes.c_int), ("n_res", ctypes.c_int),
        ("node_dim", ctypes.c_int), ("glob_dim", ctypes.c_int),
        ("slot_kind", ctypes.c_int * MAX_SLOTS),
        ("slot_act", ctypes.c_int * MAX_SLOTS),
        ("slot_nr", ctypes.c_int * MAX_SLOTS),
        ("slot_ref_off", ctypes.c_int * MAX_SLOTS),
        ("slot_glob_off", ctypes.c_int * MAX_SLOTS),
        ("slot_body", ctypes.c_int * MAX_SLOTS),
        ("slot_contact", ctypes.c_int * MAX_SLOTS),
        ("n_con", ctypes.c_int), ("nc", ctypes.c_int),
        ("con_dim", ctypes.c_int * MAX_CONTACTS),
        ("con_body", ctypes.c_int * MAX_CONTACTS),
        ("con_row", ctypes.c_int * MAX_CONTACTS),
        ("con_ref_off", ctypes.c_int * MAX_CONTACTS),
        ("con_act_off", ctypes.c_int),
        ("integrator", ctypes.c_int),
    ]


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda)")
    return path


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the kernels into BUILD_DIR unless this source hash is built.
    Returns the library path; the compiler's report (registers, shared
    memory, spills) goes to a log file beside it."""
    key = source_hash()
    lib = BUILD_DIR / f"libeagle_mpc_kernels_{key}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}")
    nvcc = _nvcc()
    t0 = time.time()
    objs = [tmp.with_name(f"{Path(s).stem}_{tmp.name}.o") for s in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
            for s, o in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    results = []
    for c, p in zip(cmds, procs):
        out, err = p.communicate()
        results.append((c, p.returncode, out, err))
    link = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
    if all(r[1] == 0 for r in results):
        proc = subprocess.run(link, capture_output=True, text=True)
        results.append((link, proc.returncode, proc.stdout, proc.stderr))
    log = lib.with_suffix(".log")
    log.write_text("".join(" ".join(c) + "\n" + out + err
                           for c, _, out, err in results))
    for o in objs:
        o.unlink(missing_ok=True)
    failed = [r for r in results if r[1] != 0]
    if failed:
        raise RuntimeError(f"nvcc failed ({failed[0][1]}); see {log}:\n"
                           + "".join(r[3] for r in failed)[-4000:])
    os.replace(tmp, lib)
    if verbose:
        print(f"built {lib.name} in {time.time() - t0:.1f} s", flush=True)
    return lib


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.eagle_desc_size.restype = _I
    lib.eagle_desc_size.argtypes = []
    if lib.eagle_desc_size() != ctypes.sizeof(ModelDesc):
        raise RuntimeError("ModelDesc layout differs between csrc/model.cuh "
                           "and ops/_cuda.py")
    for prec, real in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
        fn = getattr(lib, f"eagle_node_smem_{prec}")
        fn.restype = ctypes.c_longlong
        fn.argtypes = [_P, _P]
        fn = getattr(lib, f"eagle_node_{prec}")
        fn.restype = _I
        fn.argtypes = [_P, _P, _I, _I] + [_P] * 13 + [_P]
        fn = getattr(lib, f"eagle_riccati_{prec}")
        fn.restype = _I
        fn.argtypes = [_I, _I, _I, _I, real] + [_P] * 13 + [_P] * 6 + [_P]
        fn = getattr(lib, f"eagle_riccati_escalating_{prec}")
        fn.restype = _I
        fn.argtypes = ([_I, _I, _I, _I, real] + [_P] * 13 + [_P] * 6
                       + [_P] * 4 + [real, real, _I] + [_P] * 4 + [_P])
        fn = getattr(lib, f"eagle_rollout_{prec}")
        fn.restype = _I
        fn.argtypes = [_P, _P, _I, _I, _I, _I] + [_P] * 10 + [_P] * 4 + [_P]
    return lib


def call(name: str, dtype, *args) -> None:
    """Launch ``name`` for ``dtype`` on the current stream; raise if the
    launch was refused."""
    prec = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), f"{name}_{prec}")(*args, stream)
    if err != 0:
        note = _node_smem_note(prec, args[1]) if name == "eagle_node" else ""
        raise RuntimeError(f"{name}_{prec}: CUDA error {err}{note}")


def _node_smem_note(prec: str, host_desc: int) -> str:
    """The shared memory K1's smallest block needs on the spec at
    ``host_desc`` (one node under RK4, four otherwise) beside the device's
    limit a block: the launcher refuses a spec when no node fits."""
    limit = ctypes.c_int(0)
    need = getattr(library(), f"eagle_node_smem_{prec}")(
        host_desc, ctypes.byref(limit))
    return (f" (K1 needs {need} bytes of shared memory a block on this spec;"
            f" the device gives {limit.value})")


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def check_tensor(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"the kernels take CUDA or CPU tensors, got {t.device}")
    if t.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernels take float32 or float64, got {t.dtype}")


# ---------------------------------------------------------------------------
# spec descriptor and parameter rows
# ---------------------------------------------------------------------------

def make_descriptor(spec: P.ProblemSpec) -> ModelDesc:
    """Pack a spec into a ModelDesc; raise for a spec the kernels do not
    take."""
    P.check_scope(spec)
    m = spec.model
    n_rot = len(spec.tau_f[0])
    if (m.nj > MAX_NJ or spec.nu > MAX_NU or len(spec.slots) > MAX_SLOTS
            or len(spec.contacts) > MAX_CONTACTS or spec.nc_rows > MAX_NC):
        raise NotImplementedError(
            f"spec exceeds the kernels' maxima (nj {m.nj} > {MAX_NJ}, "
            f"nu {spec.nu} > {MAX_NU}, {len(spec.slots)} slots > {MAX_SLOTS}, "
            f"{len(spec.contacts)} contacts > {MAX_CONTACTS} or "
            f"{spec.nc_rows} constraint rows > {MAX_NC})")
    if spec.nu != n_rot + m.nj:
        raise NotImplementedError("controls must be rotor thrusts + joint torques")
    d = ModelDesc()
    d.joint_p[:3 * m.nj] = np.asarray(m.joint_p, float).reshape(-1).tolist()
    d.joint_R[:9 * m.nj] = np.asarray(m.joint_R, float).reshape(-1).tolist()
    d.joint_axis[:3 * m.nj] = np.asarray(m.joint_axis, float).reshape(-1).tolist()
    d.inertia[:36 * (m.nj + 1)] = np.asarray(m.inertia, float).reshape(-1).tolist()
    d.tau_f[:6 * n_rot] = np.asarray(spec.tau_f, float).reshape(-1).tolist()
    d.gravity = float(m.gravity)
    d.dt = float(spec.dt)
    d.parent[:m.nj] = list(m.parent)
    d.joint_type[:m.nj] = [0 if jt == REVOLUTE else 1 for jt in m.joint_type]
    d.nj, d.nq, d.nv, d.nu, d.n_rot = m.nj, m.nq, m.nv, spec.nu, n_rot
    d.use_squash = int(spec.use_squash)
    d.integrator = _INTEGRATOR[spec.integrator]
    K = len(spec.slots)
    d.n_slots = K
    ref_off, glob_off = 2 * K, 1 + 2 * spec.nu
    for k, s in enumerate(spec.slots):
        d.slot_kind[k] = _KIND[s.kind]
        d.slot_act[k] = _ACT[s.activation]
        d.slot_nr[k] = s.nr
        d.slot_ref_off[k] = ref_off
        d.slot_glob_off[k] = glob_off
        if s.kind in C.REF_DIMS:
            f = m.frames[s.frame_id]
            d.slot_body[k] = f.body
            d.slot_fp[3 * k:3 * k + 3] = np.asarray(f.p, float).reshape(-1).tolist()
            d.slot_fR[9 * k:9 * k + 9] = np.asarray(f.R, float).reshape(-1).tolist()
        d.slot_contact[k] = -1
        if s.kind == C.FRICTION_CONE:
            if s.contact_id >= len(spec.contacts):
                raise NotImplementedError(
                    f"cone slot {s.name!r} on contact {s.contact_id}, of "
                    f"{len(spec.contacts)}")
            d.slot_contact[k] = s.contact_id
            k15 = 3 * CONE_ROWS * k
            d.slot_cone[k15:k15 + 3 * CONE_ROWS] = np.asarray(
                s.cone_A, float).reshape(-1).tolist()
        ref_off += s.ref_dim
        glob_off += 3 * s.nr
    # the contacts: their activity, then their references, after the slots'
    d.n_con, d.nc, d.con_act_off = len(spec.contacts), spec.nc_rows, ref_off
    ref_off += len(spec.contacts)
    row = 0
    for c, con in enumerate(spec.contacts):
        f = m.frames[con.frame_id]
        d.con_dim[c], d.con_body[c], d.con_row[c] = con.dim, f.body, row
        d.con_ref_off[c] = ref_off
        d.con_fp[3 * c:3 * c + 3] = np.asarray(f.p, float).reshape(-1).tolist()
        d.con_fR[9 * c:9 * c + 9] = np.asarray(f.R, float).reshape(-1).tolist()
        d.con_gain[2 * c:2 * c + 2] = [float(g) for g in con.gains]
        row += con.dim
        ref_off += con.ref_dim
    d.n_res = sum(s.nr for s in spec.slots)
    d.node_dim, d.glob_dim = ref_off, glob_off
    return d


@functools.lru_cache(maxsize=32)
def host_descriptor(spec: P.ProblemSpec) -> ModelDesc:
    """The spec's ModelDesc on the host (kept for reuse): the launchers
    size their shared memory from it."""
    return make_descriptor(spec)


@functools.lru_cache(maxsize=32)
def descriptor(spec: P.ProblemSpec, device) -> torch.Tensor:
    """The spec's ModelDesc as bytes on ``device`` (kept for reuse)."""
    raw = bytes(host_descriptor(spec))
    return torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(device)


def descriptor_args(spec: P.ProblemSpec, device):
    """(device pointer, host pointer) of the spec's ModelDesc, the first
    two arguments of the node and rollout launchers; both stay cached."""
    return (descriptor(spec, device).data_ptr(),
            ctypes.addressof(host_descriptor(spec)))


def pack_params(spec: P.ProblemSpec, params: P.ProblemParams, dtype, device):
    """Batched params -> (node rows (B, T, node_dim) of the running nodes:
    [weight, active, refs..., contact activity, contact refs...]; global rows
    (B, glob_dim): [smooth, s_lb, s_ub, per slot (act_w, lb, ub)]), checked
    against the spec's layout."""
    T, B = spec.T, params.x0.shape[0]
    node, glob = params.node, params.glob
    contact = ([node.contact_active[:, :T]]
               + [r[:, :T] for r in node.contact_refs]) if spec.contacts else []
    node_rows = torch.cat([node.weight[:, :T], node.active[:, :T]]
                          + [r[:, :T] for r in node.refs] + contact,
                          dim=-1).contiguous()
    parts = [glob.squash_smooth[:, None], glob.s_lb, glob.s_ub]
    for a, lo, hi in zip(glob.act_w, glob.lb, glob.ub):
        parts += [a, lo, hi]
    glob_rows = torch.cat(parts, dim=-1).contiguous()
    K = len(spec.slots)
    node_dim = (2 * K + sum(s.ref_dim for s in spec.slots) + len(spec.contacts)
                + sum(c.ref_dim for c in spec.contacts))
    glob_dim = 1 + 2 * spec.nu + 3 * sum(s.nr for s in spec.slots)
    check_tensor(node_rows, "node params", (B, T, node_dim), dtype, device)
    check_tensor(glob_rows, "global params", (B, glob_dim), dtype, device)
    return node_rows, glob_rows
