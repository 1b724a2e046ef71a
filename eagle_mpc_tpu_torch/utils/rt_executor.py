"""ctypes binding of the native real-time executor (csrc/rt_executor.cpp).

PyTorch port's counterpart of ``eagle_mpc_tpu.utils.rt_executor``, with its
own copy of the C++ source. The shared library is built with ``g++`` on
first use into ``eagle_mpc_tpu_torch/csrc/build/`` and wrapped in a
context-manager class. This is the serving-loop runtime: the MPC tick runs
inside precisely scheduled periodic ticks with deadline-miss accounting
and a telemetry ring. Host code only: it runs the same beside a card or
without one.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = CSRC / "rt_executor.cpp"
LIB_PATH = CSRC / "build" / "librt_executor.so"
_lib = None


def build_library() -> Path:
    """Compile the executor unless the library is newer than its source;
    the library is written under a temporary name and moved into place, so
    processes that build at once never load a partial file."""
    if (not LIB_PATH.exists()
            or LIB_PATH.stat().st_mtime < SOURCE.stat().st_mtime):
        LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
        tmp = LIB_PATH.with_suffix(f".tmp{os.getpid()}")
        subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                        str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, LIB_PATH)
    return LIB_PATH


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.rte_create.restype = ctypes.c_void_p
        lib.rte_create.argtypes = [ctypes.c_double, ctypes.c_double, ctypes.c_int]
        lib.rte_destroy.argtypes = [ctypes.c_void_p]
        lib.rte_start.argtypes = [ctypes.c_void_p]
        lib.rte_wait_next.restype = ctypes.c_double
        lib.rte_wait_next.argtypes = [ctypes.c_void_p]
        lib.rte_record.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                   ctypes.c_double, ctypes.c_double, ctypes.c_int]
        lib.rte_stats.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_double)]
        lib.rte_history.restype = ctypes.c_int
        lib.rte_history.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_double), ctypes.c_int]
        lib.rte_now.restype = ctypes.c_double
        _lib = lib
    return _lib


class ExecutorStats(NamedTuple):
    n: int
    update_avg: float
    update_std: float
    update_max: float
    update_min: float
    solve_avg: float
    solve_std: float
    solve_max: float
    solve_min: float
    total_avg: float
    total_max: float
    lateness_avg: float
    lateness_max: float
    deadline_misses: int
    period_s: float
    budget_s: float

    def __str__(self):
        ms = 1e3
        return (f"ticks={self.n} update {self.update_avg*ms:.3f}±"
                f"{self.update_std*ms:.3f} ms | solve {self.solve_avg*ms:.3f}±"
                f"{self.solve_std*ms:.3f} ms (max {self.solve_max*ms:.3f}) | "
                f"total avg {self.total_avg*ms:.3f} ms vs budget "
                f"{self.budget_s*ms:.1f} ms | misses {self.deadline_misses} | "
                f"sched lateness max {self.lateness_max*ms:.3f} ms")


class RealTimeExecutor:
    """Drift-free periodic tick scheduler with telemetry.

    Usage::

        with RealTimeExecutor(period_s=0.02) as ex:
            for _ in range(n):
                ex.wait_next()
                t0 = ex.now(); params = update(...); t1 = ex.now()
                res = solve(...); t2 = ex.now()
                ex.record(t1 - t0, t2 - t1, cost, iters)
            print(ex.stats())
    """

    def __init__(self, period_s: float, budget_s: Optional[float] = None,
                 ring: int = 4096):
        self._lib = _load()
        self._h = self._lib.rte_create(period_s, budget_s or period_s, ring)
        if not self._h:
            raise ValueError("invalid executor parameters")

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()

    def start(self):
        self._lib.rte_start(self._h)

    def now(self) -> float:
        return self._lib.rte_now()

    def wait_next(self) -> float:
        """Block until the next tick deadline; returns lateness [s]."""
        return self._lib.rte_wait_next(self._h)

    def record(self, update_s: float, solve_s: float, cost: float = 0.0,
               iters: int = 0):
        self._lib.rte_record(self._h, update_s, solve_s, cost, iters)

    def stats(self) -> ExecutorStats:
        buf = (ctypes.c_double * 16)()
        self._lib.rte_stats(self._h, buf)
        v = list(buf)
        return ExecutorStats(int(v[0]), *v[1:13], int(v[13]), v[14], v[15])

    def history(self, max_n: int = 4096) -> np.ndarray:
        """(n, 5) array of recent [tick, update_s, solve_s, cost, iters]."""
        buf = (ctypes.c_double * (5 * max_n))()
        n = self._lib.rte_history(self._h, buf, max_n)
        return np.frombuffer(buf, dtype=np.float64, count=5 * n).reshape(n, 5).copy()

    def close(self):
        if self._h:
            self._lib.rte_destroy(self._h)
            self._h = None
