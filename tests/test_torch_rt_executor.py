"""The PyTorch port's real-time executor (``eagle_mpc_tpu_torch.utils.
rt_executor``, its own copy of csrc/rt_executor.cpp) against the JAX
package's: tests/test_rt_executor.py's cases with the same tolerances, the
same records through both executors, and where the port builds its
library. Host code only; no JAX function is compiled."""

import time

import numpy as np
import pytest

from eagle_mpc_tpu.utils import rt_executor as jax_rte
from eagle_mpc_tpu_torch.utils import rt_executor as rte
from eagle_mpc_tpu_torch.utils.rt_executor import RealTimeExecutor


class TestRealTimeExecutor:
    def test_builds_and_runs(self):
        with RealTimeExecutor(period_s=0.002, ring=64) as ex:
            for i in range(20):
                ex.wait_next()
                t0 = ex.now()
                time.sleep(0.0002)
                t1 = ex.now()
                ex.record(1e-5, t1 - t0, cost=float(i), iters=2)
            s = ex.stats()
        assert s.n == 20
        assert s.deadline_misses == 0
        assert 0.0001 < s.solve_avg < 0.002
        assert s.period_s == pytest.approx(0.002)

    def test_period_is_held(self):
        """Consecutive wait_next returns are one period apart (drift-free)."""
        times = []
        with RealTimeExecutor(period_s=0.005) as ex:
            for _ in range(10):
                ex.wait_next()
                times.append(ex.now())
        gaps = np.diff(times)
        # a loaded box can preempt single ticks: the drift-free property is
        # about the typical gap and the absolute schedule
        assert abs(float(np.median(gaps)) - 0.005) < 0.002, gaps
        assert np.sum(np.abs(gaps - 0.005) < 0.002) >= 6, gaps
        assert abs((times[-1] - times[0]) - 9 * 0.005) < 0.010

    def test_deadline_misses_counted(self):
        with RealTimeExecutor(period_s=0.002, budget_s=0.001) as ex:
            for _ in range(5):
                ex.wait_next()
                ex.record(0.0, 0.005, 0.0, 1)   # 5 ms >> 1 ms budget
            s = ex.stats()
        assert s.deadline_misses == 5

    def test_overrun_skips_to_future_slot(self):
        """After an overrun the schedule resumes on a future slot instead of
        bursting catch-up ticks."""
        with RealTimeExecutor(period_s=0.003) as ex:
            ex.wait_next()
            time.sleep(0.010)             # overrun ~3 periods
            late = ex.wait_next()
            assert late > 0.005
            t0 = ex.now()
            late2 = ex.wait_next()        # waits a full period again
            assert late2 == 0.0
            assert ex.now() - t0 > 0.002

    def test_history_ring(self):
        with RealTimeExecutor(period_s=0.001, ring=8) as ex:
            for i in range(12):
                ex.wait_next()
                ex.record(0.0, 1e-4, float(i), i)
            h = ex.history()
        assert h.shape == (8, 5)
        np.testing.assert_array_equal(h[:, 0], np.arange(4, 12))  # newest 8
        np.testing.assert_array_equal(h[:, 4], np.arange(4, 12))


def test_same_records_same_stats_as_jax():
    """One seeded record sequence (no waits, so no lateness) through both
    packages' executors: equal statistics, field for field, and equal
    history."""
    rng = np.random.default_rng(0)
    records = [(float(u), float(s), float(c), int(i)) for u, s, c, i in zip(
        rng.uniform(0, 2e-3, 30), rng.uniform(0, 8e-3, 30),
        rng.uniform(0, 10, 30), rng.integers(0, 5, 30))]
    out = []
    for Executor in (RealTimeExecutor, jax_rte.RealTimeExecutor):
        with Executor(period_s=0.01, budget_s=0.006, ring=16) as ex:
            for r in records:
                ex.record(*r)
            out.append((ex.stats(), ex.history()))
    (port, port_h), (ref, ref_h) = out
    assert port == ref
    assert port.n == 30 and port.deadline_misses > 0
    assert str(port) == str(ref)
    np.testing.assert_array_equal(port_h, ref_h)


def test_library_in_the_port():
    """The port builds its own library under eagle_mpc_tpu_torch/csrc/build,
    from its own source."""
    RealTimeExecutor(period_s=0.01).close()
    lib = rte.build_library()
    assert lib.exists()
    assert lib.parent.parent.name == "csrc"
    assert lib.parent.parent.parent.name == "eagle_mpc_tpu_torch"
    assert lib.parent.name == "build"
    assert rte.SOURCE.parent == lib.parent.parent
