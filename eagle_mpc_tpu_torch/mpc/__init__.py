"""MPC controllers (Carrot / Rail / Weighted / task-activated carrot) and
the closed-loop harness."""

from .base import MpcAbstract
from .carrot import CarrotMpc
from .loop import (ClosedLoopResult, hold_padded, offline_solution,
                   run_closed_loop)
from .rail import RailMpc
from .task_mpc import TaskActivatedCarrotMpc
from .weighted import WeightedMpc

__all__ = ["MpcAbstract", "CarrotMpc", "RailMpc", "WeightedMpc",
           "TaskActivatedCarrotMpc", "run_closed_loop", "ClosedLoopResult",
           "offline_solution", "hold_padded"]
