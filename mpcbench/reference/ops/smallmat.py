"""Cholesky factor and solves for batches of tiny SPD matrices.

Counterpart of ``eagle_mpc_tpu.ops.smallmat`` (which unrolls the factor at
trace time for the TPU's tiling). Here the batched LAPACK/cuSOLVER routines
do the work; what is kept is the semantics: a matrix that is not positive
definite yields NaN, never an exception, so the solver detects the failure
from the data (``torch.linalg.cholesky`` would raise).
"""

from __future__ import annotations

import torch


def cholesky(M):
    """Lower Cholesky factor of (..., n, n); NaN where M is not PD."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info > 0)[..., None, None],
                       torch.full_like(L, float("nan")), L)


class CholFactor:
    """Factor once, solve many right-hand sides."""

    def __init__(self, M):
        self.L = cholesky(M)

    def solve(self, b):
        return torch.cholesky_solve(b.unsqueeze(-1), self.L).squeeze(-1)

    def solve_mat(self, B):
        return torch.cholesky_solve(B, self.L)


def solve_psd(M, b):
    """x = M^{-1} b for SPD M (..., n, n), b (..., n)."""
    return CholFactor(M).solve(b)


def solve_psd_mat(M, B):
    """X = M^{-1} B for SPD M (..., n, n), B (..., n, m)."""
    return CholFactor(M).solve_mat(B)
