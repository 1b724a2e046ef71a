"""Kernel K3's plain version (``ops/riccati_cuda.backward_plain``) on the
properties its batched CUDA design relies on, and ``chip_smoke``'s K3
cases (a ragged batch, indefinite Quu) run on the CPU, where the wrapper
takes the plain version.

Inputs are synthetic, from a numpy seed, at the flagship's widths (ndx=18,
nu=9) over 3 nodes: Fx near the identity, positive definite Lxx, Luu and
VxxT, half of the scenarios infeasible. No JAX; each test takes well
under a second.
"""

import os
import sys

import numpy as np
import pytest
import torch

from eagle_mpc_tpu_torch.ops import riccati_cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, NDX, NU = 8, 3, 18, 9


def _inputs(dtype=torch.float64, seed=0):
    """backward's arguments (Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs, VxT, VxxT,
    xreg, ureg, feasible) for B scenarios."""
    rng = np.random.default_rng(seed)
    n = lambda *shape: rng.normal(size=shape)

    def spd(*lead, size):
        a = rng.normal(size=lead + (size, size))
        return a @ np.swapaxes(a, -1, -2) / size + np.eye(size)

    reg = np.full(B, 1e-2)
    arrays = (np.eye(NDX) + 0.1 * n(B, T, NDX, NDX), 0.1 * n(B, T, NDX, NU),
              n(B, T, NDX), n(B, T, NU), spd(B, T, size=NDX),
              0.1 * n(B, T, NDX, NU), spd(B, T, size=NU), 0.01 * n(B, T, NDX),
              n(B, NDX), spd(B, size=NDX), reg, reg)
    return (tuple(torch.as_tensor(a, dtype=dtype) for a in arrays)
            + (torch.arange(B) % 2 == 0,))


def _ok(out):
    """Per scenario: k, K and Vx all finite (``fddp._backward_pass``'s ok)."""
    k, K, _, _, Vx, _ = out
    return (torch.isfinite(k).flatten(1).all(1)
            & torch.isfinite(K).flatten(1).all(1)
            & torch.isfinite(Vx).flatten(1).all(1))


@pytest.mark.parametrize("n", [1, 5, 7])
def test_scenarios_are_independent(n):
    """The first n scenarios alone give what they give in the whole batch
    (the kernel's ragged last block relies on it): 1e-12 relative to each
    output's largest entry."""
    args = _inputs()
    whole = riccati_cuda.backward_plain(*args)
    part = riccati_cuda.backward_plain(*(a[:n] for a in args))
    for w, p in zip(whole, part):
        scale = w[:n].abs().max()
        assert ((w[:n] - p).abs().max() / scale).item() < 1e-12


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_indefinite_quu_fails_alone(dtype):
    """ureg = -1e3 makes Quu indefinite: the scenario's k, K and Vx become
    NaN (no exception, no clamp); every other scenario keeps its result
    exactly."""
    args = _inputs(dtype)
    bad = torch.zeros(B, dtype=torch.bool)
    bad[[2, 5]] = True
    ureg = torch.where(bad, torch.full_like(args[11], -1e3), args[11])
    base = riccati_cuda.backward_plain(*args)
    out = riccati_cuda.backward_plain(*args[:11], ureg, args[12])
    assert torch.equal(_ok(out), ~bad)
    assert bool(_ok(base).all())
    for b_out, o_out in zip(base, out):
        assert torch.equal(b_out[~bad], o_out[~bad])


@pytest.mark.parametrize("n_ragged, every", [(7, 2), (5, 3)])
def test_riccati_cases_on_cpu(n_ragged, every):
    """chip_smoke's K3 cases on CPU tensors: the wrapper and the plain
    version agree exactly, every ragged scenario is ok and exactly the
    ``every``-th scenarios fail."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    cases = chip_smoke.riccati_cases(_inputs(), n_ragged=n_ragged, every=every)
    assert cases["ragged"] == (0.0, 0.0, n_ragged, n_ragged)
    assert cases["indefinite"] == (0.0, 0.0, B - B // every, B)


def test_riccati_cases_want_an_odd_count():
    """An even count may fill whole blocks, so it does not test a ragged
    one: chip_smoke refuses it."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.riccati_cases(_inputs(), n_ragged=6, every=2)
