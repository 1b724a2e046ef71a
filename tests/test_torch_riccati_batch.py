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


def _escalation_inputs(dtype):
    """backward_escalating's arguments for four scenarios, one of each
    kind: as given (no retry), Luu shifted by -6 I (retries, then passes),
    by -1e15 I (fails up to reg_max), and a NaN in Lx with its derivatives
    marked non-finite (fails, no retry); the last two infeasible. reg_max
    1e3 keeps the ladder short."""
    (Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs, LxT, LxxT, xreg, ureg,
     feasible) = (a[:4] for a in _inputs(dtype))
    shift = torch.tensor([0.0, 6.0, 1e15, 0.0], dtype=dtype)
    Luu = Luu - shift[:, None, None, None] * torch.eye(NU, dtype=dtype)
    Lx = Lx.clone()
    Lx[3, 1, 2] = float("nan")
    derivs_ok = torch.tensor([True, True, True, False])
    fs = torch.cat([fs, 0.01 * fs[:, :1]], dim=1)
    return (Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs, LxT, LxxT, xreg, ureg,
            torch.tensor([True, False, True, False]), derivs_ok)


@pytest.mark.parametrize("sync_free", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_escalation_equals_the_host_rounds(dtype, sync_free, monkeypatch):
    """K3's escalating entry on the CPU (``backward_escalating_plain``)
    equals the escalation in rounds on the host (``fddp._host_escalation``
    over K3's one pass: masked rounds and ``_select``) bit for bit, NaNs
    included: k, K, Qu, Quu k, Vx, Vxx with the terminal row, the final
    regularizations, which rows failed and the passes each row ran (the
    host's from its per-row counter)."""
    from types import SimpleNamespace

    from eagle_mpc_tpu_torch.solvers import fddp
    from eagle_mpc_tpu_torch.utils import spans

    args = _escalation_inputs(dtype)
    (Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs, LxT, LxxT, xreg, ureg, feasible,
     derivs_ok) = args
    settings = fddp.SolverSettings(reg_max=1e3)
    bound = fddp.escalation_bound(settings, 1e-2, dtype)
    got = riccati_cuda.backward_escalating(*args, settings.reg_factor,
                                           settings.reg_max, bound, sync_free)
    monkeypatch.setattr(spans, "_R", spans._Recorder())
    spans.enable()
    derivs = SimpleNamespace(Fx=Fx, Fu=Fu, Lx=Lx, Lu=Lu, Lxx=Lxx, Lxu=Lxu,
                             Luu=Luu)
    bp, xr, ur = fddp._host_escalation(
        None, settings, derivs, (None, LxT, LxxT), fs, xreg, ureg, feasible,
        derivs_ok, None, sync_free, bound, torch.ones(4, dtype=torch.bool))
    rows = {name: r.clone() for (name, _, _), r in spans._R.rows.items()}
    spans.disable()
    bits = {torch.float32: torch.int32, torch.float64: torch.int64}[dtype]
    k, K, Qu, Quuk, Vx, Vxx, VxT, VxxT, xreg_g, ureg_g, ok, passes = got
    want = (bp.k, bp.K, bp.Qu, bp.Quuk, bp.Vx, bp.Vxx, xr, ur)
    have = (k, K, Qu, Quuk, torch.cat([Vx, VxT[:, None]], dim=1),
            torch.cat([Vxx, VxxT[:, None]], dim=1), xreg_g, ureg_g)
    for w, h in zip(want, have):
        assert torch.equal(w.view(bits), h.view(bits))
    assert torch.equal(ok, bp.ok)
    assert torch.equal(passes.long(), rows["backward.row_passes_needed"])
    assert torch.equal(passes.long() - 1, rows["backward.row_retries"])
    # the four kinds did what they were made for
    assert ok.tolist() == [True, True, False, False]
    assert passes[0] == passes[3] == 1 and 1 < passes[1] < 1 + bound
    assert passes[2] == 1 + bound and xreg_g[2] == settings.reg_max


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_riccati_escalation_cases_on_cpu(dtype):
    """chip_smoke's escalation cases on CPU tensors, where the kernel's
    entry takes its plain version: every kind present and the scenarios
    without a retry equal to the one-pass entry bit for bit."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    out = chip_smoke.riccati_escalation_cases(_inputs(dtype))
    assert out["max_abs"] == out["max_rel"] == 0.0
    assert out["bitwise"] == sum(p == 1 for p in out["passes"]) >= 4
