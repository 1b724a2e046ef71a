"""Operational-frame residuals of the PyTorch port against the JAX package
(float64, CPU): ``costs.residual`` for FRAME_TRANSLATION / ROTATION /
PLACEMENT / VELOCITY on hexacopter370_flying_arm_3's base_link and gripper
frames, and their forward-mode Jacobians where the relative rotation is
exactly the identity.

Each case runs on random states plus two built so that the rotation the
residual takes the log of, Rref' R, is 1e-7 rad and pi - 1e-6 rad from the
identity (the Taylor branch and the quaternion double cover). Values agree
to 1e-12 absolute. There the values are JAX's; the forward-mode Jacobians
at the identity are finite and agree with central differences of the
residual (step 1e-6) to 1e-8 absolute, the differences' own error.
"""

import numpy as np
import pytest
import torch

from eagle_mpc_tpu.dynamics import state as JS
from eagle_mpc_tpu.ocp import costs as JC
from eagle_mpc_tpu_torch.dynamics import lie, rbd
from eagle_mpc_tpu_torch.dynamics.state import State
from eagle_mpc_tpu_torch.ocp import costs as C
from eagle_mpc_tpu_torch.ocp import problem as P

from torch_port_util import F64, load, load_port, rand_states, t

FRAMES = ("hexacopter370__base_link", "flying_arm_3__gripper")
KINDS = (C.FRAME_TRANSLATION, C.FRAME_ROTATION, C.FRAME_PLACEMENT,
         C.FRAME_VELOCITY)
NR = {C.FRAME_TRANSLATION: 3, C.FRAME_ROTATION: 3, C.FRAME_PLACEMENT: 6,
      C.FRAME_VELOCITY: 6}
ANGLES = (1e-7, np.pi - 1e-6)
ATOL = 1e-12


@pytest.fixture(scope="module")
def models():
    return load("hexacopter370_flying_arm_3")[1].model, \
        load_port("hexacopter370_flying_arm_3")[1].model


def _refs(model, fid, kind, x, seed):
    """References for states x (n, nx): random for the first rows; for the
    last len(ANGLES) rows a rotation at the given angle from the frame's."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    p, R = rbd.frame_placement(model, t(x[:, :model.nq]), fid)
    axis = rng.normal(size=(len(ANGLES), 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    w = t(axis * np.array(ANGLES)[:, None])
    # Rref = R exp3(-w), so Rref' R = exp3(w)
    Rref = R[n - len(ANGLES):] @ lie.exp3(-w)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[n - len(ANGLES):] = lie.rot_to_quat(Rref).numpy()
    pos = p.numpy() + rng.normal(size=(n, 3))
    if kind == C.FRAME_TRANSLATION:
        return pos
    if kind == C.FRAME_ROTATION:
        return q
    if kind == C.FRAME_PLACEMENT:
        return np.concatenate([pos, q], axis=-1)
    return rng.normal(size=(n, 6))


def _jax_residual(model, slot, ref, x):
    st = JS.State(model.nq, model.nv)
    cache = JC.build_fk_cache(model, [slot], x[:model.nq], x[model.nq:])
    return JC.residual(model, st, slot, ref, cache, x, None)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("frame", FRAMES)
def test_frame_residual_matches_jax(models, frame, kind):
    jm, tm = models
    fid = tm.frame_id(frame)
    x = rand_states(tm, 5, seed=KINDS.index(kind))
    ref = _refs(tm, fid, kind, x, seed=FRAMES.index(frame))
    rd = ref.shape[-1]
    slot = C.CostSlot("s", kind, C.QUAD, NR[kind], rd, frame_id=fid)
    jslot = JC.CostSlot("s", kind, JC.QUAD, NR[kind], rd, frame_id=fid)
    cache = C.build_fk_cache(tm, [slot], t(x[:, :tm.nq]), t(x[:, tm.nq:]))
    got = C.residual(tm, State(tm.nq, tm.nv), slot, t(ref), cache, t(x), None)
    want = np.stack([np.asarray(_jax_residual(jm, jslot, ref[i], x[i]))
                     for i in range(x.shape[0])])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    if kind in (C.FRAME_ROTATION, C.FRAME_PLACEMENT):
        angle = np.linalg.norm(got.numpy()[-2:, -3:], axis=-1)
        np.testing.assert_allclose(angle, ANGLES, rtol=1e-6)


@pytest.mark.parametrize("kind", (C.FRAME_ROTATION, C.FRAME_PLACEMENT))
def test_frame_jacobian_at_identity_matches_jax(models, kind):
    """The residual's forward-mode Jacobian over the state tangent where
    Rref' R is exactly the identity (a level base against base_level's
    reference): finite, and its central differences; the value zero, as
    JAX's."""
    jm, tm = models
    fid = tm.frame_id(FRAMES[0])
    x = rand_states(tm, 1, seed=7)[0]
    x[3:7] = [0.0, 0.0, 0.0, 1.0]
    ref = np.array([0.0, 0.0, 0.0, 1.0])
    if kind == C.FRAME_PLACEMENT:
        pf = rbd.frame_placement(tm, t(x[:tm.nq]), fid)[0].numpy()
        ref = np.concatenate([pf, ref])
    rd, nr = ref.shape[0], NR[kind]
    slot = C.CostSlot("s", kind, C.QUAD, nr, rd, frame_id=fid)
    jslot = JC.CostSlot("s", kind, JC.QUAD, nr, rd, frame_id=fid)
    st = State(tm.nq, tm.nv)
    spec = P.ProblemSpec(model=tm, nu=0, tau_f=((),) * 6, slots=(slot,),
                         integrator=P.EULER, T=1, dt=0.01, use_squash=False)
    view = P.NodeView(torch.ones(1, dtype=F64), torch.ones(1, dtype=F64),
                      (t(ref),))

    def fun(dx):
        return P._point_residuals(spec, view, st.integrate(t(x), dx), None,
                                  False)[0]

    val, got = P._jacobian(fun, torch.zeros(st.ndx, dtype=F64))
    h, eye = 1e-6, torch.eye(st.ndx, dtype=F64)
    want = torch.stack([(fun(h * e) - fun(-h * e)) / (2 * h) for e in eye],
                       dim=-1)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(val.numpy(), 0.0, rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.asarray(_jax_residual(jm, jslot, ref, x)),
                               0.0, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-8)
