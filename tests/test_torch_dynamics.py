"""The PyTorch port's Lie-group, state-manifold, spatial and rigid-body
functions against the JAX package, at random states of the flagship
(hexacopter370_flying_arm_3, nj=3) and iris (nj=0), float64 on the CPU.

Tolerance: 1e-12 absolute on unit-scale quantities; dynamics outputs (up
to ~20 in magnitude) are held to 1e-12 relative to their largest entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_mpc_tpu.dynamics import lie as jlie
from eagle_mpc_tpu.dynamics import rbd as jrbd
from eagle_mpc_tpu.dynamics import spatial as jspatial
from eagle_mpc_tpu.dynamics.state import State as JState
from eagle_mpc_tpu_torch import convert
from eagle_mpc_tpu_torch.dynamics import lie, rbd, spatial
from eagle_mpc_tpu_torch.dynamics.state import State
from eagle_mpc_tpu_torch.ops import smallmat

from torch_port_util import load, rand_states, rel_err, t

ATOL = 1e-12
N = 16
MISSION = {"hexacopter370_flying_arm_3": "displacement", "iris": "hover"}


def _close(jax_val, torch_val, atol=ATOL):
    np.testing.assert_allclose(torch_val.numpy(), np.asarray(jax_val),
                               rtol=0, atol=atol)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(7)


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_quaternion_ops(rng):
    q1, q2 = _unit_quats(rng, N), _unit_quats(rng, N)
    v = rng.normal(size=(N, 3))
    _close(jlie.quat_mul(q1, q2), lie.quat_mul(t(q1), t(q2)))
    _close(jlie.quat_conj(q1), lie.quat_conj(t(q1)))
    _close(jlie.quat_rotate(q1, v), lie.quat_rotate(t(q1), t(v)))
    _close(jlie.quat_rotate_inv(q1, v), lie.quat_rotate_inv(t(q1), t(v)))
    _close(jlie.quat_to_rot(q1), lie.quat_to_rot(t(q1)))
    _close(jlie.quat_normalize(2.0 * q1), lie.quat_normalize(t(2.0 * q1)))
    _close(jlie.hat(v), lie.hat(t(v)))


@pytest.mark.parametrize("scale", [1e-5, 1.0, 2.5])
def test_exp_log_maps(rng, scale):
    """Rotation vectors and twists on both sides of the Taylor guards."""
    w = rng.normal(size=(N, 3)) * scale
    xi = rng.normal(size=(N, 6)) * scale
    _close(jlie.quat_exp(w), lie.quat_exp(t(w)))
    _close(jlie.exp3(w), lie.exp3(t(w)))
    q = _unit_quats(rng, N)
    _close(jlie.quat_log(q), lie.quat_log(t(q)))
    p_j, q_j = jlie.exp6(xi)
    p_t, q_t = lie.exp6(t(xi))
    _close(p_j, p_t)
    _close(q_j, q_t)
    _close(jlie.log6(p_j, q_j), lie.log6(p_t, q_t))


def test_se3(rng):
    p1, p2 = rng.normal(size=(N, 3)), rng.normal(size=(N, 3))
    q1, q2 = _unit_quats(rng, N), _unit_quats(rng, N)
    for a, b in zip(jlie.se3_mul(p1, q1, p2, q2),
                    lie.se3_mul(t(p1), t(q1), t(p2), t(q2))):
        _close(a, b)
    for a, b in zip(jlie.se3_inv(p1, q1), lie.se3_inv(t(p1), t(q1))):
        _close(a, b)
    alpha = rng.uniform(size=N)
    for a, b in zip(jlie.se3_interpolate(p1, q1, p2, q2, alpha[:, None]),
                    lie.se3_interpolate(t(p1), t(q1), t(p2), t(q2), t(alpha))):
        _close(a, b)


def test_spatial(rng):
    p, m, f = (rng.normal(size=(N, k)) for k in (3, 6, 6))
    R = np.asarray(jlie.quat_to_rot(_unit_quats(rng, N)))
    for name in ("motion_to_parent", "motion_to_child", "force_to_parent",
                 "force_to_child"):
        _close(getattr(jspatial, name)(p, R, m),
               getattr(spatial, name)(t(p), t(R), t(m)))
    _close(jspatial.motion_cross(m, f), spatial.motion_cross(t(m), t(f)))
    _close(jspatial.motion_cross_force(m, f),
           spatial.motion_cross_force(t(m), t(f)))


@pytest.mark.parametrize("robot", ["hexacopter370_flying_arm_3", "iris"])
def test_state_manifold(robot):
    model = load(robot, MISSION[robot])[1].model
    js, ts = JState(model.nq, model.nv), State(model.nq, model.nv)
    x0, x1 = rand_states(model, N, 1), rand_states(model, N, 2)
    dx = np.random.default_rng(3).normal(size=(N, model.ndx))
    _close(js.integrate(x0, dx), ts.integrate(t(x0), t(dx)))
    _close(js.diff(x0, x1), ts.diff(t(x0), t(x1)))
    alpha = np.linspace(0.0, 1.0, N)
    _close(js.interpolate_config(x0[:, :model.nq], x1[:, :model.nq],
                                 alpha[:, None]),
           ts.interpolate_config(t(x0[:, :model.nq]), t(x1[:, :model.nq]),
                                 t(alpha)))


@pytest.mark.parametrize("robot", ["hexacopter370_flying_arm_3", "iris"])
def test_rigid_body_dynamics(robot):
    jmodel = load(robot, MISSION[robot])[1].model
    model = convert.model_from_jax(jmodel)
    nq = model.nq
    x = rand_states(model, 4, 5)
    rng = np.random.default_rng(6)
    a, tau = rng.normal(size=(4, model.nv)), rng.normal(size=(4, model.nv))
    for i in range(x.shape[0]):
        q, v = x[i, :nq], x[i, nq:]
        pairs = [
            (jrbd.rnea(jmodel, jnp.asarray(q), jnp.asarray(v), jnp.asarray(a[i])),
             rbd.rnea(model, t(q), t(v), t(a[i]))),
            (jrbd.bias_force(jmodel, jnp.asarray(q), jnp.asarray(v)),
             rbd.bias_force(model, t(q), t(v))),
            (jrbd.crba(jmodel, jnp.asarray(q)), rbd.crba(model, t(q))),
            (jrbd.fwd_dynamics(jmodel, jnp.asarray(q), jnp.asarray(v),
                               jnp.asarray(tau[i])),
             rbd.fwd_dynamics(model, t(q), t(v), t(tau[i]))),
        ]
        for want, got in pairs:
            assert rel_err(want, got) < 1e-12
    # batched call = per-state calls
    got = rbd.fwd_dynamics(model, t(x[:, :nq]), t(x[:, nq:]), t(tau))
    for i in range(x.shape[0]):
        want = jrbd.fwd_dynamics(jmodel, jnp.asarray(x[i, :nq]),
                                 jnp.asarray(x[i, nq:]), jnp.asarray(tau[i]))
        assert rel_err(want, got[i]) < 1e-12


def test_smallmat_nan_on_non_pd():
    """Cholesky solves return NaN, never raise, where the matrix is not PD
    (the reference's NaN semantics), and solve exactly where it is."""
    rng = np.random.default_rng(8)
    A = rng.normal(size=(3, 5, 5))
    M = A @ np.swapaxes(A, -1, -2) + 5 * np.eye(5)
    M[1] = -M[1]
    b = rng.normal(size=(3, 5))
    x = smallmat.solve_psd(t(M), t(b))
    assert torch.isnan(x[1]).all()
    for i in (0, 2):
        np.testing.assert_allclose(x[i].numpy(), np.linalg.solve(M[i], b[i]),
                                   rtol=1e-12)
    L = smallmat.cholesky(t(M))
    assert torch.isnan(L[1]).all() and torch.isfinite(L[0]).all()
