// Device-side model of one node: the free-flyer state manifold, the
// multibody dynamics (tree kinematics, RNEA, CRBA, Cholesky), the contact
// rows and the masked KKT solve of the constrained dynamics, the squash,
// rotor allocation, the symplectic-Euler and RK4 steps, and the cost rows
// of the STATE, CONTROL, operational-frame and friction-cone slots with
// their activations.
//
// Every function is a template on the scalar S (float or double) and on
// the value type V (S, or Dual<S> for forward-mode tangents). Mirrors
// eagle_mpc_tpu_torch/{dynamics,ocp} operation for operation. The robot is
// not compiled in: it arrives in a ModelDesc that the Python wrapper packs
// once per problem spec (ops/_cuda.py mirrors its layout field for field).
//
// One node step (squash, dynamics, Euler) and its running cost are defined
// once, cooperatively: coop_dyn_next at the end of this file, in which a
// group of threads of one warp splits the step (rollout.cu: 8 threads per
// alpha lane; node.cu: the node's warp, for its primal). It runs the
// pieces above it, which the per-thread code (K1's tangents and dual
// columns) calls too. Its dynamics pass alone, coop_dam, is also an RK4
// stage: RK4 runs it at four stage points and combines them with
// rk4_stage.
//
// The larger functions are __noinline__. Fully inlined into the node
// kernel (255 registers, a 12 KB frame per thread in float64), nvcc 12.8
// for sm_90a emitted code whose local arrays overwrote one another: on an
// H100 the state array read back NaN right after the RNEA, at -O3 and at
// -Xcicc -O1 (a larger stack limit did not help), while -G and out-of-line
// calls gave the right result. Each out-of-line function keeps its own
// frame.
#pragma once

#include <cuda_runtime.h>

#include "dual.cuh"

#define EM_MAX_NJ 6
#define EM_MAX_BODIES (EM_MAX_NJ + 1)
#define EM_MAX_NV (6 + EM_MAX_NJ)
#define EM_MAX_NQ (7 + EM_MAX_NJ)
#define EM_MAX_NX (EM_MAX_NQ + EM_MAX_NV)
#define EM_MAX_NDX (2 * EM_MAX_NV)
#define EM_MAX_NU 12
#define EM_MAX_NZ (EM_MAX_NDX + EM_MAX_NU)
#define EM_MAX_SLOTS 12
#define EM_MAX_NR EM_MAX_NDX
#define EM_MAX_CON 2    // contacts
#define EM_MAX_NC 6     // constraint rows of all contacts (one 6-D or two 3-D)
#define EM_CONE_ROWS 5  // rows of a friction-cone slot

#define EM_EPS2 1e-8

enum {
  EM_KIND_STATE = 0,
  EM_KIND_CONTROL = 1,
  EM_KIND_FRAME_PLACEMENT = 2,
  EM_KIND_FRAME_TRANSLATION = 3,
  EM_KIND_FRAME_ROTATION = 4,
  EM_KIND_FRAME_VELOCITY = 5,
  EM_KIND_FRICTION_CONE = 6
};

enum { EM_ACT_QUAD = 0, EM_ACT_WQUAD = 1, EM_ACT_QBARRIER = 2, EM_ACT_WQBARRIER = 3 };
enum { EM_REVOLUTE = 0, EM_PRISMATIC = 1 };
enum { EM_EULER = 0, EM_RK4 = 1 };

// Gauss-Newton structure of a slot: CONTROL residuals are s - ref, the
// identity on s; STATE and the frame slots depend on x alone; a friction
// cone depends on x and s through the contact forces (neither).
__host__ __device__ __forceinline__ bool slot_on_x(int kind) {
  return kind != EM_KIND_CONTROL && kind != EM_KIND_FRICTION_CONE;
}

struct ModelDesc {
  double joint_p[EM_MAX_NJ][3];     // joint placement translation in the parent
  double joint_R[EM_MAX_NJ][9];     // joint placement rotation (row-major)
  double joint_axis[EM_MAX_NJ][3];  // unit axis in the joint frame
  double inertia[EM_MAX_BODIES][36];  // spatial inertia per body (row-major)
  double tau_f[6 * EM_MAX_NU];      // rotor allocation (6, n_rot), row-major
  double gravity;
  double dt;                        // node duration (s)
  double slot_fp[EM_MAX_SLOTS][3];  // frame slots: the frame's translation in its body
  double slot_fR[EM_MAX_SLOTS][9];  // frame slots: the frame's rotation in its body (row-major)
  double slot_cone[EM_MAX_SLOTS][3 * EM_CONE_ROWS];  // cone slots: A (5 x 3, row-major)
  double con_fp[EM_MAX_CON][3];     // contacts: the frame's translation in its body
  double con_fR[EM_MAX_CON][9];     // contacts: the frame's rotation in its body
  double con_gain[EM_MAX_CON][2];   // contacts: Baumgarte gains (kp, kd)
  int parent[EM_MAX_NJ];
  int joint_type[EM_MAX_NJ];
  int nj, nq, nv, nu, n_rot, use_squash;
  int n_slots;
  int n_res;                        // residual rows of all slots
  int node_dim;                     // node parameter row: weight, active, refs
  int glob_dim;                     // global row: smooth, s_lb, s_ub, per slot (w, lb, ub)
  int slot_kind[EM_MAX_SLOTS];
  int slot_act[EM_MAX_SLOTS];
  int slot_nr[EM_MAX_SLOTS];
  int slot_ref_off[EM_MAX_SLOTS];   // offset of the slot's reference in a node row
  int slot_glob_off[EM_MAX_SLOTS];  // offset of the slot's act_w in a global row
  int slot_body[EM_MAX_SLOTS];      // frame slots: the body the frame is fixed to
  int slot_contact[EM_MAX_SLOTS];   // cone slots: the contact of its force, or -1
  int n_con;                        // contacts
  int nc;                           // their constraint rows
  int con_dim[EM_MAX_CON];          // 3 or 6
  int con_body[EM_MAX_CON];         // the body the contact frame is fixed to
  int con_row[EM_MAX_CON];          // first constraint row of each contact
  int con_ref_off[EM_MAX_CON];      // offset of its reference in a node row
  int con_act_off;                  // offset of the contacts' activity in a node row
  int integrator;                   // EM_EULER or EM_RK4
};

// whether a spec takes the kernels' contact path: it has contacts or a
// friction cone (a cone without a contact has zero rows). The kernels are
// instantiated for either path, so a free-flight spec runs code with no
// contact branch in it.
__host__ __device__ inline bool contact_path(const ModelDesc& d) {
  bool cone = false;
  for (int k = 0; k < d.n_slots; ++k) cone = cone || d.slot_kind[k] == EM_KIND_FRICTION_CONE;
  return d.n_con > 0 || cone;
}

// ---------------------------------------------------------------------------
// small vector helpers
// ---------------------------------------------------------------------------

template <class V>
__device__ __forceinline__ void cross3(const V* a, const V* b, V* o) {
  V o0 = a[1] * b[2] - a[2] * b[1];
  V o1 = a[2] * b[0] - a[0] * b[2];
  V o2 = a[0] * b[1] - a[1] * b[0];
  o[0] = o0; o[1] = o1; o[2] = o2;
}

template <class V>
__device__ __forceinline__ V dot3(const V* a, const V* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// o = R v (R row-major 3x3), o = R^T v
template <class V>
__device__ __forceinline__ void mv3(const V* R, const V* v, V* o) {
  V o0 = R[0] * v[0] + R[1] * v[1] + R[2] * v[2];
  V o1 = R[3] * v[0] + R[4] * v[1] + R[5] * v[2];
  V o2 = R[6] * v[0] + R[7] * v[1] + R[8] * v[2];
  o[0] = o0; o[1] = o1; o[2] = o2;
}
template <class V>
__device__ __forceinline__ void mtv3(const V* R, const V* v, V* o) {
  V o0 = R[0] * v[0] + R[3] * v[1] + R[6] * v[2];
  V o1 = R[1] * v[0] + R[4] * v[1] + R[7] * v[2];
  V o2 = R[2] * v[0] + R[5] * v[1] + R[8] * v[2];
  o[0] = o0; o[1] = o1; o[2] = o2;
}

template <class S, class V>
__device__ __forceinline__ V safe_nonzero(V x) {
  return pv(x) < S(EM_EPS2) ? V(S(1)) : x;
}

// ---------------------------------------------------------------------------
// quaternions (x, y, z, w) and SE(3)
// ---------------------------------------------------------------------------

template <class V>
__device__ __forceinline__ void quat_mul(const V* a, const V* b, V* o) {
  V x1 = a[0], y1 = a[1], z1 = a[2], w1 = a[3];
  V x2 = b[0], y2 = b[1], z2 = b[2], w2 = b[3];
  o[0] = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2;
  o[1] = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2;
  o[2] = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2;
  o[3] = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2;
}

// rotation matrix (row-major) of a unit quaternion
template <class S, class V>
__device__ __forceinline__ void quat_to_rot(const V* q, V* R) {
  const V x = q[0], y = q[1], z = q[2], w = q[3];
  R[0] = S(1) - S(2) * (y * y + z * z);
  R[1] = S(2) * (x * y - w * z);
  R[2] = S(2) * (x * z + w * y);
  R[3] = S(2) * (x * y + w * z);
  R[4] = S(1) - S(2) * (x * x + z * z);
  R[5] = S(2) * (y * z - w * x);
  R[6] = S(2) * (x * z - w * y);
  R[7] = S(2) * (y * z + w * x);
  R[8] = S(1) - S(2) * (x * x + y * y);
}

template <class V>
__device__ __forceinline__ void quat_normalize(V* q) {
  V n = vsqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  for (int i = 0; i < 4; ++i) q[i] = q[i] / n;
}

// unit quaternion of a rotation matrix (row-major): Shepperd's method, the
// candidate of the largest of the four diagonal sums (the first on ties),
// whose square root is >= 1
template <class S, class V>
__device__ __noinline__ void rot_to_quat(const V* R, V* q) {
  const V tr = R[0] + R[4] + R[8];
  const V sc[4] = {S(1) + tr, S(1) + R[0] - R[4] - R[8], S(1) - R[0] + R[4] - R[8],
                   S(1) - R[0] - R[4] + R[8]};
  int best = 0;
  for (int i = 1; i < 4; ++i)
    if (pv(sc[i]) > pv(sc[best])) best = i;
  V c[4];
  if (best == 0) {
    c[0] = R[7] - R[5]; c[1] = R[2] - R[6]; c[2] = R[3] - R[1]; c[3] = sc[0];
  } else if (best == 1) {
    c[0] = sc[1]; c[1] = R[1] + R[3]; c[2] = R[2] + R[6]; c[3] = R[7] - R[5];
  } else if (best == 2) {
    c[0] = R[1] + R[3]; c[1] = sc[2]; c[2] = R[5] + R[7]; c[3] = R[2] - R[6];
  } else {
    c[0] = R[2] + R[6]; c[1] = R[5] + R[7]; c[2] = sc[3]; c[3] = R[3] - R[1];
  }
  const V rs = vsqrt(sc[best]);
  for (int i = 0; i < 4; ++i) q[i] = c[i] / rs * S(0.5);
  quat_normalize(q);
}

// o = rotate(q, v) = v + w t + qv x t, t = 2 qv x v
template <class S, class V>
__device__ __forceinline__ void quat_rotate(const V* q, const V* v, V* o) {
  V t[3], c[3];
  cross3(q, v, t);
  for (int i = 0; i < 3; ++i) t[i] = S(2) * t[i];
  cross3(q, t, c);
  for (int i = 0; i < 3; ++i) o[i] = v[i] + q[3] * t[i] + c[i];
}

template <class S, class V>
__device__ __forceinline__ void quat_rotate_inv(const V* q, const V* v, V* o) {
  V qc[4] = {-q[0], -q[1], -q[2], q[3]};
  quat_rotate<S, V>(qc, v, o);
}

template <class S, class V>
__device__ __forceinline__ void quat_exp(const V* w, V* q) {
  V t2 = dot3(w, w);
  V t = vsqrt(safe_nonzero<S, V>(t2));
  bool small = pv(t2) < S(EM_EPS2);
  V sn, cs;
  vsincos(S(0.5) * t, &sn, &cs);
  V sinc_half = small ? S(0.5) - t2 / S(48) : sn / t;
  V cos_half = small ? S(1) - t2 / S(8) : cs;
  q[0] = w[0] * sinc_half; q[1] = w[1] * sinc_half; q[2] = w[2] * sinc_half;
  q[3] = cos_half;
}

template <class S, class V>
__device__ __forceinline__ void quat_log(const V* q, V* w) {
  S sign = pv(q[3]) >= S(0) ? S(1) : S(-1);
  V qv[3] = {q[0] * sign, q[1] * sign, q[2] * sign};
  V qw = q[3] * sign;
  V n2 = dot3(qv, qv);
  V n = vsqrt(safe_nonzero<S, V>(n2));
  V angle = S(2) * vatan2(n, qw);
  V qw_safe = pv(qw) > S(0.5) ? qw : V(S(0.5));
  V small_scale = S(2) / qw_safe * (S(1) - n2 / (S(3) * qw_safe * qw_safe));
  V scale = pv(n2) < S(EM_EPS2) ? small_scale : angle / n;
  for (int i = 0; i < 3; ++i) w[i] = qv[i] * scale;
}

// twist [v, w] -> (p, quat): p = v + b (w x v) + c w x (w x v)
template <class S, class V>
__device__ __forceinline__ void exp6(const V* xi, V* p, V* q) {
  const V* v = xi;
  const V* w = xi + 3;
  V t2 = dot3(w, w);
  V t2s = safe_nonzero<S, V>(t2);
  V t = vsqrt(t2s);
  bool small = pv(t2) < S(EM_EPS2);
  V sn, cs;
  vsincos(t, &sn, &cs);
  V b = small ? S(0.5) - t2 / S(24) : (S(1) - cs) / t2s;
  V c = small ? S(1) / S(6) - t2 / S(120) : (t - sn) / (t2s * t);
  V wv[3], wwv[3];
  cross3(w, v, wv);
  cross3(w, wv, wwv);
  for (int i = 0; i < 3; ++i) p[i] = v[i] + b * wv[i] + c * wwv[i];
  quat_exp<S, V>(w, q);
}

// (p, quat) -> twist [v, w]: v = p - (w x p) / 2 + d w x (w x p)
template <class S, class V>
__device__ __forceinline__ void log6(const V* p, const V* q, V* xi) {
  V w[3];
  quat_log<S, V>(q, w);
  V t2 = dot3(w, w);
  V t2s = safe_nonzero<S, V>(t2);
  V t = vsqrt(t2s);
  bool small = pv(t2) < S(EM_EPS2);
  V half = S(0.5) * t;
  V sn, cs;
  vsincos(half, &sn, &cs);
  V d = small ? S(1) / S(12) + t2 / S(720) : (S(1) - half * cs / sn) / t2s;
  V wp[3], wwp[3];
  cross3(w, p, wp);
  cross3(w, wp, wwp);
  for (int i = 0; i < 3; ++i) xi[i] = p[i] - S(0.5) * wp[i] + d * wwp[i];
  for (int i = 0; i < 3; ++i) xi[3 + i] = w[i];
}

template <class S, class V>
__device__ __forceinline__ void se3_mul(const V* p1, const V* q1, const V* p2,
                                        const V* q2, V* po, V* qo) {
  V r[3], qq[4];
  quat_rotate<S, V>(q1, p2, r);
  quat_mul(q1, q2, qq);
  quat_normalize(qq);
  for (int i = 0; i < 3; ++i) po[i] = p1[i] + r[i];
  for (int i = 0; i < 4; ++i) qo[i] = qq[i];
}

// ---------------------------------------------------------------------------
// state manifold
// ---------------------------------------------------------------------------

template <class S, class V>
__device__ __noinline__ void integrate(const ModelDesc& d, const V* x, const V* dx, V* o) {
  V ep[3], eq[4];
  exp6<S, V>(dx, ep, eq);
  se3_mul<S, V>(x, x + 3, ep, eq, o, o + 3);
  for (int i = 0; i < d.nj; ++i) o[7 + i] = x[7 + i] + dx[6 + i];
  for (int i = 0; i < d.nv; ++i) o[d.nq + i] = x[d.nq + i] + dx[d.nv + i];
}

// o = x1 (-) x0
template <class S, class V>
__device__ __noinline__ void state_diff(const ModelDesc& d, const V* x0, const V* x1, V* o) {
  V iq[4] = {-x0[3], -x0[4], -x0[5], x0[6]};
  V ip[3];
  quat_rotate<S, V>(iq, x0, ip);
  for (int i = 0; i < 3; ++i) ip[i] = -ip[i];
  V dp[3], dq[4];
  se3_mul<S, V>(ip, iq, x1, x1 + 3, dp, dq);
  log6<S, V>(dp, dq, o);
  for (int i = 0; i < d.nj; ++i) o[6 + i] = x1[7 + i] - x0[7 + i];
  for (int i = 0; i < d.nv; ++i) o[d.nv + i] = x1[d.nq + i] - x0[d.nq + i];
}

// ---------------------------------------------------------------------------
// spatial algebra on 6-vectors [linear, angular]
// ---------------------------------------------------------------------------

// v_C = R^T (v - p x w), w_C = R^T w
template <class V>
__device__ __forceinline__ void motion_to_child(const V* p, const V* R, const V* m, V* o) {
  V pxw[3], t[3], vc[3], wc[3];
  cross3(p, m + 3, pxw);
  for (int i = 0; i < 3; ++i) t[i] = m[i] - pxw[i];
  mtv3(R, t, vc);
  mtv3(R, m + 3, wc);
  for (int i = 0; i < 3; ++i) { o[i] = vc[i]; o[3 + i] = wc[i]; }
}

template <class V>
__device__ __forceinline__ void motion_cross(const V* m1, const V* m2, V* o) {
  V a[3], b[3], c[3];
  cross3(m1 + 3, m2, a);
  cross3(m1, m2 + 3, b);
  cross3(m1 + 3, m2 + 3, c);
  for (int i = 0; i < 3; ++i) { o[i] = a[i] + b[i]; o[3 + i] = c[i]; }
}

template <class V>
__device__ __forceinline__ void motion_cross_force(const V* m, const V* f, V* o) {
  V a[3], b[3], c[3];
  cross3(m + 3, f, a);
  cross3(m + 3, f + 3, b);
  cross3(m, f, c);
  for (int i = 0; i < 3; ++i) { o[i] = a[i]; o[3 + i] = b[i] + c[i]; }
}

// f_P = R f_C, tau_P = R tau_C + p x (R f_C)
template <class V>
__device__ __forceinline__ void force_to_parent(const V* p, const V* R, const V* f, V* o) {
  V Rf[3], Rt[3], pxRf[3];
  mv3(R, f, Rf);
  mv3(R, f + 3, Rt);
  cross3(p, Rf, pxRf);
  for (int i = 0; i < 3; ++i) { o[i] = Rf[i]; o[3 + i] = Rt[i] + pxRf[i]; }
}

// ---------------------------------------------------------------------------
// rigid-body dynamics
// ---------------------------------------------------------------------------

template <class V>
struct TreeKin {
  V p[EM_MAX_BODIES][3];      // pose of body b in its parent (b >= 1)
  V R[EM_MAX_BODIES][9];
  V vel[EM_MAX_BODIES][6];    // local spatial velocity
};

// motion subspace of joint j (constants)
template <class S>
__device__ __forceinline__ void joint_subspace(const ModelDesc& d, int j, S* Sj) {
  for (int i = 0; i < 6; ++i) Sj[i] = S(0);
  int off = d.joint_type[j] == EM_REVOLUTE ? 3 : 0;
  for (int i = 0; i < 3; ++i) Sj[off + i] = S(d.joint_axis[j][i]);
}

// pose (p, R) of body j+1 in its parent at joint position qj
template <class S, class V>
__device__ __forceinline__ void joint_placement(const ModelDesc& d, int j, V qj, V* p, V* R) {
  if (d.joint_type[j] == EM_REVOLUTE) {
    // R = jR exp3(axis qj) (Rodrigues, Taylor-guarded), p = jp
    V w[3];
    for (int i = 0; i < 3; ++i) w[i] = S(d.joint_axis[j][i]) * qj;
    V t2 = dot3(w, w);
    V t2s = safe_nonzero<S, V>(t2);
    V t = vsqrt(t2s);
    bool small = pv(t2) < S(EM_EPS2);
    V sn, cs;
    vsincos(t, &sn, &cs);
    V a = small ? S(1) - t2 / S(6) : sn / t;
    V bb = small ? S(0.5) - t2 / S(24) : (S(1) - cs) / t2s;
    V W[9] = {V(S(0)), -w[2], w[1], w[2], V(S(0)), -w[0], -w[1], w[0], V(S(0))};
    V E[9];
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) {
        V w2 = W[3 * r] * W[c] + W[3 * r + 1] * W[3 + c] + W[3 * r + 2] * W[6 + c];
        E[3 * r + c] = S(r == c ? 1 : 0) + a * W[3 * r + c] + bb * w2;
      }
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c)
        R[3 * r + c] = S(d.joint_R[j][3 * r]) * E[c]
                       + S(d.joint_R[j][3 * r + 1]) * E[3 + c]
                       + S(d.joint_R[j][3 * r + 2]) * E[6 + c];
    for (int i = 0; i < 3; ++i) p[i] = V(S(d.joint_p[j][i]));
  } else {
    // R = jR, p = jp + jR (axis qj)
    V ax[3], r[3], Rj[9];
    for (int i = 0; i < 3; ++i) ax[i] = S(d.joint_axis[j][i]) * qj;
    for (int i = 0; i < 9; ++i) Rj[i] = V(S(d.joint_R[j][i]));
    mv3(Rj, ax, r);
    for (int i = 0; i < 3; ++i) p[i] = S(d.joint_p[j][i]) + r[i];
    for (int i = 0; i < 9; ++i) R[i] = Rj[i];
  }
}

// local spatial velocity of body j+1 from its parent's (placements known)
template <class S, class V>
__device__ __forceinline__ void body_velocity(const ModelDesc& d, int j, const V* x, TreeKin<V>& k) {
  const int b = j + 1;
  S Sj[6];
  joint_subspace<S>(d, j, Sj);
  V vc[6];
  motion_to_child(k.p[b], k.R[b], k.vel[d.parent[j]], vc);
  for (int i = 0; i < 6; ++i) k.vel[b][i] = vc[i] + Sj[i] * x[d.nq + 6 + j];
}

// RNEA forward pass: body accelerations (gravity as a base pseudo-
// acceleration)
template <class S, class V>
__device__ __forceinline__ void rnea_forward(const ModelDesc& d, const V* x, const V* a,
                                             const TreeKin<V>& k, V (*acc)[6]) {
  const V* v = x + d.nq;
  V gw[3] = {V(S(0)), V(S(0)), V(S(d.gravity))};
  V g[3];
  quat_rotate_inv<S, V>(x + 3, gw, g);
  for (int i = 0; i < 3; ++i) { acc[0][i] = a[i] + g[i]; acc[0][3 + i] = a[3 + i] + S(0); }
  for (int j = 0; j < d.nj; ++j) {
    const int b = j + 1;
    S Sj[6];
    joint_subspace<S>(d, j, Sj);
    V Svdot[6], ac[6], mc[6];
    for (int i = 0; i < 6; ++i) Svdot[i] = Sj[i] * v[6 + j];
    motion_to_child(k.p[b], k.R[b], acc[d.parent[j]], ac);
    motion_cross(k.vel[b], Svdot, mc);
    for (int i = 0; i < 6; ++i) acc[b][i] = ac[i] + Sj[i] * a[6 + j] + mc[i];
  }
}

// net force of body b: I acc + v x* (I v)
template <class S, class V>
__device__ __forceinline__ void body_force(const ModelDesc& d, int b, const V* acc,
                                           const V* vel, V* f) {
  V Ia[6], Iv[6], cf[6];
  for (int r = 0; r < 6; ++r) {
    V sa = S(d.inertia[b][6 * r]) * acc[0];
    V sv = S(d.inertia[b][6 * r]) * vel[0];
    for (int c = 1; c < 6; ++c) {
      sa = sa + S(d.inertia[b][6 * r + c]) * acc[c];
      sv = sv + S(d.inertia[b][6 * r + c]) * vel[c];
    }
    Ia[r] = sa;
    Iv[r] = sv;
  }
  motion_cross_force(vel, Iv, cf);
  for (int i = 0; i < 6; ++i) f[i] = Ia[i] + cf[i];
}

// RNEA backward pass: joint torques and the base wrench (force is summed
// into in place)
template <class S, class V>
__device__ __forceinline__ void rnea_backward(const ModelDesc& d, const TreeKin<V>& k,
                                              V (*force)[6], V* tau) {
  for (int j = d.nj - 1; j >= 0; --j) {
    const int b = j + 1;
    S Sj[6];
    joint_subspace<S>(d, j, Sj);
    V t = Sj[0] * force[b][0];
    for (int i = 1; i < 6; ++i) t = t + Sj[i] * force[b][i];
    tau[6 + j] = t;
    V fp[6];
    force_to_parent(k.p[b], k.R[b], force[b], fp);
    const int par = d.parent[j];
    for (int i = 0; i < 6; ++i) force[par][i] = force[par][i] + fp[i];
  }
  for (int i = 0; i < 6; ++i) tau[i] = force[0][i];
}

// entry e (row-major) of X = [[R^T, -R^T hat(p)], [0, R^T]], the motion
// transform from a parent to the child at pose (p, R)
template <class S, class V>
__device__ __forceinline__ V xform_entry(const V* R, const V* p, int e) {
  const int r = e / 6, c = e % 6;
  if (r >= 3 && c < 3) return V(S(0));
  if (r < 3 && c >= 3) {
    const int cc = c - 3;
    V hp[9] = {V(S(0)), -p[2], p[1], p[2], V(S(0)), -p[0], -p[1], p[0], V(S(0))};
    return -(R[r] * hp[cc] + R[3 + r] * hp[3 + cc] + R[6 + r] * hp[6 + cc]);
  }
  const int rr = r % 3, c3 = c % 3;
  return R[3 * c3 + rr];
}

// row and column 6+j of M from the composite inertias (stride EM_MAX_NV);
// the entries of different joints are disjoint
template <class S, class V>
__device__ __forceinline__ void crba_joint_column(const ModelDesc& d, int j, const TreeKin<V>& k,
                                                  V (*Ic)[36], V* M) {
  const int b = j + 1;
  S Sj[6];
  joint_subspace<S>(d, j, Sj);
  V F[6];
  for (int r = 0; r < 6; ++r) {
    V s = Ic[b][6 * r] * Sj[0];
    for (int c = 1; c < 6; ++c) s = s + Ic[b][6 * r + c] * Sj[c];
    F[r] = s;
  }
  V e = Sj[0] * F[0];
  for (int i = 1; i < 6; ++i) e = e + Sj[i] * F[i];
  M[EM_MAX_NV * (6 + j) + 6 + j] = e;
  int body = b;
  while (body != 0) {
    V Fp[6];
    force_to_parent(k.p[body], k.R[body], F, Fp);
    for (int i = 0; i < 6; ++i) F[i] = Fp[i];
    body = d.parent[body - 1];
    if (body != 0) {
      S Sb[6];
      joint_subspace<S>(d, body - 1, Sb);
      V eb = Sb[0] * F[0];
      for (int i = 1; i < 6; ++i) eb = eb + Sb[i] * F[i];
      M[EM_MAX_NV * (6 + j) + 6 + body - 1] = eb;
      M[EM_MAX_NV * (6 + body - 1) + 6 + j] = eb;
    }
  }
  for (int c = 0; c < 6; ++c) {
    M[EM_MAX_NV * (6 + j) + c] = F[c];
    M[EM_MAX_NV * c + 6 + j] = F[c];
  }
}

// in place: b -> (L L^T)^{-1} b
template <class V>
__device__ __noinline__ void chol_solve(const V* L, int n, int stride, V* b) {
  for (int i = 0; i < n; ++i) {
    V acc = b[i];
    for (int k = 0; k < i; ++k) acc = acc - L[stride * i + k] * b[k];
    b[i] = acc / L[stride * i + i];
  }
  for (int i = n - 1; i >= 0; --i) {
    V acc = b[i];
    for (int k = i + 1; k < n; ++k) acc = acc - L[stride * k + i] * b[k];
    b[i] = acc / L[stride * i + i];
  }
}

// in place: the lower Cholesky factor of the n x n matrix A (stride
// `stride`); a non-PD pivot gives NaN, which spreads to every later entry
template <class S>
__device__ __noinline__ void chol_factor(S* A, int n, int stride) {
  for (int j = 0; j < n; ++j) {
    S dj = A[stride * j + j];
    for (int k = 0; k < j; ++k) dj = dj - A[stride * j + k] * A[stride * j + k];
    dj = vsqrt(dj);
    A[stride * j + j] = dj;
    for (int i = j + 1; i < n; ++i) {
      S s = A[stride * i + j];
      for (int k = 0; k < j; ++k) s = s - A[stride * i + k] * A[stride * j + k];
      A[stride * i + j] = s / dj;
    }
  }
}

// ---------------------------------------------------------------------------
// contacts
// ---------------------------------------------------------------------------

// The rows of contact c at x, as problem._contact_rows computes them, from
// x alone: the LOCAL frame Jacobian J (dim x nv, row stride EM_MAX_NV;
// column i is the frame's velocity at v = e_i), a0 (dim) and the frame's
// world rotation Rf (9). a0 is the drift (the frame's LOCAL spatial
// acceleration at zero joint acceleration, without gravity: RNEA's forward
// pass with a_0 = 0, a_i = X_i a_parent + v_i x S_i qd_i) plus Baumgarte:
// 3-D, the linear rows + w x v + kp Rf^T (p - ref) + kd v; 6-D, all rows +
// kp log6(Rref^T (p - pref), Rref^T Rf) + kd (v, w). np: node parameter row.
template <class S, class V>
__device__ __noinline__ void contact_rows(const ModelDesc& d, int c, const V* x, const S* np,
                                          V* J, V* a0, V* Rf) {
  const int body = d.con_body[c], dim = d.con_dim[c], nv = d.nv, nq = d.nq;
  V p[EM_MAX_BODIES][3], R[EM_MAX_BODIES][9];
  V pw[EM_MAX_BODIES][3], Rw[EM_MAX_BODIES][9];
  V vel[EM_MAX_BODIES][6], acc[EM_MAX_BODIES][6];
  for (int i = 0; i < 3; ++i) pw[0][i] = x[i];
  quat_to_rot<S, V>(x + 3, Rw[0]);
  for (int i = 0; i < 6; ++i) {
    vel[0][i] = x[nq + i];
    acc[0][i] = V(S(0));
  }
  for (int j = 0; j + 1 <= body; ++j) {
    const int b = j + 1, par = d.parent[j];
    joint_placement<S, V>(d, j, x[7 + j], p[b], R[b]);
    V r[3];
    mv3(Rw[par], p[b], r);
    for (int i = 0; i < 3; ++i) pw[b][i] = pw[par][i] + r[i];
    for (int rr = 0; rr < 3; ++rr)
      for (int cc = 0; cc < 3; ++cc)
        Rw[b][3 * rr + cc] = Rw[par][3 * rr] * R[b][cc] + Rw[par][3 * rr + 1] * R[b][3 + cc]
                             + Rw[par][3 * rr + 2] * R[b][6 + cc];
    S Sj[6];
    joint_subspace<S>(d, j, Sj);
    V vc[6], ac[6], Svd[6], mc[6];
    motion_to_child(p[b], R[b], vel[par], vc);
    for (int i = 0; i < 6; ++i) vel[b][i] = vc[i] + Sj[i] * x[nq + 6 + j];
    for (int i = 0; i < 6; ++i) Svd[i] = Sj[i] * x[nq + 6 + j];
    motion_to_child(p[b], R[b], acc[par], ac);
    motion_cross(vel[b], Svd, mc);
    for (int i = 0; i < 6; ++i) acc[b][i] = ac[i] + mc[i];
  }
  V fp[3], fR[9], vf[6], drift[6], pf[3];
  for (int i = 0; i < 3; ++i) fp[i] = V(S(d.con_fp[c][i]));
  for (int i = 0; i < 9; ++i) fR[i] = V(S(d.con_fR[c][i]));
  motion_to_child(fp, fR, vel[body], vf);
  motion_to_child(fp, fR, acc[body], drift);
  mv3(Rw[body], fp, pf);
  for (int i = 0; i < 3; ++i) pf[i] = pw[body][i] + pf[i];
  for (int rr = 0; rr < 3; ++rr)
    for (int cc = 0; cc < 3; ++cc)
      Rf[3 * rr + cc] = Rw[body][3 * rr] * fR[cc] + Rw[body][3 * rr + 1] * fR[3 + cc]
                        + Rw[body][3 * rr + 2] * fR[6 + cc];
  // the Jacobian, a column per unit velocity (vel and acc reused as scratch)
  for (int i = 0; i < nv; ++i) {
    for (int r = 0; r < 6; ++r) vel[0][r] = V(S(i == r ? 1 : 0));
    for (int j = 0; j + 1 <= body; ++j) {
      const int b = j + 1;
      S Sj[6];
      joint_subspace<S>(d, j, Sj);
      motion_to_child(p[b], R[b], vel[d.parent[j]], vel[b]);
      if (i == 6 + j)
        for (int r = 0; r < 6; ++r) vel[b][r] = vel[b][r] + Sj[r];
    }
    motion_to_child(fp, fR, vel[body], acc[0]);
    for (int r = 0; r < dim; ++r) J[EM_MAX_NV * r + i] = acc[0][r];
  }
  const S kp = S(d.con_gain[c][0]), kd = S(d.con_gain[c][1]);
  const S* ref = np + d.con_ref_off[c];
  if (dim == 3) {
    V wv[3], e[3], le[3];
    cross3(vf + 3, vf, wv);
    for (int i = 0; i < 3; ++i) e[i] = pf[i] - ref[i];
    mtv3(Rf, e, le);
    for (int i = 0; i < 3; ++i) a0[i] = drift[i] + wv[i] + kp * le[i] + kd * vf[i];
  } else {
    S Rref[9];
    quat_to_rot<S, S>(ref + 3, Rref);
    V Rrel[9], q[4], dp[3], t[3], err[6];
    for (int rr = 0; rr < 3; ++rr)
      for (int cc = 0; cc < 3; ++cc)
        Rrel[3 * rr + cc] = Rref[rr] * Rf[cc] + Rref[3 + rr] * Rf[3 + cc] + Rref[6 + rr] * Rf[6 + cc];
    rot_to_quat<S, V>(Rrel, q);
    for (int i = 0; i < 3; ++i) dp[i] = pf[i] - ref[i];
    for (int i = 0; i < 3; ++i) t[i] = Rref[i] * dp[0] + Rref[3 + i] * dp[1] + Rref[6 + i] * dp[2];
    log6<S, V>(t, q, err);
    for (int i = 0; i < 6; ++i) a0[i] = drift[i] + kp * err[i] + kd * vf[i];
  }
}

// r = A fw, A the matrix of friction-cone slot k, fw a world-frame force
template <class S, class V>
__device__ __forceinline__ void cone_apply(const ModelDesc& d, int k, const V* fw, V* r) {
  for (int i = 0; i < EM_CONE_ROWS; ++i)
    r[i] = S(d.slot_cone[k][3 * i]) * fw[0] + S(d.slot_cone[k][3 * i + 1]) * fw[1]
           + S(d.slot_cone[k][3 * i + 2]) * fw[2];
}

// rows of friction-cone slot k: A (Rf f), f the first three multipliers of
// its contact (lam: that contact's rows), Rf its frame's world rotation
template <class S, class V>
__device__ __forceinline__ void cone_rows(const ModelDesc& d, int k, const V* Rf, const V* lam,
                                          V* r) {
  V fw[3];
  mv3(Rf, lam, fw);
  cone_apply<S, V>(d, k, fw, r);
}

// ---------------------------------------------------------------------------
// the node: squash -> allocation -> free dynamics -> symplectic Euler
// ---------------------------------------------------------------------------

// plant-facing control i of s (the squash, when the spec has one);
// gp: global parameter row [smooth, s_lb (nu), s_ub (nu), ...]
template <class S, class V>
__device__ __forceinline__ V control_u(const ModelDesc& d, int i, V si, const S* gp) {
  if (!d.use_squash) return si;
  const S smooth = gp[0];
  const S lb = gp[1 + i], ub = gp[1 + d.nu + i];
  const S dd = smooth * (ub - lb);
  const S a2 = dd * dd;
  V slo = si - lb, shi = si - ub;
  return S(0.5) * (vsqrt(a2 + slo * slo) - vsqrt(a2 + shi * shi) + lb + ub);
}

// generalized force row r from the plant-facing controls u: the rotor
// allocation for the base wrench, the joint torques as they are
template <class S, class V>
__device__ __forceinline__ V alloc_row(const ModelDesc& d, int r, const V* u) {
  if (r >= 6) return u[d.n_rot + r - 6];
  V acc = S(d.tau_f[r * d.n_rot]) * u[0];
  for (int c = 1; c < d.n_rot; ++c) acc = acc + S(d.tau_f[r * d.n_rot + c]) * u[c];
  return acc;
}

// tau(s): squash, then allocation
template <class S, class V>
__device__ __noinline__ void control_tau(const ModelDesc& d, const V* s, const S* gp, V* tau) {
  V u[EM_MAX_NU];
  for (int i = 0; i < d.nu; ++i) u[i] = control_u<S, V>(d, i, s[i], gp);
  for (int r = 0; r < d.nv; ++r) tau[r] = alloc_row<S, V>(d, r, u);
}

// symplectic Euler: xn = x (+) dx, dx = [(v + a dt) dt, a dt] (ndx scratch)
template <class S, class V>
__device__ __noinline__ void euler_next(const ModelDesc& d, const V* x, const V* a, V* xn,
                                        V* dx) {
  const int nv = d.nv;
  const S dt = S(d.dt);
  for (int i = 0; i < nv; ++i) {
    dx[i] = (x[d.nq + i] + a[i] * dt) * dt;
    dx[nv + i] = a[i] * dt;
  }
  integrate<S, V>(d, x, dx, xn);
}

// RK4 on the state manifold (crocoddyl's IAM RK4, problem._stage_points):
// stage i = 0..3 at y_i with the acceleration a_i gives k_i = [v(y_i), a_i];
// the next stage point is y_{i+1} = x (+) k_i h_i (h = dt/2, dt/2, dt) and
// after stage 3 xnext = x (+) (k0 + 2 k1 + 2 k2 + k3) dt/6. ksum carries
// that sum; ynext (which may be y) gets y_{i+1}, or xnext after stage 3.
// The running cost's quadrature coefficient of stage i is rk4_coeff.
__host__ __device__ inline double rk4_coeff(const ModelDesc& d, int i) {
  return i == 0 || i == 3 ? d.dt / 6 : d.dt / 3;
}

template <class S>
__device__ __noinline__ void rk4_stage(const ModelDesc& d, int i, const S* x, const S* y,
                                       const S* a, S* ksum, S* ynext) {
  const int nv = d.nv, ndx = 2 * nv;
  S k[EM_MAX_NDX];
  for (int c = 0; c < nv; ++c) {
    k[c] = y[d.nq + c];
    k[nv + c] = a[c];
  }
  for (int c = 0; c < ndx; ++c)
    ksum[c] = i == 0 ? k[c] : (i == 3 ? ksum[c] + k[c] : ksum[c] + S(2) * k[c]);
  const S h = i == 3 ? S(d.dt / 6) : (i == 2 ? S(d.dt) : S(d.dt / 2));
  for (int c = 0; c < ndx; ++c) k[c] = (i == 3 ? ksum[c] : k[c]) * h;
  integrate<S, S>(d, x, k, ynext);
}

// ---------------------------------------------------------------------------
// operational frames
// ---------------------------------------------------------------------------

// world poses (p, R) or local spatial velocities of the bodies on the chain
// from the base to body `body` (bodies come parent before child, so its
// ancestors have smaller indices)
template <class V>
struct FrameKin {
  V p[EM_MAX_BODIES][3];
  V R[EM_MAX_BODIES][9];
  V vel[EM_MAX_BODIES][6];
};

template <class S, class V>
__device__ __noinline__ void frame_kinematics(const ModelDesc& d, const V* x, int body, bool vel,
                                              FrameKin<V>& f) {
  if (vel)
    for (int i = 0; i < 6; ++i) f.vel[0][i] = x[d.nq + i];
  else {
    for (int i = 0; i < 3; ++i) f.p[0][i] = x[i];
    quat_to_rot<S, V>(x + 3, f.R[0]);
  }
  for (int j = 0; j + 1 <= body; ++j) {
    const int b = j + 1, par = d.parent[j];
    V pj[3], Rj[9];
    joint_placement<S, V>(d, j, x[7 + j], pj, Rj);
    if (vel) {
      S Sj[6];
      joint_subspace<S>(d, j, Sj);
      V vc[6];
      motion_to_child(pj, Rj, f.vel[par], vc);
      for (int i = 0; i < 6; ++i) f.vel[b][i] = vc[i] + Sj[i] * x[d.nq + 6 + j];
    } else {
      V r[3];
      mv3(f.R[par], pj, r);
      for (int i = 0; i < 3; ++i) f.p[b][i] = f.p[par][i] + r[i];
      for (int rr = 0; rr < 3; ++rr)
        for (int c = 0; c < 3; ++c)
          f.R[b][3 * rr + c] = f.R[par][3 * rr] * Rj[c] + f.R[par][3 * rr + 1] * Rj[3 + c]
                               + f.R[par][3 * rr + 2] * Rj[6 + c];
    }
  }
}

// residual rows of frame slot k at x (ref: its reference), as
// costs.residual computes them: translation p - ref; rotation
// log3(Rref' R); placement log6(Rref' (p - pref), Rref' R); velocity the
// frame's local velocity - ref. log3 goes through the quaternion, whose log
// takes the short way and its Taylor branch before any square root.
template <class S, class V>
__device__ __noinline__ void frame_residual(const ModelDesc& d, int k, const V* x, const S* ref,
                                            V* r) {
  const int kind = d.slot_kind[k], body = d.slot_body[k];
  FrameKin<V> f;
  frame_kinematics<S, V>(d, x, body, kind == EM_KIND_FRAME_VELOCITY, f);
  V fp[3], fR[9];
  for (int i = 0; i < 3; ++i) fp[i] = V(S(d.slot_fp[k][i]));
  for (int i = 0; i < 9; ++i) fR[i] = V(S(d.slot_fR[k][i]));
  if (kind == EM_KIND_FRAME_VELOCITY) {
    V vf[6];
    motion_to_child(fp, fR, f.vel[body], vf);
    for (int i = 0; i < 6; ++i) r[i] = vf[i] - ref[i];
    return;
  }
  // the frame's world pose
  V pw[3], Rw[9];
  mv3(f.R[body], fp, pw);
  for (int i = 0; i < 3; ++i) pw[i] = f.p[body][i] + pw[i];
  for (int rr = 0; rr < 3; ++rr)
    for (int c = 0; c < 3; ++c)
      Rw[3 * rr + c] = f.R[body][3 * rr] * fR[c] + f.R[body][3 * rr + 1] * fR[3 + c]
                       + f.R[body][3 * rr + 2] * fR[6 + c];
  if (kind == EM_KIND_FRAME_TRANSLATION) {
    for (int i = 0; i < 3; ++i) r[i] = pw[i] - ref[i];
    return;
  }
  // the pose relative to the reference: Rref' (p - pref), Rref' R
  const S* qref = kind == EM_KIND_FRAME_ROTATION ? ref : ref + 3;
  S Rref[9];
  quat_to_rot<S, S>(qref, Rref);
  V Rrel[9], q[4];
  for (int rr = 0; rr < 3; ++rr)
    for (int c = 0; c < 3; ++c)
      Rrel[3 * rr + c] = Rref[rr] * Rw[c] + Rref[3 + rr] * Rw[3 + c] + Rref[6 + rr] * Rw[6 + c];
  rot_to_quat<S, V>(Rrel, q);
  if (kind == EM_KIND_FRAME_ROTATION) {
    quat_log<S, V>(q, r);
    return;
  }
  V dp[3], t[3];
  for (int i = 0; i < 3; ++i) dp[i] = pw[i] - ref[i];
  for (int i = 0; i < 3; ++i) t[i] = Rref[i] * dp[0] + Rref[3 + i] * dp[1] + Rref[6 + i] * dp[2];
  log6<S, V>(t, q, r);
}

// residual rows of slot k at (x, s); np: node parameter row. A frame slot
// computes the kinematics it needs from x itself, so a thread may take it
// before the node's own tree pass has run. Not for a friction cone, whose
// rows need the contact forces (cone_rows).
template <class S, class V>
__device__ __noinline__ void slot_residual(const ModelDesc& d, int k, const V* x, const V* s,
                              const S* np, V* r) {
  const S* ref = np + d.slot_ref_off[k];
  if (d.slot_kind[k] == EM_KIND_STATE) {
    V xr[EM_MAX_NX];
    for (int i = 0; i < d.nq + d.nv; ++i) xr[i] = V(ref[i]);
    state_diff<S, V>(d, xr, x, r);
  } else if (d.slot_kind[k] == EM_KIND_CONTROL) {
    for (int i = 0; i < d.nu; ++i) r[i] = s[i] - ref[i];
  } else {
    frame_residual<S, V>(d, k, x, ref, r);
  }
}

// one row of an activation at residual value r: returns its share of
// 2 a and sets A_r, A_rr (barriers: min(r - lb, 0) + max(r - ub, 0),
// NaN-propagating like jnp)
template <class S>
__device__ __forceinline__ S activation_row(int kind, S r, S w, S lb, S ub, S& Ar, S& Arr) {
  if (kind == EM_ACT_QUAD) {
    Ar = r;
    Arr = S(1);
    return r * r;
  }
  if (kind == EM_ACT_WQUAD) {
    S wr = w * r;
    Ar = wr;
    Arr = w;
    return wr * r;
  }
  S lo = r - lb, hi = r - ub;
  S viol = (lo > S(0) ? S(0) : lo) + (hi < S(0) ? S(0) : hi);
  S mask = viol != S(0) ? S(1) : S(0);
  if (kind == EM_ACT_QBARRIER) {
    Ar = viol;
    Arr = mask;
    return viol * viol;
  }
  Ar = w * viol;
  Arr = w * mask;
  return w * viol * viol;
}

// activation of slot k on its residual values r: a; with wA / wAA given,
// also w_k A_r and w_k A_rr per row
template <class S>
__device__ __forceinline__ S activation(const ModelDesc& d, int k, const S* r, const S* gp,
                                        S wk = S(0), S* wA = nullptr, S* wAA = nullptr) {
  const int nr = d.slot_nr[k];
  const int kind = d.slot_act[k];
  const S* w = gp + d.slot_glob_off[k];
  const S* lb = w + nr;
  const S* ub = lb + nr;
  S a = S(0);
  for (int i = 0; i < nr; ++i) {
    S Ar, Arr;
    a = a + activation_row<S>(kind, r[i], w[i], lb[i], ub[i], Ar, Arr);
    if (wA) {
      wA[i] = wk * Ar;
      wAA[i] = wk * Arr;
    }
  }
  return S(0.5) * a;
}

// weight_k active_k a_k of slot k at (x, s); r: scratch for its residual
template <class S>
__device__ __noinline__ S slot_cost(const ModelDesc& d, int k, const S* x, const S* s,
                                    const S* np, const S* gp, S* r) {
  slot_residual<S, S>(d, k, x, s, np, r);
  return np[k] * np[d.n_slots + k] * activation<S>(d, k, r, gp);
}

// the same for friction-cone slot k, from the contact forces lam and the
// contact frames' world rotations Rf (zero rows without a contact)
template <class S>
__device__ __noinline__ S cone_cost(const ModelDesc& d, int k, const S* lam, const S (*Rf)[9],
                                    const S* np, const S* gp, S* r) {
  const int c = d.slot_contact[k];
  if (c < 0)
    for (int i = 0; i < EM_CONE_ROWS; ++i) r[i] = S(0);
  else
    cone_rows<S, S>(d, k, Rf[c], lam + d.con_row[c], r);
  return np[k] * np[d.n_slots + k] * activation<S>(d, k, r, gp);
}


// ---------------------------------------------------------------------------
// the cooperative node step
// ---------------------------------------------------------------------------
//
// coop_dyn_next is the node step of the plain version (problem.node_calc:
// squash, CRBA + Cholesky forward dynamics, the masked KKT solve of a
// contact spec, symplectic Euler, the running cost) split over a group of
// G threads of one warp, with its working set in shared memory (CoopNode,
// and CoopContact on the contact path CON only: a free-flight spec
// allocates none, and its instantiation has no contact code). rollout.cu runs it per alpha lane
// (G = 8); node.cu runs it for the primal of a node (G = 32). Thread l of a
// group is l in [0, G); every thread of the warp passes the same barriers.

#define EM_BASE_NDX 6   // tangent dimension of the free-flyer base
#define EM_COST_ROWS 8  // threads of a group that take slot costs (after the first)

template <class S>
struct CoopNode {
  S xc[EM_MAX_NX];         // out: the state after the step
  S xt[EM_MAX_NX];         // in: the state
  S dx[EM_MAX_NDX];        // (rollout) x_t^-1 x_try
  S u[EM_MAX_NU];          // in: s
  S usq[EM_MAX_NU];        // in: the plant-facing controls
  S rhs[EM_MAX_NV];        // tau, then tau - bias, then out: the acceleration
  TreeKin<S> k;
  S acc[EM_MAX_BODIES][6];
  S force[EM_MAX_BODIES][6];
  S Ic[EM_MAX_BODIES][36];
  S X[36];
  S IX[36];
  S M[EM_MAX_NV * EM_MAX_NV];   // out: the Cholesky factor of M (lower, stride EM_MAX_NV)
  S ck[EM_MAX_SLOTS];      // weighted slot costs
  S res[EM_COST_ROWS][EM_MAX_NR];  // slot residuals, a row per cost thread
  S tmp[EM_MAX_NDX];       // scratch of the first thread
  S inc[EM_MAX_NDX];       // the Euler increment
};

// the constrained dynamics' working set: G = Jm M^-1 Jm^T + diag(1 - act),
// lam = -G^-1 (Jm a_free + act a0), a = a_free + M^-1 Jm^T lam
template <class S>
struct CoopContact {
  S J[EM_MAX_NC][EM_MAX_NV];    // the masked rows Jm = act J
  S MJ[EM_MAX_NC][EM_MAX_NV];   // M^-1 Jm^T, a row per constraint row
  S G[EM_MAX_NC * EM_MAX_NC];   // G, then its Cholesky factor (stride EM_MAX_NC)
  S a0[EM_MAX_NC];
  S act[EM_MAX_NC];             // each row's activity
  S lam[EM_MAX_NC];             // the multipliers (the LOCAL contact forces)
  S Rf[EM_MAX_CON][9];          // each contact frame's world rotation
  S free[EM_MAX_NV];            // the unconstrained acceleration
};

// the rows of the contacts given to thread l of G (those of the last
// threads, which the body forces leave idle), masked by their activity
template <class S, int G>
__device__ __forceinline__ void coop_contact_rows(const ModelDesc& d, int l, const S* x,
                                                  const S* np, CoopContact<S>& C) {
  for (int c = G - 1 - l; c >= 0 && c < d.n_con; c += G) {
    const int r0 = d.con_row[c], dim = d.con_dim[c];
    contact_rows<S, S>(d, c, x, np, C.J[r0], C.a0 + r0, C.Rf[c]);
    const S a = np[d.con_act_off + c];
    for (int r = r0; r < r0 + dim; ++r) {
      C.act[r] = a;
      for (int i = 0; i < d.nv; ++i) C.J[r][i] = a * C.J[r][i];
    }
  }
}

// one thread, after a_free (in C.free) and C.MJ: the Schur complement and
// its factor, the multipliers and the constrained acceleration into rhs
template <class S>
__device__ __noinline__ void contact_solve(const ModelDesc& d, CoopNode<S>& W,
                                           CoopContact<S>& C) {
  const int nc = d.nc, nv = d.nv;
  for (int i = 0; i < nc; ++i)
    for (int k = 0; k <= i; ++k) {
      S s = C.J[i][0] * C.MJ[k][0];
      for (int m = 1; m < nv; ++m) s = s + C.J[i][m] * C.MJ[k][m];
      C.G[EM_MAX_NC * i + k] = i == k ? s + (S(1) - C.act[i]) : s;
    }
  chol_factor(C.G, nc, EM_MAX_NC);
  for (int i = 0; i < nc; ++i) {
    S s = C.J[i][0] * C.free[0];
    for (int m = 1; m < nv; ++m) s = s + C.J[i][m] * C.free[m];
    C.lam[i] = s + C.act[i] * C.a0[i];
  }
  chol_solve(C.G, nc, EM_MAX_NC, C.lam);
  for (int i = 0; i < nc; ++i) C.lam[i] = -C.lam[i];
  for (int m = 0; m < nv; ++m) {
    S s = C.free[m];
    for (int i = 0; i < nc; ++i) s = s + C.MJ[i][m] * C.lam[i];
    W.rhs[m] = s;
  }
}

// body velocities and bias accelerations down the tree (placements known)
template <class S>
__device__ __noinline__ void coop_tree_down(const ModelDesc& d, CoopNode<S>& W) {
  for (int i = 0; i < 6; ++i) W.k.vel[0][i] = W.xt[d.nq + i];
  for (int j = 0; j < d.nj; ++j) body_velocity<S, S>(d, j, W.xt, W.k);
  for (int i = 0; i < d.nv; ++i) W.tmp[i] = S(0);
  rnea_forward<S, S>(d, W.xt, W.tmp, W.k, W.acc);
}

// bias forces up the tree: rhs = tau - b(q, v)
template <class S>
__device__ __noinline__ void coop_tree_up(const ModelDesc& d, CoopNode<S>& W) {
  rnea_backward<S, S>(d, W.k, W.force, W.tmp);
  for (int i = 0; i < d.nv; ++i) W.rhs[i] = W.rhs[i] - W.tmp[i];
}

// the weighted slot costs of a pass, summed in slot order
template <class S>
__device__ __forceinline__ S coop_cost_sum(const ModelDesc& d, const CoopNode<S>& W) {
  S total = S(0);
  for (int k = 0; k < d.n_slots; ++k) total = total + W.ck[k];
  return total;
}

// the cooperative dynamics at (xt, usq): the acceleration into rhs and the
// Cholesky factor of M into M (and, with contacts, the rows, the
// multipliers and G's factor into C). np: the node parameter row (a
// contact spec reads its contacts' activity and references there). With
// cost, also each slot's weighted cost at (xt, u) into ck: a slot per
// thread on the threads that the chain down the tree leaves idle; a
// friction cone by the first thread once the forces are known.
template <class S, int G, bool CON>
__device__ __forceinline__ void coop_dam(const ModelDesc& d, int l, CoopNode<S>& W,
                                         CoopContact<S>* C, const S* np, const S* gp,
                                         bool cost) {
  const int nv = d.nv, nj = d.nj;
  for (int r = l; r < nv; r += G) W.rhs[r] = alloc_row<S, S>(d, r, W.usq);
  for (int j = l; j < nj; j += G)
    joint_placement<S, S>(d, j, W.xt[7 + j], W.k.p[j + 1], W.k.R[j + 1]);
  __syncwarp();
  if (l == 0)
    coop_tree_down<S>(d, W);
  else if (cost && l <= EM_COST_ROWS)
    for (int k = l - 1; k < d.n_slots; k += min(G - 1, EM_COST_ROWS))
      if (!CON || d.slot_kind[k] != EM_KIND_FRICTION_CONE)
        W.ck[k] = slot_cost<S>(d, k, W.xt, W.u, np, gp, W.res[l - 1]);
  __syncwarp();
  for (int b = l; b <= nj; b += G) body_force<S, S>(d, b, W.acc[b], W.k.vel[b], W.force[b]);
  for (int e = l; e < 36 * (nj + 1); e += G) W.Ic[e / 36][e % 36] = S(d.inertia[e / 36][e % 36]);
  if constexpr (CON) coop_contact_rows<S, G>(d, l, W.xt, np, *C);
  __syncwarp();
  if (l == 0) coop_tree_up<S>(d, W);
  // CRBA: the composite inertia of each body into its parent's, X^T Ic X
  for (int j = nj - 1; j >= 0; --j) {
    const int b = j + 1, par = d.parent[j];
    for (int e = l; e < 36; e += G) W.X[e] = xform_entry<S, S>(W.k.R[b], W.k.p[b], e);
    __syncwarp();
    for (int e = l; e < 36; e += G) {
      const int r = e / 6, c = e % 6;
      S s = W.Ic[b][6 * r] * W.X[c];
      for (int m = 1; m < 6; ++m) s = s + W.Ic[b][6 * r + m] * W.X[6 * m + c];
      W.IX[e] = s;
    }
    __syncwarp();
    for (int e = l; e < 36; e += G) {
      const int r = e / 6, c = e % 6;
      S s = W.X[r] * W.IX[c];
      for (int m = 1; m < 6; ++m) s = s + W.X[6 * m + r] * W.IX[6 * m + c];
      W.Ic[par][e] = W.Ic[par][e] + s;
    }
    __syncwarp();
  }
  for (int e = l; e < nv * nv; e += G) {
    const int r = e / nv, c = e % nv;
    W.M[EM_MAX_NV * r + c] = (r < 6 && c < 6) ? W.Ic[0][6 * r + c] : S(0);
  }
  __syncwarp();
  for (int j = l; j < nj; j += G) crba_joint_column<S, S>(d, j, W.k, W.Ic, W.M);
  __syncwarp();
  // Cholesky factor of M (NaN when not PD), right-looking with a barrier
  // per column: each thread takes the pivot, writes
  // column j of the factor transposed into the upper triangle (the pivot
  // into tmp) and subtracts its products from the trailing lower triangle;
  // then the factor moves to the lower triangle
  for (int j = 0; j < nv; ++j) {
    const S* Mj = W.M + EM_MAX_NV * j;
    const S dj = vsqrt(Mj[j]);
    const S inv_d = S(1) / dj;
    const int m = nv - 1 - j;
    for (int e = l; e < 1 + m + m * (m + 1) / 2; e += G) {
      if (e == 0) {
        W.tmp[j] = dj;
      } else if (e <= m) {
        W.M[EM_MAX_NV * j + j + e] = W.M[EM_MAX_NV * (j + e) + j] * inv_d;
      } else {
        int r = 0, t = e - 1 - m;
        while (t > r) t -= ++r;
        const int i = j + 1 + r, k = j + 1 + t;
        W.M[EM_MAX_NV * i + k] = W.M[EM_MAX_NV * i + k]
            - (W.M[EM_MAX_NV * i + j] * inv_d) * (W.M[EM_MAX_NV * k + j] * inv_d);
      }
    }
    __syncwarp();
  }
  for (int e = l; e < nv * nv; e += G) {
    const int i = e / nv, c = e % nv;
    if (i > c) W.M[EM_MAX_NV * i + c] = W.M[EM_MAX_NV * c + i];
    if (i == c) W.M[EM_MAX_NV * i + i] = W.tmp[i];
  }
  __syncwarp();
  if constexpr (CON) {
    // a_free on the first thread, M^-1 Jm^T a row per other thread, then
    // the KKT solve and the step on the first
    if (l == 0) {
      for (int i = 0; i < nv; ++i) C->free[i] = W.rhs[i];
      chol_solve(W.M, nv, EM_MAX_NV, C->free);
    }
    for (int r = l - 1; r >= 0 && r < d.nc; r += G - 1) {
      for (int i = 0; i < nv; ++i) C->MJ[r][i] = C->J[r][i];
      chol_solve(W.M, nv, EM_MAX_NV, C->MJ[r]);
    }
    __syncwarp();
    if (l == 0) {
      contact_solve<S>(d, W, *C);
      if (cost)
        for (int k = 0; k < d.n_slots; ++k)
          if (d.slot_kind[k] == EM_KIND_FRICTION_CONE)
            W.ck[k] = cone_cost<S>(d, k, C->lam, C->Rf, np, gp, W.tmp);
    }
  } else if (l == 0) {
    chol_solve(W.M, nv, EM_MAX_NV, W.rhs);
  }
}

// the cooperative node step: coop_dam, then the Euler step from xt into
// xc on the first thread. Given c_out, also the running cost dt l(xt, u)
// into *c_out.
template <class S, int G, bool CON>
__device__ __forceinline__ void coop_dyn_next(const ModelDesc& d, int l, CoopNode<S>& W,
                                              CoopContact<S>* C, const S* np = nullptr,
                                              const S* gp = nullptr, S* c_out = nullptr) {
  coop_dam<S, G, CON>(d, l, W, C, np, gp, c_out != nullptr);
  if (l == 0) {
    euler_next<S, S>(d, W.xt, W.rhs, W.xc, W.inc);
    if (c_out) *c_out = S(d.dt) * coop_cost_sum(d, W);
  }
}
