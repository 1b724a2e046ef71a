// K1: node linearization for every running node of a batch of problems.
//
// Replaces the TPU kernel eagle_mpc_tpu/ops/node_pallas.py::_node_kernel
// (pallas_call at node_pallas.py:949, built by _kernel_builder).
//
// What it computes, per node n (flattened b * T + t): the squash, rotor
// allocation + joint torques, free forward dynamics and the symplectic-
// Euler step; the residual rows of every cost slot; the Jacobian of
// [xnext (-) xnext0, residuals] over the nz = ndx + nu tangent directions
// of z = (dx, ds); and the Gauss-Newton terms g = J_r^T (w A_r),
// H = J_r^T diag(w A_rr) J_r. Outputs cost, xnext, Fx, Fu, Lx, Lu, Lxx,
// Lxu, Luu (row-major, node-leading).
//
// Design: one warp per node, K1_NODES nodes per block, everything a node
// shares in the warp's shared memory.
// 1. The primal, once per node, by the whole warp (coop_dyn_next,
//    model.cuh): tau(s), the tree kinematics, the bias b = RNEA(q, v, 0),
//    M = CRBA(q), its Cholesky factor L, a = M^-1 (tau - b), the Euler
//    increment D0 and xnext0; then RNEA(q, v, a), whose body accelerations
//    and subtree forces the tangents read.
// 2. da/dz_j, a direction per lane, through the implicit function
//    RNEA(x (+) z, a) = tau(s): for a state direction, da = -M^-1 d_j RNEA
//    with a held, by a tangent-only RNEA that reads the primal (no CRBA,
//    no Cholesky, no dual numbers; gravity enters through the base
//    rotation); for a control direction, da = M^-1 dtau/ds_j. One solve
//    against the shared L each.
// 3. The Euler step and the state difference enter through two 6 x 6 base
//    blocks per node: [Fx Fu] e_j = blockdiag(Ez, I) e_j + blockdiag(ED, I)
//    dD_j, dD_j = [(dv_j + da_j dt) dt, da_j dt], with Ez = d/dz
//    (x (+) z (+) D^) (-) xnext0 (closed form: euler_z_block) and ED =
//    d/dD (x^ (+) D) (-) xnext0 at D^ (a dual column per lane). x^ = x (+) 0
//    is x with its quaternion
//    normalized and D^ the Euler increment there: the plain version
//    differentiates through x (+) z, so a state whose quaternion has a norm
//    off 1 (one born in f32: 1 +- 1e-7) is linearized at x^ (its gravity
//    tangent too), while xnext0 and the slots' rows stay at x. The x-only
//    slots' Jacobians take one dual
//    column per lane in the same pass: for a STATE slot only its 6 x 6
//    base block (the rest is the identity); a frame slot (placement,
//    translation, rotation, velocity) all ndx columns of its rows, each
//    column one evaluation of the frame's kinematics along the chain to its
//    body and of its residual in dual numbers (model.cuh frame_residual).
// 4. Gauss-Newton by slot structure (slot_on_x): Lx and Lxx from the x-only
//    slots, a STATE slot through its base block; Lu and the diagonal Luu
//    from the CONTROL slots, whose Jacobian is the identity on s; Lx, Lu,
//    Lxx, Lxu and Luu from the friction-cone slots' full rows (Lxu is
//    exactly zero without one). The activations go a residual row per lane.
// 6. A contact spec: the warp's primal also runs the masked KKT solve
//    (model.cuh coop_dyn_next). Its tangents follow the reference's IFT
//    rule of the KKT system (eagle_mpc_tpu/dynamics/rbd.py, the contact
//    jvp): for direction j, r = dtau + dJm^T lam - d RNEA|a, dlam =
//    -G^-1 (dJm a + Jm M^-1 r + act da0), da = M^-1 (r + Jm^T dlam), with
//    the primal's factors of M and G; dJ and da0 are one dual evaluation of
//    the contact rows along x^ (+) t e_j (zero for a control direction),
//    and the cone rows' column is A (dRf f + Rf df). The linearization
//    point is x^ as above: a, lam and the cone's Rf there come from a_free
//    at x^ (the gravity shift) and the contact rows at x^ (contact_hat).
// 5. Every output leaves as contiguous runs: consecutive lanes write
//    consecutive entries (a row of Fx / Fu at a time).
// 7. An RK4 spec runs a kernel of its own, node_rk4_kernel (below): the
//    stage tangents carried through the RK4 chain, full rows at every
//    stage point; on a contact spec the IFT rule of item 6 at each stage
//    point, along that stage's tangent.
//
// What bounds it on an H100: latency. A node is a chain of about 50
// barrier phases in one warp (the cooperative primal's CRBA and Cholesky,
// the tree chains, the dual pass with its transcendental functions);
// about 20 warps fit an SM (registers and shared memory), too few to hide
// it. Device memory is far from it: 73 MB in f32 at B=512 (about 1 100
// outputs and 135 inputs per node) would take 22 us at 3.35 TB/s. The
// 18 x 27 blocks fill no tensor-core tile and the solver needs full f32,
// so the FMA units do the products.
#include <cuda_runtime.h>

#include "model.cuh"

#define K1_NODES 4   // nodes per block, one warp each
// blocks per SM the register budget is cut for: 20 warps, which the
// shared memory of a block (~34 KB in f32 on the carrot spec, 37 KB with
// the weighted spec's frame rows) also admits; it measured faster than 16
// warps at 128 registers. In f64 a block takes twice that (75 KB on the
// weighted spec), so 3 blocks fit an SM; the launch is the same.
#define K1_MIN_BLOCKS 5

// A STATE residual (x (+) z) (-) ref has the Jacobian blockdiag(A, I), A
// the 6 x 6 block of the base: only A takes dual passes and is stored.
// The other x-only kinds, the frame slots, take every column and row.
__host__ __device__ __forceinline__ bool slot_block_identity(const ModelDesc& d, int k) {
  return d.slot_kind[k] == EM_KIND_STATE;
}

__host__ __device__ __forceinline__ int slot_jac_rows(const ModelDesc& d, int k) {
  return slot_block_identity(d, k) ? EM_BASE_NDX : d.slot_nr[k];
}

__host__ __device__ __forceinline__ int slot_jac_cols(const ModelDesc& d, int k) {
  return slot_block_identity(d, k) ? EM_BASE_NDX : 2 * d.nv;
}

// offsets (in scalars) of one warp's shared arrays, after the K1_NODES
// CoopNode working sets of the primal
struct K1Layout {
  int C;      // the contact path: the CoopContact working set
  int Jc;     // [cone rows][nz] the friction-cone slots' Jacobians
  int ah;     // [nv] a contact spec: the acceleration at x^
  int lamh;   // [nc] the multipliers at x^
  int Rfh;    // [n_con][9] the contact frames' world rotations at x^
  int DA;     // [nz][nv] da / dz_j
  int Ez;     // [6][6] base block of d/dz (x (+) z (+) D0) (-) xnext0
  int ED;     // [6][6] base block of d/dD (x (+) D) (-) xnext0 at D0 (the
              // Euler increment)
  int Jx;     // [slot_jac_rows of the x-only slots][ndx] their Jacobians
  int xh;     // [nx] x^ = x (+) 0, the quaternion normalized
  int Dh;     // [ndx] D^, the Euler increment at x^
  int val;    // [n_res] residual values
  int act;    // [n_res] each row's share of 2 a
  int wA;     // [n_res] w * A_r
  int wAA;    // [n_res] w * A_rr
  int total;
  int n_tasks;   // dual columns of the x-only slots
  int n_cone;    // rows of the friction-cone slots
};

__host__ __device__ inline K1Layout k1_layout(const ModelDesc& d) {
  const int nv = d.nv, ndx = 2 * nv, nz = ndx + d.nu, n_res = d.n_res;
  K1Layout o;
  int rows = 0;
  o.n_tasks = 0;
  o.n_cone = 0;
  for (int k = 0; k < d.n_slots; ++k) {
    if (slot_on_x(d.slot_kind[k])) {
      rows += slot_jac_rows(d, k);
      o.n_tasks += slot_jac_cols(d, k);
    }
    if (d.slot_kind[k] == EM_KIND_FRICTION_CONE) o.n_cone += EM_CONE_ROWS;
  }
  const bool con = contact_path(d);
  int at = 0;
  o.C = at;   at += con ? (int)(sizeof(CoopContact<double>) / sizeof(double)) : 0;
  o.Jc = at;  at += o.n_cone * nz;
  o.ah = at;  at += con ? nv : 0;
  o.lamh = at; at += con ? d.nc : 0;
  o.Rfh = at; at += con ? 9 * d.n_con : 0;
  o.DA = at;  at += nz * nv;
  o.Ez = at;  at += EM_BASE_NDX * EM_BASE_NDX;
  o.ED = at;  at += EM_BASE_NDX * EM_BASE_NDX;
  o.Jx = at;  at += rows * ndx;
  o.xh = at;  at += d.nq + nv;
  o.Dh = at;  at += ndx;
  o.val = at; at += n_res;
  o.act = at; at += n_res;
  o.wA = at;  at += n_res;
  o.wAA = at; at += n_res;
  o.total = at;
  return o;
}

template <class S>
__host__ __device__ inline size_t k1_smem_bytes(const K1Layout& lay) {
  return K1_NODES * (sizeof(CoopNode<S>) + sizeof(S) * (size_t)lay.total);
}

// o = d motion_to_child(p, R, m) along (dp, dR, dm)
template <class S>
__device__ __forceinline__ void tan_motion_to_child(const S* p, const S* R, const S* m,
                                                    const S* dp, const S* dR, const S* dm,
                                                    S* o) {
  S pxw[3], dpxw[3], pxdw[3], t[3], dt[3], a[3], b[3];
  cross3(p, m + 3, pxw);
  cross3(dp, m + 3, dpxw);
  cross3(p, dm + 3, pxdw);
  for (int i = 0; i < 3; ++i) {
    t[i] = m[i] - pxw[i];
    dt[i] = dm[i] - (dpxw[i] + pxdw[i]);
  }
  mtv3(R, dt, a);
  mtv3(dR, t, b);
  for (int i = 0; i < 3; ++i) o[i] = a[i] + b[i];
  mtv3(R, dm + 3, a);
  mtv3(dR, m + 3, b);
  for (int i = 0; i < 3; ++i) o[3 + i] = a[i] + b[i];
}

// o = d force_to_parent(p, R, f) along (dp, dR, df)
template <class S>
__device__ __forceinline__ void tan_force_to_parent(const S* p, const S* R, const S* f,
                                                    const S* dp, const S* dR, const S* df,
                                                    S* o) {
  S Rf[3], dRf[3], a[3], b[3], c[3];
  mv3(R, f, Rf);
  mv3(dR, f, a);
  mv3(R, df, b);
  for (int i = 0; i < 3; ++i) dRf[i] = a[i] + b[i];
  mv3(dR, f + 3, a);
  mv3(R, df + 3, b);
  cross3(dp, Rf, c);
  for (int i = 0; i < 3; ++i) o[3 + i] = a[i] + b[i] + c[i];
  cross3(p, dRf, c);
  for (int i = 0; i < 3; ++i) {
    o[i] = dRf[i];
    o[3 + i] = o[3 + i] + c[i];
  }
}

// a state tangent direction for rnea_tangent: the unit direction e_j
// (component c is 1 at c == j), or an arbitrary tangent dy (RK4's stage
// tangents); rot: whether it may turn the base
template <class S>
struct UnitDir {
  int j;
  __device__ __forceinline__ S operator()(int c) const { return S(j == c ? 1 : 0); }
  __device__ __forceinline__ bool rot() const { return j >= 3 && j < 6; }
};

template <class S>
struct TangentDir {
  const S* dy;
  __device__ __forceinline__ S operator()(int c) const { return dy[c]; }
  __device__ __forceinline__ bool rot() const { return true; }
};

// out = -d RNEA(x (+) t e, a)/dt at t = 0 for a state tangent direction e
// (Dir), a held. Tangent-only forward mode: W holds the primal (the
// kinematics, the body accelerations and the subtree forces of RNEA(x, a)),
// which is read, not recomputed.
template <class S, class Dir>
__device__ __noinline__ void rnea_tangent(const ModelDesc& d, const CoopNode<S>& W, const S* qh,
                                          Dir e, S* out) {
  const int nq = d.nq, nv = d.nv, nj = d.nj;
  S dvel[EM_MAX_BODIES][6], dacc[EM_MAX_BODIES][6], dF[EM_MAX_BODIES][6];
  S dps[EM_MAX_BODIES][3], dRs[EM_MAX_BODIES][9];
  // the base: a velocity direction moves its velocity; under a rotation
  // direction R -> R exp([t e]x), gravity in the base g = R^T g_w moves by
  // g x e, with R that of the normalized quaternion qh (x (+) z normalizes)
  for (int i = 0; i < 6; ++i) {
    dvel[0][i] = e(nv + i);
    dacc[0][i] = S(0);
  }
  if (e.rot()) {
    S gw[3] = {S(0), S(0), S(d.gravity)}, g[3], er[3];
    quat_rotate_inv<S, S>(qh, gw, g);
    for (int i = 0; i < 3; ++i) er[i] = e(3 + i);
    cross3(g, er, dacc[0]);
  }
  for (int jj = 0; jj < nj; ++jj) {
    const int b = jj + 1, par = d.parent[jj];
    const S* p = W.k.p[b];
    const S* R = W.k.R[b];
    const S dq = e(6 + jj);
    const S dv = e(nv + 6 + jj);
    S* dp = dps[b];
    S* dR = dRs[b];
    if (d.joint_type[jj] == EM_REVOLUTE) {
      // R = jR exp3(axis q): dR = R hat(axis) dq
      const double* ax = d.joint_axis[jj];
      for (int r = 0; r < 3; ++r) {
        dR[3 * r] = (R[3 * r + 1] * S(ax[2]) - R[3 * r + 2] * S(ax[1])) * dq;
        dR[3 * r + 1] = (R[3 * r + 2] * S(ax[0]) - R[3 * r] * S(ax[2])) * dq;
        dR[3 * r + 2] = (R[3 * r] * S(ax[1]) - R[3 * r + 1] * S(ax[0])) * dq;
        dp[r] = S(0);
      }
    } else {
      // p = jp + jR axis q: dp = jR axis dq
      for (int r = 0; r < 3; ++r) {
        dp[r] = (S(d.joint_R[jj][3 * r]) * S(d.joint_axis[jj][0])
                 + S(d.joint_R[jj][3 * r + 1]) * S(d.joint_axis[jj][1])
                 + S(d.joint_R[jj][3 * r + 2]) * S(d.joint_axis[jj][2])) * dq;
      }
      for (int i = 0; i < 9; ++i) dR[i] = S(0);
    }
    S Sj[6], o[6], c1[6], c2[6], Svd[6], dSvd[6];
    joint_subspace<S>(d, jj, Sj);
    tan_motion_to_child(p, R, W.k.vel[par], dp, dR, dvel[par], o);
    for (int i = 0; i < 6; ++i) dvel[b][i] = o[i] + Sj[i] * dv;
    const S vj = W.xt[nq + 6 + jj];
    for (int i = 0; i < 6; ++i) {
      Svd[i] = Sj[i] * vj;
      dSvd[i] = Sj[i] * dv;
    }
    tan_motion_to_child(p, R, W.acc[par], dp, dR, dacc[par], o);
    motion_cross(dvel[b], Svd, c1);
    motion_cross(W.k.vel[b], dSvd, c2);
    for (int i = 0; i < 6; ++i) dacc[b][i] = o[i] + c1[i] + c2[i];
  }
  // body forces: d (I acc + v x* (I v))
  for (int b = 0; b <= nj; ++b) {
    S Iv[6], dIv[6], dIa[6], c1[6], c2[6];
    for (int r = 0; r < 6; ++r) {
      S sv = S(0), sdv = S(0), sda = S(0);
      for (int c = 0; c < 6; ++c) {
        const S I = S(d.inertia[b][6 * r + c]);
        sv = sv + I * W.k.vel[b][c];
        sdv = sdv + I * dvel[b][c];
        sda = sda + I * dacc[b][c];
      }
      Iv[r] = sv;
      dIv[r] = sdv;
      dIa[r] = sda;
    }
    motion_cross_force(dvel[b], Iv, c1);
    motion_cross_force(W.k.vel[b], dIv, c2);
    for (int i = 0; i < 6; ++i) dF[b][i] = dIa[i] + c1[i] + c2[i];
  }
  // up the tree, with the subtree forces of the primal
  for (int jj = nj - 1; jj >= 0; --jj) {
    const int b = jj + 1, par = d.parent[jj];
    S Sj[6], o[6];
    joint_subspace<S>(d, jj, Sj);
    S t = S(0);
    for (int i = 0; i < 6; ++i) t = t + Sj[i] * dF[b][i];
    out[6 + jj] = -t;
    tan_force_to_parent(W.k.p[b], W.k.R[b], W.force[b], dps[b], dRs[b], dF[b], o);
    for (int i = 0; i < 6; ++i) dF[par][i] = dF[par][i] + o[i];
  }
  for (int i = 0; i < 6; ++i) out[i] = -dF[0][i];
}

// out = dtau/ds_i for control i (the squash's slope times the allocation)
template <class S>
__device__ __noinline__ void control_tangent(const ModelDesc& d, const CoopNode<S>& W,
                                             const S* gp, int i, S* out) {
  typedef Dual<S> D;
  D ss[EM_MAX_NU], tau[EM_MAX_NV];
  for (int c = 0; c < d.nu; ++c) ss[c] = D(W.u[c], S(c == i ? 1 : 0));
  control_tau<S, D>(d, ss, gp, tau);
  for (int r = 0; r < d.nv; ++r) out[r] = tau[r].d;
}

// xh = x (+) 0 (x with its quaternion normalized) and Dh, the Euler
// increment at xh: the acceleration there differs from the primal's at x
// (W.rhs, W.inc) by the base-frame gravity alone, a = M^-1 (tau - b) -
// [g_base, 0] with M and b independent of the base's attitude.
template <class S>
__device__ __noinline__ void hat_point(const ModelDesc& d, const CoopNode<S>& W, S* xh, S* Dh) {
  const int nx = d.nq + d.nv, nv = d.nv;
  for (int i = 0; i < nx; ++i) xh[i] = W.xt[i];
  quat_normalize(xh + 3);
  S gw[3] = {S(0), S(0), S(d.gravity)}, g[3], gh[3];
  quat_rotate_inv<S, S>(W.xt + 3, gw, g);
  quat_rotate_inv<S, S>(xh + 3, gw, gh);
  const S dt = S(d.dt);
  for (int i = 0; i < 2 * nv; ++i) Dh[i] = W.inc[i];
  for (int i = 0; i < 3; ++i) {
    const S da = g[i] - gh[i];
    Dh[i] = Dh[i] + da * dt * dt;
    Dh[nv + i] = Dh[nv + i] + da * dt;
  }
}

// Ez = d/dz (x (+) z (+) Dh) (-) xn at z = 0, in closed form: with
// xi0 = (xh (+) Dh) (-) xn (tiny, xh = x (+) 0),
// Ez = (I + ad(xi0) / 2) Ad(exp6(Dh)^-1) T. The first factor is the
// inverse right Jacobian of log6 at xi0 to first order (its error is
// O(|xi0|^2), below 1e-16 here), the second the motion transform to the
// pose exp6(Dh), and T = blockdiag(s2 I + (1 - s2) Rh^T, I) maps z to the
// tangent at xh: x (+) z moves the position by rotate(q, z_p) = (s2 Rh +
// (1 - s2) I) z_p for a quaternion q of squared norm s2 (Rh: the rotation
// of q / |q|). Out of line: inlined into the kernel body, nvcc 12.8 gave a
// wrong closed-form block (1e-5 relative in Fx), which the f64 parity
// gate on the card caught.
template <class S>
__device__ __noinline__ void euler_z_block(const ModelDesc& d, const S* x, const S* xh,
                                           const S* Dh, const S* xn, S* Ez) {
  S p[3], q[4], R[9], Rh[9], X[36], XT[36], y[EM_MAX_NX], xi[EM_MAX_NDX];
  exp6<S, S>(Dh, p, q);
  quat_to_rot<S, S>(q, R);
  for (int e = 0; e < 36; ++e) X[e] = xform_entry<S, S>(R, p, e);
  const S* qr = x + 3;
  const S s2 = qr[0] * qr[0] + qr[1] * qr[1] + qr[2] * qr[2] + qr[3] * qr[3];
  quat_to_rot<S, S>(xh + 3, Rh);
  for (int r = 0; r < 6; ++r)
    for (int c = 0; c < 6; ++c) {
      S t = X[6 * r + c];
      if (c < 3) {
        t = S(0);
        for (int m = 0; m < 3; ++m)
          t = t + X[6 * r + m] * ((m == c ? s2 : S(0)) + (S(1) - s2) * Rh[3 * c + m]);
      }
      XT[6 * r + c] = t;
    }
  integrate<S, S>(d, xh, Dh, y);
  state_diff<S, S>(d, xn, y, xi);
  // ad(xi) = [[w^, v^], [0, w^]] for xi = [v, w]
  const S* v = xi;
  const S* w = xi + 3;
  const S hv[9] = {S(0), -v[2], v[1], v[2], S(0), -v[0], -v[1], v[0], S(0)};
  const S hw[9] = {S(0), -w[2], w[1], w[2], S(0), -w[0], -w[1], w[0], S(0)};
  for (int r = 0; r < 6; ++r)
    for (int c = 0; c < 6; ++c) {
      S acc = XT[6 * r + c];
      for (int m = 0; m < 6; ++m) {
        S a = S(0);
        if (r < 3 && m < 3) a = hw[3 * r + m];
        else if (r < 3) a = hv[3 * r + m - 3];
        else if (m >= 3) a = hw[3 * (r - 3) + m - 3];
        acc = acc + S(0.5) * a * XT[6 * m + c];
      }
      Ez[6 * r + c] = acc;
    }
}

// one dual column of the Euler step's base block: rows r < 6 of
// d/dt integrate(x, D0 + t e_i) (-) target at t = 0 into col[r * stride]
template <class S>
__device__ __noinline__ void dual_column(const ModelDesc& d, const S* x, int i, const S* D0,
                                         const S* target, S* col, int stride) {
  typedef Dual<S> D;
  const int nx = d.nq + d.nv, ndx = 2 * d.nv;
  D xd[EM_MAX_NX], z[EM_MAX_NDX], y[EM_MAX_NX];
  for (int c = 0; c < nx; ++c) xd[c] = D(x[c]);
  for (int c = 0; c < ndx; ++c) z[c] = D(D0[c], S(c == i ? 1 : 0));
  integrate<S, D>(d, xd, z, y);
  for (int c = 0; c < nx; ++c) xd[c] = D(target[c]);
  state_diff<S, D>(d, xd, y, z);
  for (int r = 0; r < EM_BASE_NDX; ++r) col[r * stride] = z[r].d;
}

// one dual column of x-only slot k: rows r < nr of d/dt r_k(x (+) t e_i) at
// t = 0 into col[r * stride]; the values of all its rows into vals when
// given
template <class S>
__device__ __noinline__ void slot_column(const ModelDesc& d, const S* x, int k, int i,
                                         const S* np, int nr, S* col, int stride, S* vals) {
  typedef Dual<S> D;
  const int nx = d.nq + d.nv, ndx = 2 * d.nv;
  D xd[EM_MAX_NX], z[EM_MAX_NDX], y[EM_MAX_NX], r[EM_MAX_NR];
  for (int c = 0; c < nx; ++c) xd[c] = D(x[c]);
  for (int c = 0; c < ndx; ++c) z[c] = D(S(0), S(c == i ? 1 : 0));
  integrate<S, D>(d, xd, z, y);
  slot_residual<S, D>(d, k, y, nullptr, np, r);
  for (int q = 0; q < nr; ++q) col[q * stride] = r[q].d;
  if (vals)
    for (int q = 0; q < d.slot_nr[k]; ++q) vals[q] = r[q].v;
}

// a contact spec at x^ = x (+) 0 (the quaternion normalized): a_free
// shifts by the base-frame gravity alone, a0 and Rf come from the contact
// rows at x^ (J does not depend on the base's attitude), and with G's
// factor from x: lam^, a^ and the Euler increment D^ there. One thread.
template <class S>
__device__ __noinline__ void contact_hat(const ModelDesc& d, const CoopContact<S>& C,
                                         const S* np, const S* x, const S* xh, S* ah,
                                         S* lamh, S* Rfh, S* Dh) {
  const int nv = d.nv, nc = d.nc;
  S gw[3] = {S(0), S(0), S(d.gravity)}, g[3], gh[3];
  quat_rotate_inv<S, S>(x + 3, gw, g);
  quat_rotate_inv<S, S>(xh + 3, gw, gh);
  S fh[EM_MAX_NV], J[EM_MAX_NC * EM_MAX_NV], a0[EM_MAX_NC];
  for (int i = 0; i < nv; ++i) fh[i] = C.free[i];
  for (int i = 0; i < 3; ++i) fh[i] = fh[i] + (g[i] - gh[i]);
  for (int c = 0; c < d.n_con; ++c)
    contact_rows<S, S>(d, c, xh, np, J, a0 + d.con_row[c], Rfh + 9 * c);
  for (int i = 0; i < nc; ++i) {
    S s = C.J[i][0] * fh[0];
    for (int m = 1; m < nv; ++m) s = s + C.J[i][m] * fh[m];
    lamh[i] = s + C.act[i] * a0[i];
  }
  chol_solve(C.G, nc, EM_MAX_NC, lamh);
  for (int i = 0; i < nc; ++i) lamh[i] = -lamh[i];
  const S dt = S(d.dt);
  for (int m = 0; m < nv; ++m) {
    S s = fh[m];
    for (int i = 0; i < nc; ++i) s = s + C.MJ[i][m] * lamh[i];
    ah[m] = s;
    Dh[m] = (xh[d.nq + m] + s * dt) * dt;
    Dh[nv + m] = s * dt;
  }
}

// the contact part of a tangent of the constrained dynamics at the point
// y (the IFT rule in the header), with the primal's factors of M and G in
// W and C and the acceleration a, the multipliers lam and the contact
// frames' world rotations Rf at y: on entry da holds dtau - d RNEA|a
// along the direction, on exit the direction's da. The contact rows'
// tangents dJ, da0 and dRf are one dual evaluation along y (+) t dy, with
// dy the unit direction e_j when null (j >= ndx: none, a control direction
// of the Euler step, which leaves y where it is). Also the direction's
// column of the cone slots' rows, A (dRf f + Rf df), into Jc[r * stride]
// for the cone rows r: counted among the cone rows alone, or with
// res_rows among all the residual rows. The Euler step runs it from the
// raw x along e_j, as the plain version's x (+) z: its value is x^, and
// off |q| = 1 its position tangent is not the one from x^.
template <class S>
__device__ __noinline__ void contact_tangent(const ModelDesc& d, const CoopNode<S>& W,
                                             const CoopContact<S>& C, const S* np,
                                             const S* y, const S* dy, int j, const S* a,
                                             const S* lam, const S* Rf, S* da, S* Jc,
                                             int stride, bool res_rows) {
  typedef Dual<S> D;
  const int nv = d.nv, nc = d.nc, ndx = 2 * nv, nx = d.nq + nv;
  S dJa[EM_MAX_NC], da0[EM_MAX_NC], dRf[EM_MAX_CON][9];
  for (int i = 0; i < nc; ++i) dJa[i] = da0[i] = S(0);
  for (int c = 0; c < d.n_con; ++c)
    for (int i = 0; i < 9; ++i) dRf[c][i] = S(0);
  if (dy || j < ndx) {
    D xd[EM_MAX_NX], z[EM_MAX_NDX], yy[EM_MAX_NX];
    for (int i = 0; i < nx; ++i) xd[i] = D(y[i]);
    for (int i = 0; i < ndx; ++i) z[i] = D(S(0), dy ? dy[i] : S(i == j ? 1 : 0));
    integrate<S, D>(d, xd, z, yy);
    for (int c = 0; c < d.n_con; ++c) {
      D J[EM_MAX_NC * EM_MAX_NV], a0[EM_MAX_NC], Rfd[9];
      contact_rows<S, D>(d, c, yy, np, J, a0, Rfd);
      const int r0 = d.con_row[c];
      const S act = np[d.con_act_off + c];
      for (int r = 0; r < d.con_dim[c]; ++r) {
        S s = S(0);
        for (int m = 0; m < nv; ++m) {
          const S dJ = act * J[EM_MAX_NV * r + m].d;
          da[m] = da[m] + dJ * lam[r0 + r];
          s = s + dJ * a[m];
        }
        dJa[r0 + r] = s;
        da0[r0 + r] = a0[r].d;
      }
      for (int i = 0; i < 9; ++i) dRf[c][i] = Rfd[i].d;
    }
  }
  chol_solve(W.M, nv, EM_MAX_NV, da);
  S dlam[EM_MAX_NC];
  for (int i = 0; i < nc; ++i) {
    S s = dJa[i];
    for (int m = 0; m < nv; ++m) s = s + C.J[i][m] * da[m];
    dlam[i] = s + C.act[i] * da0[i];
  }
  chol_solve(C.G, nc, EM_MAX_NC, dlam);
  for (int i = 0; i < nc; ++i) dlam[i] = -dlam[i];
  for (int m = 0; m < nv; ++m) {
    S s = da[m];
    for (int i = 0; i < nc; ++i) s = s + C.MJ[i][m] * dlam[i];
    da[m] = s;
  }
  int row = 0;
  for (int k = 0; k < d.n_slots; ++k) {
    if (d.slot_kind[k] != EM_KIND_FRICTION_CONE) {
      if (res_rows) row += d.slot_nr[k];
      continue;
    }
    const int c = d.slot_contact[k];
    S col[EM_CONE_ROWS];
    if (c < 0) {
      for (int i = 0; i < EM_CONE_ROWS; ++i) col[i] = S(0);
    } else {
      // d (Rf f) = dRf f + Rf df, then A
      const S* f = lam + d.con_row[c];
      const S* df = dlam + d.con_row[c];
      S u[3], v[3], t[3];
      mv3(dRf[c], f, u);
      mv3(Rf + 9 * c, df, v);
      for (int i = 0; i < 3; ++i) t[i] = u[i] + v[i];
      cone_apply<S, S>(d, k, t, col);
    }
    for (int i = 0; i < EM_CONE_ROWS; ++i) Jc[(row + i) * stride] = col[i];
    row += EM_CONE_ROWS;
  }
}

template <class S, bool CON>
__global__ void __launch_bounds__(32 * K1_NODES, K1_MIN_BLOCKS)
node_kernel(const ModelDesc* __restrict__ desc, int N, int T,
            const S* __restrict__ x, const S* __restrict__ s,
            const S* __restrict__ node_par, const S* __restrict__ glob_par,
            S* cost, S* xnext, S* Fx, S* Fu, S* Lx, S* Lu, S* Lxx, S* Lxu,
            S* Luu) {
  const ModelDesc& d = *desc;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * K1_NODES + warp;
  if (n >= N) return;   // whole warps only: nothing below syncs the block
  const int nv = d.nv, nx = d.nq + nv, ndx = 2 * nv, nu = d.nu, nz = ndx + nu;
  const int K = d.n_slots, n_res = d.n_res;
  const K1Layout lay = k1_layout(d);
  extern __shared__ unsigned char smem_raw[];
  CoopNode<S>& W = reinterpret_cast<CoopNode<S>*>(smem_raw)[warp];
  S* sm = reinterpret_cast<S*>(reinterpret_cast<CoopNode<S>*>(smem_raw) + K1_NODES)
          + warp * lay.total;
  S* DA = sm + lay.DA;
  S* Ez = sm + lay.Ez;
  S* ED = sm + lay.ED;
  S* Jx = sm + lay.Jx;
  S* xh = sm + lay.xh;
  S* Dh = sm + lay.Dh;
  S* val = sm + lay.val;
  S* act = sm + lay.act;
  S* wA = sm + lay.wA;
  S* wAA = sm + lay.wAA;
  CoopContact<S>* C = reinterpret_cast<CoopContact<S>*>(sm + lay.C);
  S* Jc = sm + lay.Jc;
  S* ah = sm + lay.ah;
  S* lamh = sm + lay.lamh;
  S* Rfh = sm + lay.Rfh;

  const size_t nn = (size_t)n;
  const S* np = node_par + nn * d.node_dim;
  const S* gp = glob_par + (size_t)(n / T) * d.glob_dim;
  for (int i = lane; i < nx; i += 32) W.xt[i] = x[nn * nx + i];
  for (int i = lane; i < nu; i += 32) {
    W.u[i] = s[nn * nu + i];
    W.usq[i] = control_u<S, S>(d, i, W.u[i], gp);
  }
  __syncwarp();

  // the primal, once per node, by the whole warp, then RNEA(x, a) (a
  // contact spec: RNEA(x^, a^)): the body accelerations and subtree forces
  // the tangents read
  coop_dyn_next<S, 32, CON>(d, lane, W, C, np);
  __syncwarp();
  if (lane == 0) {
    hat_point<S>(d, W, xh, Dh);
    if constexpr (CON) {
      contact_hat<S>(d, *C, np, W.xt, xh, ah, lamh, Rfh, Dh);
      rnea_forward<S, S>(d, xh, ah, W.k, W.acc);
      // the cone rows' values, at x^ as every slot's (the plain version
      // evaluates the rows at x (+) 0)
      for (int k = 0, row = 0; k < K; row += d.slot_nr[k], ++k)
        if (d.slot_kind[k] == EM_KIND_FRICTION_CONE) {
          const int c = d.slot_contact[k];
          if (c < 0)
            for (int i = 0; i < EM_CONE_ROWS; ++i) val[row + i] = S(0);
          else
            cone_rows<S, S>(d, k, Rfh + 9 * c, lamh + d.con_row[c], val + row);
        }
    } else {
      rnea_forward<S, S>(d, W.xt, W.rhs, W.k, W.acc);
    }
  }
  __syncwarp();
  for (int b = lane; b <= d.nj; b += 32) body_force<S, S>(d, b, W.acc[b], W.k.vel[b], W.force[b]);
  __syncwarp();
  if (lane == 0) rnea_backward<S, S>(d, W.k, W.force, W.tmp);
  __syncwarp();

  // da/dz_j, a direction per lane: -M^-1 d RNEA for a state direction
  // (RNEA(x (+) z, a) = tau along z), M^-1 dtau/ds for a control one
  for (int j = lane; j < nz; j += 32) {
    S* daj = DA + j * nv;
    if (j < ndx)
      rnea_tangent<S>(d, W, xh + 3, UnitDir<S>{j}, daj);
    else
      control_tangent<S>(d, W, gp, j - ndx, daj);
    if constexpr (CON)
      contact_tangent<S>(d, W, *C, np, W.xt, nullptr, j, ah, lamh, Rfh, daj, Jc + j, nz, false);
    else
      chol_solve(W.M, nv, EM_MAX_NV, daj);
  }
  // dual columns, one pass with a column per lane: ED, the base block of
  // d/dD (x^ (+) D) (-) xnext0 at D^, and the x-only slots' Jacobians (at
  // x). Ez = d/dz (x (+) z (+) D^) (-) xnext0 is closed form
  // (euler_z_block).
  if (lane == 0) euler_z_block<S>(d, W.xt, xh, Dh, W.xc, Ez);
  for (int task = lane; task < EM_BASE_NDX + lay.n_tasks; task += 32) {
    if (task < EM_BASE_NDX) {
      dual_column<S>(d, xh, task, Dh, W.xc, ED + task, EM_BASE_NDX);
      continue;
    }
    int k = 0, row = 0, xrow = 0, j = task - EM_BASE_NDX;
    for (;; ++k) {
      if (slot_on_x(d.slot_kind[k])) {
        const int nd = slot_jac_cols(d, k);
        if (j < nd) break;
        j -= nd;
        xrow += slot_jac_rows(d, k);
      }
      row += d.slot_nr[k];
    }
    slot_column<S>(d, W.xt, k, j, np, slot_jac_rows(d, k), Jx + xrow * ndx + j, ndx,
                   j == 0 ? val + row : nullptr);
  }
  for (int k = 0, row = 0; k < K; row += d.slot_nr[k], ++k)
    if (d.slot_kind[k] == EM_KIND_CONTROL) {
      const S* ref = np + d.slot_ref_off[k];
      for (int i = lane; i < d.slot_nr[k]; i += 32) val[row + i] = W.u[i] - ref[i];
    }
  __syncwarp();

  // [Fx Fu] column j = Fz e_j + FD dD_j with Fz = blockdiag(Ez, I),
  // FD = blockdiag(ED, I) and dD_j = [(dv_j + da_j dt) dt, da_j dt], written
  // a row at a time (consecutive lanes, consecutive entries)
  for (int j = lane; j < nz; j += 32) {
    const S* daj = DA + j * nv;
    const S dt = S(d.dt);
    auto dD = [&](int c) {
      return c < nv ? (S(j == nv + c ? 1 : 0) + daj[c] * dt) * dt : daj[c - nv] * dt;
    };
    for (int r = 0; r < ndx; ++r) {
      S v;
      if (r < EM_BASE_NDX) {
        v = j < EM_BASE_NDX ? Ez[r * EM_BASE_NDX + j] : S(0);
        for (int c = 0; c < EM_BASE_NDX; ++c) v = v + ED[r * EM_BASE_NDX + c] * dD(c);
      } else {
        v = S(r == j ? 1 : 0) + dD(r);
      }
      if (j < ndx)
        Fx[(nn * ndx + r) * ndx + j] = v;
      else
        Fu[(nn * ndx + r) * nu + j - ndx] = v;
    }
  }

  // activations: a residual row per lane, then each slot's rows summed in
  // order (the arithmetic of activation())
  for (int r = lane; r < n_res; r += 32) {
    int k = 0, i = r;
    while (i >= d.slot_nr[k]) i -= d.slot_nr[k++];
    const S* w = gp + d.slot_glob_off[k];
    const int nr = d.slot_nr[k];
    const S wk = S(d.dt) * np[k] * np[K + k];
    S Ar, Arr;
    act[r] = activation_row<S>(d.slot_act[k], val[r], w[i], w[nr + i], w[2 * nr + i], Ar, Arr);
    wA[r] = wk * Ar;
    wAA[r] = wk * Arr;
  }
  __syncwarp();
  for (int k = lane; k < K; k += 32) {
    int row = 0;
    for (int kk = 0; kk < k; ++kk) row += d.slot_nr[kk];
    S a = S(0);
    for (int i = 0; i < d.slot_nr[k]; ++i) a = a + act[row + i];
    W.ck[k] = (S(d.dt) * np[k] * np[K + k]) * (S(0.5) * a);
  }
  __syncwarp();

  // outputs, each a contiguous run per node
  if (lane == 0) {
    S c = S(0);
    for (int k = 0; k < K; ++k) c = c + W.ck[k];
    cost[nn] = c;
  }
  for (int i = lane; i < nx; i += 32) xnext[nn * nx + i] = W.xc[i];
  // Lxu from the cone rows alone (zero without them)
  for (int e = lane; e < ndx * nu; e += 32) {
    S h = S(0);
    if constexpr (CON) {
      const int i = e / nu, c = ndx + e % nu;
      for (int k = 0, row = 0, crow = 0; k < K; row += d.slot_nr[k], ++k)
        if (d.slot_kind[k] == EM_KIND_FRICTION_CONE)
          for (int r = 0; r < EM_CONE_ROWS; ++r, ++crow)
            h = h + Jc[crow * nz + i] * (wAA[row + r] * Jc[crow * nz + c]);
    }
    Lxu[nn * ndx * nu + e] = h;
  }
  // Lx (e < ndx) and Lxx from the x-only slots' rows. A STATE slot's
  // Jacobian is blockdiag(A, I) with A its base block (the other entries
  // are exact zeros, whose terms are skipped): only A takes products. Then
  // the cone rows' state columns.
  for (int e = lane; e < ndx + ndx * ndx; e += 32) {
    const bool grad = e < ndx;
    const int i = grad ? e : (e - ndx) / ndx;
    const int c = grad ? 0 : (e - ndx) % ndx;
    S h = S(0);
    int row = 0, xrow = 0, crow = 0;
    for (int k = 0; k < K; ++k) {
      const int nr = d.slot_nr[k];
      if (CON && d.slot_kind[k] == EM_KIND_FRICTION_CONE) {
        for (int r = 0; r < EM_CONE_ROWS; ++r, ++crow) {
          const S* Jr = Jc + crow * nz;
          h = grad ? h + Jr[i] * wA[row + r] : h + Jr[i] * (wAA[row + r] * Jr[c]);
        }
      } else if (slot_on_x(d.slot_kind[k])) {
        if (slot_block_identity(d, k) && (i >= EM_BASE_NDX || (!grad && c >= EM_BASE_NDX))) {
          if (grad)
            h = h + wA[row + i];
          else if (i == c)
            h = h + wAA[row + i];
        } else {
          for (int r = 0; r < slot_jac_rows(d, k); ++r) {
            const S* Jr = Jx + (xrow + r) * ndx;
            h = grad ? h + Jr[i] * wA[row + r] : h + Jr[i] * (wAA[row + r] * Jr[c]);
          }
        }
        xrow += slot_jac_rows(d, k);
      }
      row += nr;
    }
    if (grad)
      Lx[nn * ndx + i] = h;
    else
      Lxx[nn * ndx * ndx + e - ndx] = h;
  }
  // Lu (e < nu) and Luu from the CONTROL slots (identity Jacobians) and
  // the cone rows' control columns
  for (int e = lane; e < nu + nu * nu; e += 32) {
    const bool grad = e < nu;
    const int i = grad ? e : (e - nu) / nu;
    const int c = grad ? i : (e - nu) % nu;
    S h = S(0);
    for (int k = 0, row = 0, crow = 0; k < K; row += d.slot_nr[k], ++k) {
      if (d.slot_kind[k] == EM_KIND_CONTROL && i == c)
        h = h + (grad ? wA : wAA)[row + i];
      if (CON && d.slot_kind[k] == EM_KIND_FRICTION_CONE)
        for (int r = 0; r < EM_CONE_ROWS; ++r, ++crow) {
          const S* Jr = Jc + crow * nz + ndx;
          h = grad ? h + Jr[i] * wA[row + r] : h + Jr[i] * (wAA[row + r] * Jr[c]);
        }
    }
    if (grad)
      Lu[nn * nu + i] = h;
    else
      Luu[nn * nu * nu + e - nu] = h;
  }
}

// ---------------------------------------------------------------------------
// K1 on an RK4 spec
// ---------------------------------------------------------------------------
//
// The outputs are the derivatives of problem.node_calc_diff's RK4 rows
// [xnext (-) xnext0, r(y0), r(y1), r(y2), r(y3)] over z = (dx, ds). The
// residuals at y1..y3 depend on s through a0..a2, so Lxu is not zero and
// no slot structure holds past y0: every stage takes full residual rows
// over all nz directions.
// 1. xnext0, at x as the plain version's: the warp runs the four stage
//    passes (coop_dam) and the RK4 combination (rk4_stage).
// 2. The linearization at x^ = x (+) 0 (the quaternion normalized), stage
//    by stage, with the stage's primal and tangents in the warp's one
//    working set:
//    - the warp's dynamics pass at y_i, then RNEA(y_i, a_i) for the
//      tangents, and the first lane's y_{i+1};
//    - a direction j per lane carries the stage tangent dy_i: da_i =
//      M_i^-1 (dtau/dz_j - d RNEA(y_i (+) t dy_i, a_i)) (rnea_tangent along
//      dy_i, the primal's factor of M_i), dk_i = [dy_i's velocity, da_i];
//      the slots' rows at y_i along (dy_i, ds_j), one dual evaluation per
//      slot (rk4_slot_column), and dy_{i+1} = d/dt (x (+) t e_j) (+) h_i
//      (k_i + t dk_i) (-) y_{i+1}, one dual evaluation (rk4_chain_tangent);
//    - the stage's activations (weighted by its quadrature coefficient),
//      and its Gauss-Newton terms added to g and H.
// 3. [Fx Fu] column j = d/dt (x (+) t e_j) (+) (w + t dw) (-) xnext0, w the
//    k-sum times dt/6 at x^ and dw its tangent: one dual evaluation a lane.
// 4. A contact spec (the instantiation CON): every dynamics pass is the
//    constrained one (the contact rows at its stage point, the node's
//    activity at all four, the masked KKT solve), and a direction's da_i
//    follows the IFT rule of the header's item 6 at y_i along dy_i
//    (contact_tangent): dJ, da0 and dRf are not zero for a control
//    direction at stages 1 to 3, where y_i moves with s through a_0 ..
//    a_{i-1}. The cone slots' rows at y_i are A Rf_i f_i with the stage's
//    forces, their columns A (dRf_i f_i + Rf_i df_i) from the same step
//    (rk4_slot_column evaluates slots without forces). The stages run at
//    x^ directly, so the Euler step's gravity shift (contact_hat) has no
//    role; xnext0 stays at the raw x.
// A block takes as many nodes (one warp each, up to K1_NODES) as the
// device's shared memory admits; the launcher sizes it.

// offsets (in scalars) of one warp's shared arrays on an RK4 spec, after
// its CoopNode
struct K1Rk4Layout {
  int C;      // the contact path: the CoopContact working set
  int J;      // [n_res][nz] the residual rows' Jacobian at the current stage
  int H;      // [nz][nz] the Gauss-Newton Hessian, summed over the stages
  int g;      // [nz] the gradient, summed over the stages
  int DY;     // [nz][ndx] each direction's stage tangent dy_i
  int DW;     // [nz][ndx] each direction's tangent of the k-sum
  int DT;     // [nz][nv] dtau / dz_j (zero for a state direction)
  int xh;     // [nx] x^
  int y;      // [nx] the next stage point
  int ks;     // [ndx] the k-sum
  int val;    // [n_res] residual values at the current stage
  int act;    // [n_res] each row's share of 2 a
  int wA;     // [n_res] c_i w A_r
  int wAA;    // [n_res] c_i w A_rr
  int total;
};

__host__ __device__ inline K1Rk4Layout k1_rk4_layout(const ModelDesc& d) {
  const int nv = d.nv, ndx = 2 * nv, nz = ndx + d.nu, n_res = d.n_res;
  K1Rk4Layout o;
  int at = 0;
  o.C = at;   at += contact_path(d) ? (int)(sizeof(CoopContact<double>) / sizeof(double)) : 0;
  o.J = at;   at += n_res * nz;
  o.H = at;   at += nz * nz;
  o.g = at;   at += nz;
  o.DY = at;  at += nz * ndx;
  o.DW = at;  at += nz * ndx;
  o.DT = at;  at += nz * nv;
  o.xh = at;  at += d.nq + nv;
  o.y = at;   at += d.nq + nv;
  o.ks = at;  at += ndx;
  o.val = at; at += n_res;
  o.act = at; at += n_res;
  o.wA = at;  at += n_res;
  o.wAA = at; at += n_res;
  o.total = at;
  return o;
}

template <class S>
__host__ __device__ inline size_t k1_rk4_node_bytes(const ModelDesc& d) {
  return sizeof(CoopNode<S>) + sizeof(S) * (size_t)k1_rk4_layout(d).total;
}

// out = d/dt [((x (+) t e_j) (+) (w + t dw)) (-) target] at t = 0 (ndx
// rows): e_j is no direction for j >= ndx (a control direction), and
// without w the second step is left out
template <class S>
__device__ __noinline__ void rk4_chain_tangent(const ModelDesc& d, const S* x, int j, const S* w,
                                               const S* dw, S h, const S* target, S* out) {
  typedef Dual<S> D;
  const int nx = d.nq + d.nv, ndx = 2 * d.nv;
  D xd[EM_MAX_NX], z[EM_MAX_NDX], y[EM_MAX_NX];
  for (int c = 0; c < nx; ++c) xd[c] = D(x[c]);
  for (int c = 0; c < ndx; ++c) z[c] = D(S(0), S(c == j ? 1 : 0));
  integrate<S, D>(d, xd, z, y);
  if (w) {
    for (int c = 0; c < ndx; ++c) z[c] = D(w[c] * h, dw[c] * h);
    integrate<S, D>(d, y, z, xd);
  } else {
    for (int c = 0; c < nx; ++c) xd[c] = y[c];
  }
  for (int c = 0; c < nx; ++c) y[c] = D(target[c]);
  state_diff<S, D>(d, y, xd, z);
  for (int c = 0; c < ndx; ++c) out[c] = z[c].d;
}

// the rows of slot k at (y (+) t dy, s + t e_ju) differentiated at t = 0
// into col[r * stride] (ju < 0: no control direction); their values into
// vals when given
template <class S>
__device__ __noinline__ void rk4_slot_column(const ModelDesc& d, const S* y, const S* s, int k,
                                             const S* dy, int ju, const S* np, S* col,
                                             int stride, S* vals) {
  typedef Dual<S> D;
  const int nx = d.nq + d.nv, ndx = 2 * d.nv;
  D yd[EM_MAX_NX], z[EM_MAX_NDX], yy[EM_MAX_NX], sd[EM_MAX_NU], r[EM_MAX_NR];
  for (int c = 0; c < nx; ++c) yd[c] = D(y[c]);
  for (int c = 0; c < ndx; ++c) z[c] = D(S(0), dy[c]);
  integrate<S, D>(d, yd, z, yy);
  for (int c = 0; c < d.nu; ++c) sd[c] = D(s[c], S(c == ju ? 1 : 0));
  slot_residual<S, D>(d, k, yy, sd, np, r);
  for (int q = 0; q < d.slot_nr[k]; ++q) col[q * stride] = r[q].d;
  if (vals)
    for (int q = 0; q < d.slot_nr[k]; ++q) vals[q] = r[q].v;
}

// the stage tangents of direction j at stage i (the primal at y_i in W, k_i
// = [v(y_i), a_i]; with CON the constrained one, its factors in C): da_i,
// dk_i into the k-sum's tangent, the residual rows' column j at y_i into J
// (and, for j = 0, their values), and dy_{i+1}
template <class S, bool CON>
__device__ __noinline__ void rk4_direction(const ModelDesc& d, const CoopNode<S>& W,
                                           const CoopContact<S>* C, int i, int j, const S* x,
                                           const S* ynext, const S* np, S* dy, S* dw,
                                           const S* dtau, S* J, int nz, S* val) {
  const int nv = d.nv, ndx = 2 * nv;
  S da[EM_MAX_NV], k[EM_MAX_NDX], dk[EM_MAX_NDX];
  rnea_tangent<S>(d, W, W.xt + 3, TangentDir<S>{dy}, da);
  for (int c = 0; c < nv; ++c) da[c] = da[c] + dtau[c];
  if constexpr (CON)
    // at stage 0 a control direction leaves y_0 = x^ where it is
    contact_tangent<S>(d, W, *C, np, W.xt, i == 0 && j >= ndx ? nullptr : dy, j, W.rhs,
                       C->lam, &C->Rf[0][0], da, J + j, nz, true);
  else
    chol_solve(W.M, nv, EM_MAX_NV, da);
  for (int c = 0; c < nv; ++c) {
    k[c] = W.xt[d.nq + c];
    k[nv + c] = W.rhs[c];
    dk[c] = dy[nv + c];
    dk[nv + c] = da[c];
  }
  for (int c = 0; c < ndx; ++c)
    dw[c] = i == 0 ? dk[c] : (i == 3 ? dw[c] + dk[c] : dw[c] + S(2) * dk[c]);
  const int ju = j - ndx;
  for (int kk = 0, row = 0; kk < d.n_slots; row += d.slot_nr[kk], ++kk) {
    if (CON && d.slot_kind[kk] == EM_KIND_FRICTION_CONE) {
      // the column came from contact_tangent; the values from the forces
      const int c = d.slot_contact[kk];
      if (j == 0 && c >= 0)
        cone_rows<S, S>(d, kk, C->Rf[c], C->lam + d.con_row[c], val + row);
      else if (j == 0)
        for (int q = 0; q < EM_CONE_ROWS; ++q) val[row + q] = S(0);
      continue;
    }
    rk4_slot_column<S>(d, W.xt, W.u, kk, dy, ju, np, J + row * nz + j, nz,
                       j == 0 ? val + row : nullptr);
  }
  if (i < 3)
    rk4_chain_tangent<S>(d, x, j, k, dk, i == 2 ? S(d.dt) : S(d.dt / 2), ynext, dy);
}

template <class S, bool CON>
__global__ void __launch_bounds__(32 * K1_NODES)
node_rk4_kernel(const ModelDesc* __restrict__ desc, int N, int T, int nodes,
                const S* __restrict__ x, const S* __restrict__ s,
                const S* __restrict__ node_par, const S* __restrict__ glob_par,
                S* cost, S* xnext, S* Fx, S* Fu, S* Lx, S* Lu, S* Lxx, S* Lxu, S* Luu) {
  const ModelDesc& d = *desc;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * nodes + warp;
  if (n >= N) return;   // whole warps only: nothing below syncs the block
  const int nv = d.nv, nx = d.nq + nv, ndx = 2 * nv, nu = d.nu, nz = ndx + nu;
  const int K = d.n_slots, n_res = d.n_res;
  const K1Rk4Layout lay = k1_rk4_layout(d);
  extern __shared__ unsigned char smem_raw[];
  CoopNode<S>& W = *reinterpret_cast<CoopNode<S>*>(smem_raw + warp * k1_rk4_node_bytes<S>(d));
  S* sm = reinterpret_cast<S*>(&W + 1);
  S* J = sm + lay.J;
  S* H = sm + lay.H;
  S* g = sm + lay.g;
  S* DY = sm + lay.DY;
  S* DW = sm + lay.DW;
  S* DT = sm + lay.DT;
  S* xh = sm + lay.xh;
  S* y = sm + lay.y;
  S* ks = sm + lay.ks;
  S* val = sm + lay.val;
  S* act = sm + lay.act;
  S* wA = sm + lay.wA;
  S* wAA = sm + lay.wAA;
  CoopContact<S>* C = reinterpret_cast<CoopContact<S>*>(sm + lay.C);

  const size_t nn = (size_t)n;
  const S* xg = x + nn * nx;
  const S* np = node_par + nn * d.node_dim;
  const S* gp = glob_par + (size_t)(n / T) * d.glob_dim;
  for (int i = lane; i < nx; i += 32) W.xt[i] = xg[i];
  for (int i = lane; i < nu; i += 32) {
    W.u[i] = s[nn * nu + i];
    W.usq[i] = control_u<S, S>(d, i, W.u[i], gp);
  }
  __syncwarp();

  // 1. xnext0 at x into W.xc
  for (int i = 0; i < 4; ++i) {
    coop_dam<S, 32, CON>(d, lane, W, C, np, gp, false);
    if (lane == 0) rk4_stage<S>(d, i, xg, W.xt, W.rhs, ks, i < 3 ? W.xt : W.xc);
    __syncwarp();
  }

  // 2. the stages at x^: dy_0 = d/dt (x (+) t e_j) (-) x^, dtau/dz_j
  if (lane == 0) {
    for (int i = 0; i < nx; ++i) xh[i] = xg[i];
    quat_normalize(xh + 3);
  }
  __syncwarp();
  for (int i = lane; i < nx; i += 32) W.xt[i] = xh[i];
  for (int e = lane; e < nz + nz * nz; e += 32) (e < nz ? g[e] : H[e - nz]) = S(0);
  for (int j = lane; j < nz; j += 32) {
    if (j < ndx) {
      rk4_chain_tangent<S>(d, xg, j, nullptr, nullptr, S(0), xh, DY + j * ndx);
      for (int c = 0; c < nv; ++c) DT[j * nv + c] = S(0);
    } else {
      for (int c = 0; c < ndx; ++c) DY[j * ndx + c] = S(0);
      control_tangent<S>(d, W, gp, j - ndx, DT + j * nv);
    }
  }
  __syncwarp();
  S c_total = S(0);
  for (int i = 0; i < 4; ++i) {
    coop_dam<S, 32, CON>(d, lane, W, C, np, gp, false);
    __syncwarp();
    if (lane == 0) rnea_forward<S, S>(d, W.xt, W.rhs, W.k, W.acc);
    __syncwarp();
    for (int b = lane; b <= d.nj; b += 32) body_force<S, S>(d, b, W.acc[b], W.k.vel[b], W.force[b]);
    __syncwarp();
    if (lane == 0) {
      rnea_backward<S, S>(d, W.k, W.force, W.tmp);
      rk4_stage<S>(d, i, xh, W.xt, W.rhs, ks, y);
    }
    __syncwarp();
    for (int j = lane; j < nz; j += 32)
      rk4_direction<S, CON>(d, W, C, i, j, xg, y, np, DY + j * ndx, DW + j * ndx, DT + j * nv,
                            J, nz, val);
    __syncwarp();
    // the stage's activations, a residual row per lane, weighted c_i w_k
    const S ci = S(rk4_coeff(d, i));
    for (int r = lane; r < n_res; r += 32) {
      int k = 0, q = r;
      while (q >= d.slot_nr[k]) q -= d.slot_nr[k++];
      const S* w = gp + d.slot_glob_off[k];
      const int nr = d.slot_nr[k];
      const S wk = ci * np[k] * np[K + k];
      S Ar, Arr;
      act[r] = activation_row<S>(d.slot_act[k], val[r], w[q], w[nr + q], w[2 * nr + q], Ar, Arr);
      wA[r] = wk * Ar;
      wAA[r] = wk * Arr;
    }
    __syncwarp();
    if (lane == 0)
      for (int k = 0, row = 0; k < K; row += d.slot_nr[k], ++k) {
        S a = S(0);
        for (int q = 0; q < d.slot_nr[k]; ++q) a = a + act[row + q];
        c_total = c_total + (ci * np[k] * np[K + k]) * (S(0.5) * a);
      }
    // g += J^T (c w A_r), H += J^T diag(c w A_rr) J
    for (int e = lane; e < nz + nz * nz; e += 32) {
      const bool grad = e < nz;
      const int a = grad ? e : (e - nz) / nz, b = grad ? 0 : (e - nz) % nz;
      S h = S(0);
      for (int r = 0; r < n_res; ++r)
        h = grad ? h + J[r * nz + a] * wA[r] : h + J[r * nz + a] * (wAA[r] * J[r * nz + b]);
      if (grad)
        g[a] = g[a] + h;
      else
        H[e - nz] = H[e - nz] + h;
    }
    __syncwarp();
    if (i < 3)
      for (int c = lane; c < nx; c += 32) W.xt[c] = y[c];
    __syncwarp();
  }

  // 3. [Fx Fu] column j, a row at a time (consecutive lanes, consecutive
  // entries); the other outputs, each a contiguous run per node
  for (int j = lane; j < nz; j += 32) {
    S col[EM_MAX_NDX];
    rk4_chain_tangent<S>(d, xg, j, ks, DW + j * ndx, S(d.dt / 6), W.xc, col);
    for (int r = 0; r < ndx; ++r) {
      if (j < ndx)
        Fx[(nn * ndx + r) * ndx + j] = col[r];
      else
        Fu[(nn * ndx + r) * nu + j - ndx] = col[r];
    }
  }
  if (lane == 0) cost[nn] = c_total;
  for (int i = lane; i < nx; i += 32) xnext[nn * nx + i] = W.xc[i];
  for (int i = lane; i < ndx; i += 32) Lx[nn * ndx + i] = g[i];
  for (int i = lane; i < nu; i += 32) Lu[nn * nu + i] = g[ndx + i];
  for (int e = lane; e < ndx * ndx; e += 32) Lxx[nn * ndx * ndx + e] = H[(e / ndx) * nz + e % ndx];
  for (int e = lane; e < ndx * nu; e += 32) Lxu[nn * ndx * nu + e] = H[(e / nu) * nz + ndx + e % nu];
  for (int e = lane; e < nu * nu; e += 32)
    Luu[nn * nu * nu + e] = H[(ndx + e / nu) * nz + ndx + e % nu];
}

template <class S>
static int launch_node(const void* desc, const ModelDesc* host_desc, int N, int T, const S* x, const S* s,
                       const S* node_par, const S* glob_par, S* cost, S* xnext,
                       S* Fx, S* Fu, S* Lx, S* Lu, S* Lxx, S* Lxu, S* Luu,
                       void* stream) {
  if (host_desc->integrator == EM_RK4) {
    const auto kernel = contact_path(*host_desc) ? &node_rk4_kernel<S, true>
                                                 : &node_rk4_kernel<S, false>;
    int dev = 0, limit = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    const size_t per_node = k1_rk4_node_bytes<S>(*host_desc);
    int nodes = K1_NODES;
    while (nodes > 0 && nodes * per_node > (size_t)limit) --nodes;
    if (nodes == 0) return (int)cudaErrorInvalidValue;
    const size_t smem = nodes * per_node;
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    if (N > 0)
      kernel<<<(N + nodes - 1) / nodes, 32 * nodes, smem, (cudaStream_t)stream>>>(
          (const ModelDesc*)desc, N, T, nodes, x, s, node_par, glob_par, cost, xnext, Fx, Fu,
          Lx, Lu, Lxx, Lxu, Luu);
    return (int)cudaGetLastError();
  }
  const size_t smem = k1_smem_bytes<S>(k1_layout(*host_desc));
  const auto kernel = contact_path(*host_desc) ? &node_kernel<S, true> : &node_kernel<S, false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (N > 0)
    kernel<<<(N + K1_NODES - 1) / K1_NODES, 32 * K1_NODES, smem, (cudaStream_t)stream>>>(
        (const ModelDesc*)desc, N, T, x, s, node_par, glob_par, cost, xnext,
        Fx, Fu, Lx, Lu, Lxx, Lxu, Luu);
  return (int)cudaGetLastError();
}

// the shared memory of the smallest block launch_node launches on the spec
// (one node on an RK4 spec, K1_NODES otherwise) and the device's opt-in
// limit a block (0 when it cannot be read)
template <class S>
static long long node_smem(const ModelDesc* hd, int* limit) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    *limit = 0;
  return (long long)(hd->integrator == EM_RK4 ? k1_rk4_node_bytes<S>(*hd)
                                              : k1_smem_bytes<S>(k1_layout(*hd)));
}

extern "C" {

int eagle_desc_size() { return (int)sizeof(ModelDesc); }

long long eagle_node_smem_f32(const void* host_desc, int* limit) {
  return node_smem<float>((const ModelDesc*)host_desc, limit);
}

long long eagle_node_smem_f64(const void* host_desc, int* limit) {
  return node_smem<double>((const ModelDesc*)host_desc, limit);
}

int eagle_node_f32(const void* desc, const void* host_desc, int N, int T, const float* x, const float* s,
                   const float* node_par, const float* glob_par, float* cost,
                   float* xnext, float* Fx, float* Fu, float* Lx, float* Lu,
                   float* Lxx, float* Lxu, float* Luu, void* stream) {
  return launch_node<float>(desc, (const ModelDesc*)host_desc, N, T, x, s,
                            node_par, glob_par, cost, xnext, Fx, Fu, Lx, Lu,
                            Lxx, Lxu, Luu, stream);
}

int eagle_node_f64(const void* desc, const void* host_desc, int N, int T, const double* x, const double* s,
                   const double* node_par, const double* glob_par, double* cost,
                   double* xnext, double* Fx, double* Fu, double* Lx, double* Lu,
                   double* Lxx, double* Lxu, double* Luu, void* stream) {
  return launch_node<double>(desc, (const ModelDesc*)host_desc, N, T, x, s,
                             node_par, glob_par, cost, xnext, Fx, Fu, Lx, Lu,
                             Lxx, Lxu, Luu, stream);
}

}  // extern "C"
