// K3: regularized Riccati backward pass for a batch of problems.
//
// Replaces the TPU kernel eagle_mpc_tpu/ops/riccati_pallas.py::_node_kernel
// (pallas_call at riccati_pallas.py:301, driven by _pallas_backward).
//
// Per problem b, a reverse loop over the T running nodes carries (Vx, Vxx):
//   Qx = Lx + Fx'Vx, Qu = Lu + Fu'Vx, Qxx = Lxx + Fx'VxxFx,
//   Qux = Lxu' + Fu'VxxFx, Quu = Luu + Fu'VxxFu + (ureg + 100 eps max|diag|) I,
//   Cholesky of Quu -> k = Quu^-1 Qu, K = Quu^-1 Qux, Quuk = Quu k,
//   Vx = Qx + K'Quuk - 2 K'Qu (+ Vxx f with the new Vxx when infeasible),
//   Vxx = sym(Qxx - Qux'K) + xreg I.
// A Quu that is not positive definite gives NaN (the square root of a
// negative pivot), which flows into k, K and Vx; the solver reads it as a
// failed pass. Nothing clamps or guards the pivot.
//
// The escalating entry runs the reference's regularization do-while per
// problem inside the launch: a pass is ok when k, K and Vx as written and
// the terminal VxT are all finite (a shared flag that any thread storing a
// non-finite entry clears, read after the sweep); a failed
// pass with finite derivatives and xreg < reg_max sets xreg and ureg to
// min(reg * reg_factor, reg_max), rebuilds VxxT = LxxT + xreg I and VxT =
// LxT (+ VxxT fT where infeasible) in shared memory and sweeps again, the
// operands streaming in again through the same prefetch. The first pass
// reads the terminal value the host built, so a problem that does not
// retry gets the plain entry's result bit for bit.
//
// What bounds it on an H100: latency. The bytes (every operand read once,
// every output written once: 97 MB in f32 at B=512, T=29) would take
// 0.029 ms at 3.35 TB/s; the work is 29 dependent nodes per problem, each
// a chain of small products (about 40 kFLOP), a 9-column factor and two
// triangular solves, and 512 problems put only about 4 on each SM. Tensor
// cores are not the lever: the main path stays in full f32 (TF32 off), the
// products are 18 x 18 x 27 inside a sequential recursion, and a wgmma
// tile would be mostly padding.
//
// Design, against the latency of one node:
// - A problem per group of four warps, up to RC_MAX_PPB problems per
//   block (the launcher fits as many as the device's shared memory per
//   block takes: rc_layout gives one problem's bytes). Warp w of a block
//   serves problem w % ppb, so the problems' first warps sit on different
//   schedulers. Each group synchronizes on its own named barrier
//   (bar.sync 1 + problem), never on the block; the groups of a ragged
//   last block exit.
// - The node operands (Fx, Fu, Lxx, Lxu, Luu, Lx, Lu, f: 1098 values at the
//   flagship) are copied into shared memory with cp.async one node ahead,
//   double-buffered, as Z = [Fx Fu] and [[Lxx, .], [Lxu', Luu]]: the other
//   warps issue node t-1's copies while the first warp factors node t, and
//   no phase reads an operand from device memory.
// - One product, then one triangle: [G; q'] = [Vxx Vx]'Z ((ndx+1) x nz),
//   then the lower triangle of Z'G, which holds Qxx, Qux and Quu. This
//   relies on Vxx being symmetric on entry (G = Vxx'Z is read as Vxx Z, and
//   the upper triangle of Z'VxxZ as the mirror of the lower): the terminal
//   VxxT = LxxT + xreg I with LxxT a Gauss-Newton product R'WR, and every
//   node writes the lower triangle of sym(Qxx) - Qux'K to both halves.
// - Every product is split into register tiles, one per thread: each step
//   of the shared depth loads TA + TB values and issues TA x TB independent
//   FMAs, so a thread's chain is the depth, not depth x tiles. Tiles read
//   past a matrix's last column and discard those entries, so their loads
//   need no bounds.
// - The PD floor (a warp max-reduction of |diag Quu|), the Cholesky (a
//   row per lane in registers, the pivot and L(k,j) broadcast by
//   __shfl_sync), the ndx + 1 triangular solves (a right-hand side per lane
//   in registers) and Vx run on the group's first warp, compiled for each
//   nu up to RC_MAX_NU so that every loop is unrolled. The pivot's 1/sqrt
//   is correctly rounded in both types, so the f64 parity gate checks the
//   code f32 runs.
// - The escalation is per group: each problem's warps stop as soon as its
//   pass is ok, with no block-wide barrier (the groups of a block run
//   different numbers of passes).
// - The phases are __noinline__ (nvcc 12.8 miscompiled fully inlined K1
//   code twice); they address shared memory through the one dynamic array
//   rc_smem_raw and integer offsets, so their loads stay shared loads.
#include <cuda_runtime.h>

#include <cstddef>

#define RC_NT 128          // threads per problem: four warps (1, 2 and 4 timed: PERF.md)
#define RC_MAX_PPB 4       // problems per block at most
#define RC_MAX_NU 12       // controls at most
#define RC_PAD 32          // slack at the end of a problem's region (tile over-reads)
// the threads that copy the operands: all but the first warp, which
// factors meanwhile
#define RC_PF_NT (RC_NT - 32)

// register tiles: RC_TG_A x RC_TG_B of [G; q'], RC_TT x RC_TT of the triangles
#define RC_TG_A 3
#define RC_TG_B 2
#define RC_TT 2

// Offsets, in elements, of one node's operand buffer and of one problem's
// region of shared memory.
struct RcLayout {
  int ndx, nu, nz, nv;
  int z, lzz, l, f, opl;                 // in an operand buffer
  int op, vv, g, qv, q, lf, x, flag, per;  // in a problem's region
};

__host__ __device__ inline RcLayout rc_layout(int ndx, int nu) {
  RcLayout y;
  y.ndx = ndx, y.nu = nu, y.nz = ndx + nu, y.nv = ndx + 1;
  y.z = 0;                      // Z = [Fx Fu], (ndx, nz)
  y.lzz = y.z + ndx * y.nz;     // [[Lxx, .], [Lxu', Luu]], (nz, nz)
  y.l = y.lzz + y.nz * y.nz;    // [Lx; Lu]
  y.f = y.l + y.nz;
  y.opl = y.f + ndx;
  y.op = 0;                     // two operand buffers
  y.vv = y.op + 2 * y.opl;      // [Vxx Vx], (ndx, ndx + 1)
  y.g = y.vv + ndx * y.nv;      // [G; q'] = [Vxx Vx]'Z, (ndx + 1, nz)
  y.qv = y.g + y.nv * y.nz;     // [Qx; Qu]
  y.q = y.qv + y.nz;            // [[Qxx, .], [Qux, Quu]], (nz, nz)
  y.lf = y.q + y.nz * y.nz;     // Cholesky factor of Quu, (nu, nu)
  y.x = y.lf + nu * nu;         // [K | k], (nu, ndx + 1)
  y.flag = y.x + nu * y.nv;     // the escalation's two ok flags, an int a slot
  y.per = y.flag + 2 + RC_PAD;
  return y;
}

extern __shared__ __align__(16) unsigned char rc_smem_raw[];

template <class S>
__device__ __forceinline__ S* rc_smem(int off) {
  return reinterpret_cast<S*>(rc_smem_raw) + off;
}

// the problem's named barrier (id 0 is the block's)
__device__ __forceinline__ void rc_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(RC_NT) : "memory");
}

template <class S>
__device__ __forceinline__ void cp_async_elem(S* smem, const S* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem),
               "n"(sizeof(S)));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// not NaN or infinite, from the exponent bits (no compiler flag changes it)
__device__ __forceinline__ bool rc_finite(float v) {
  return (__float_as_uint(v) & 0x7f800000u) != 0x7f800000u;
}
__device__ __forceinline__ bool rc_finite(double v) {
  return (__double_as_longlong(v) & 0x7ff0000000000000ll) != 0x7ff0000000000000ll;
}

// 1 / sqrt(x) from the correctly rounded square root and division, the
// same code in both types; NaN for x < 0
template <class S>
__device__ __forceinline__ S rc_rsqrt(S x) { return S(1) / sqrt(x); }

// (i, j <= i) of entry e of a lower triangle stored row by row
__device__ __forceinline__ void rc_tri(int e, int& i, int& j) {
  const float v = 8.0f * (float)e + 1.0f;
  i = (int)((v * rsqrtf(v) - 1.0f) * 0.5f);
  while (i * (i + 1) / 2 > e) --i;
  while ((i + 1) * (i + 2) / 2 <= e) ++i;
  j = e - i * (i + 1) / 2;
}

// acc[a][b] = sum_d A[d lda + a] Bm[d ldb + b]: A and Bm point at the tile's
// first column; entries past a matrix's last column are read (from the
// next row or array of the problem's region) and discarded by the caller
template <class S, int TA, int TB>
__device__ __forceinline__ void rc_tile(const S* A, int lda, const S* Bm, int ldb,
                                        int depth, S (&acc)[TA][TB]) {
#pragma unroll
  for (int a = 0; a < TA; ++a)
#pragma unroll
    for (int b = 0; b < TB; ++b) acc[a][b] = S(0);
#pragma unroll 2
  for (int d = 0; d < depth; ++d) {
    S x[TA], y[TB];
#pragma unroll
    for (int a = 0; a < TA; ++a) x[a] = A[a];
#pragma unroll
    for (int b = 0; b < TB; ++b) y[b] = Bm[b];
#pragma unroll
    for (int a = 0; a < TA; ++a)
#pragma unroll
      for (int b = 0; b < TB; ++b) acc[a][b] = acc[a][b] + x[a] * y[b];
    A += lda;
    Bm += ldb;
  }
}

// a thread's walk over a row-major (rows, cols) array, `step` entries at a
// time: its first (row, column) and its step in rows and columns
struct RcWalk {
  int r0, c0, dr, dc;
};

__device__ inline RcWalk rc_walk(int cols, int t, int step) {
  return {t / cols, t % cols, step / cols, step % cols};
}

// src (rows, cols), contiguous -> dst with row stride ld (transposed: dst
// column r holds row r)
template <class S>
__device__ __forceinline__ void rc_copy(S* dst, int ld, bool tr, const S* src, int rows,
                                        int cols, RcWalk w) {
  int r = w.r0, c = w.c0;
#pragma unroll 1
  while (r < rows) {
    cp_async_elem(dst + (tr ? c * ld + r : r * ld + c), src + r * cols + c);
    c += w.dc;
    r += w.dr;
    if (c >= cols) c -= cols, ++r;
  }
}

// node bt's operands into the operand buffer at `op`: Z = [Fx Fu], Lzz
// (its upper right block is never read), [Lx; Lu] and f, one element per copy
template <class S>
__device__ __noinline__ void rc_prefetch(int ndx, int nu, int op, size_t bt, int tq,
                                         RcWalk wx, RcWalk wu, const S* Fx, const S* Fu,
                                         const S* Lxx, const S* Lxu, const S* Luu,
                                         const S* Lx, const S* Lu, const S* fs) {
  const RcLayout y = rc_layout(ndx, nu);
  const int nz = y.nz;
  S* o = rc_smem<S>(op);
  const S* lxu = Lxu + bt * ndx * nu;
  rc_copy<S>(o + y.z, nz, false, Fx + bt * ndx * ndx, ndx, ndx, wx);
  rc_copy<S>(o + y.z + ndx, nz, false, Fu + bt * ndx * nu, ndx, nu, wu);
  rc_copy<S>(o + y.lzz, nz, false, Lxx + bt * ndx * ndx, ndx, ndx, wx);
  rc_copy<S>(o + y.lzz + ndx * nz, nz, true, lxu, ndx, nu, wu);
  rc_copy<S>(o + y.lzz + ndx * nz + ndx, nz, false, Luu + bt * nu * nu, nu, nu, wu);
#pragma unroll 1
  for (int i = tq; i < nz + ndx; i += RC_PF_NT)
    cp_async_elem(o + y.l + i, i < ndx ? Lx + bt * ndx + i
                               : i < nz ? Lu + bt * nu + (i - ndx) : fs + bt * ndx + (i - nz));
}

// [G; q'] = [Vxx Vx]'Z, a RC_TG_A x RC_TG_B tile per thread
template <class S>
__device__ __noinline__ void rc_product_g(int ndx, int nu, int base, int buf, int tp) {
  const RcLayout y = rc_layout(ndx, nu);
  S* sm = rc_smem<S>(base);
  const int nz = y.nz, nbj = (nz + RC_TG_B - 1) / RC_TG_B;
  const int ntiles = ((y.nv + RC_TG_A - 1) / RC_TG_A) * nbj;
  for (int t = tp; t < ntiles; t += RC_NT) {
    const int i0 = (t / nbj) * RC_TG_A, j0 = (t % nbj) * RC_TG_B;
    S acc[RC_TG_A][RC_TG_B];
    rc_tile<S, RC_TG_A, RC_TG_B>(sm + y.vv + i0, y.nv, sm + buf + y.z + j0, nz, ndx, acc);
#pragma unroll
    for (int a = 0; a < RC_TG_A; ++a)
#pragma unroll
      for (int b = 0; b < RC_TG_B; ++b)
        if (i0 + a < y.nv && j0 + b < nz) sm[y.g + (i0 + a) * nz + j0 + b] = acc[a][b];
  }
}

// [Qx; Qu] = [Lx; Lu] + q, and Q = Lzz + Z'G from the lower triangle of
// Z'G, a RC_TT x RC_TT tile per thread (the upper right block, Qxu, is
// left unread)
template <class S>
__device__ __noinline__ void rc_product_q(int ndx, int nu, int base, int buf, int tp) {
  const RcLayout y = rc_layout(ndx, nu);
  S* sm = rc_smem<S>(base);
  const S* op = sm + buf;
  const S* Lzz = op + y.lzz;
  S* Q = sm + y.q;
  const int nz = y.nz, nb = (nz + RC_TT - 1) / RC_TT;
  for (int c = tp; c < nz; c += RC_NT) sm[y.qv + c] = op[y.l + c] + sm[y.g + ndx * nz + c];
  for (int t = tp; t < nb * (nb + 1) / 2; t += RC_NT) {
    int bi, bj;
    rc_tri(t, bi, bj);
    const int i0 = bi * RC_TT, j0 = bj * RC_TT;
    S acc[RC_TT][RC_TT];
    rc_tile<S, RC_TT, RC_TT>(op + y.z + i0, nz, sm + y.g + j0, nz, ndx, acc);
#pragma unroll
    for (int a = 0; a < RC_TT; ++a)
#pragma unroll
      for (int b = 0; b < RC_TT; ++b) {
        const int i = i0 + a, j = j0 + b;
        if (i < nz && j <= i) {
          Q[i * nz + j] = Lzz[i * nz + j] + acc[a][b];
          Q[j * nz + i] = Lzz[j * nz + i] + acc[a][b];
        }
      }
  }
}

// On the group's first warp, with nu = NU known at compile time:
// - the PD floor, a warp max-reduction of |diag Quu|;
// - the Cholesky factor, lane i holding row i in registers: step j takes
//   the pivot from lane j and L(k,j) from lane k by __shfl_sync; a
//   negative pivot makes its 1/sqrt NaN;
// - [K | k] = Quu^-1 [Qux | Qu], a right-hand side per lane in registers,
//   L from shared memory;
// - Quuk = Quu k, Vx = Qx + K'Quuk - 2 K'Qu, and the stores of k, K, Qu
//   and Quuk. Returns whether the k and K entries this lane stored are
//   finite.
template <class S, int NU>
__device__ __noinline__ bool rc_factor_solve(int ndx, int base, int lane, S rel_eps,
                                             S ureg, size_t bt, S* k_o, S* K_o, S* Qu_o,
                                             S* Quuk_o) {
  const RcLayout y = rc_layout(ndx, NU);
  S* sm = rc_smem<S>(base);
  const S* Quu = sm + y.q + ndx * y.nz + ndx;   // row stride nz
  const S* qv = sm + y.qv;
  S* Lf = sm + y.lf;
  const int nz = y.nz, nv = y.nv;
  const bool row = lane < NU, rhs = lane <= ndx;
  const unsigned all = 0xffffffffu;
  S mx = row ? Quu[lane * nz + lane] : S(0);
  mx = mx < S(0) ? -mx : mx;
  for (int o = 16; o > 0; o >>= 1) {
    const S other = __shfl_xor_sync(all, mx, o);
    mx = other > mx ? other : mx;
  }
  const S shift = ureg + rel_eps * mx;
  S q[NU], a[NU], x[NU], inv_d[NU];
#pragma unroll
  for (int k = 0; k < NU; ++k) {
    q[k] = row ? Quu[lane * nz + k] + (k == lane ? shift : S(0)) : S(0);
    a[k] = q[k];
    x[k] = rhs ? (lane < ndx ? sm[y.q + (ndx + k) * nz + lane] : qv[ndx + k]) : S(0);
  }
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    const S p = __shfl_sync(all, a[j], j);
    inv_d[j] = rc_rsqrt(p);
    const S l = lane == j ? p * inv_d[j] : a[j] * inv_d[j];
    a[j] = l;
#pragma unroll
    for (int k = j + 1; k < NU; ++k) a[k] = a[k] - l * __shfl_sync(all, l, k);
  }
  if (row) {
#pragma unroll
    for (int k = 0; k < NU; ++k) Lf[lane * NU + k] = a[k];
  }
  __syncwarp();
  // L z = b a column at a time, then L'x = z
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    x[i] = x[i] * inv_d[i];
#pragma unroll
    for (int r = i + 1; r < NU; ++r) x[r] = x[r] - Lf[r * NU + i] * x[i];
  }
#pragma unroll
  for (int i = NU - 1; i >= 0; --i) {
    x[i] = x[i] * inv_d[i];
#pragma unroll
    for (int r = 0; r < i; ++r) x[r] = x[r] - Lf[i * NU + r] * x[i];
  }
  // k from lane ndx; Quuk_p = row p of Quu times k, on lane p
  S quuk = S(0), kp = S(0);
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    const S kj = __shfl_sync(all, x[j], ndx);
    quuk = quuk + q[j] * kj;
    if (j == lane) kp = kj;
  }
  S a1 = S(0), a2 = S(0);
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    const S quuk_i = __shfl_sync(all, quuk, i);
    a1 = a1 + x[i] * quuk_i;
    a2 = a2 + x[i] * qv[ndx + i];
  }
  if (rhs) {
#pragma unroll
    for (int i = 0; i < NU; ++i) sm[y.x + i * nv + lane] = x[i];
  }
  bool fin = true;
  if (lane < ndx) {
    sm[y.vv + lane * nv + ndx] = qv[lane] + a1 - S(2) * a2;
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      K_o[(bt * NU + i) * ndx + lane] = x[i];
      fin = fin && rc_finite(x[i]);
    }
  }
  if (row) {
    k_o[bt * NU + lane] = kp;
    Qu_o[bt * NU + lane] = qv[ndx + lane];
    Quuk_o[bt * NU + lane] = quuk;
    fin = fin && rc_finite(kp);
  }
  return fin;
}

// Vxx = sym(Qxx) - Qux'K + xreg I from the lower triangle of Qux'K, a
// RC_TT x RC_TT tile per thread, written to both halves
template <class S>
__device__ __noinline__ void rc_value(int ndx, int nu, int base, int tp, S xreg) {
  const RcLayout y = rc_layout(ndx, nu);
  S* sm = rc_smem<S>(base);
  const S* Q = sm + y.q;
  S* VV = sm + y.vv;
  const int nz = y.nz, nv = y.nv, nb = (ndx + RC_TT - 1) / RC_TT;
  for (int t = tp; t < nb * (nb + 1) / 2; t += RC_NT) {
    int bi, bj;
    rc_tri(t, bi, bj);
    const int i0 = bi * RC_TT, j0 = bj * RC_TT;
    S acc[RC_TT][RC_TT];
    rc_tile<S, RC_TT, RC_TT>(Q + ndx * nz + i0, nz, sm + y.x + j0, nv, nu, acc);
#pragma unroll
    for (int a = 0; a < RC_TT; ++a)
#pragma unroll
      for (int b = 0; b < RC_TT; ++b) {
        const int i = i0 + a, j = j0 + b;
        if (i < ndx && j <= i) {
          const S v = S(0.5) * (Q[i * nz + j] + Q[j * nz + i]) - acc[a][b]
                      + (i == j ? xreg : S(0));
          VV[i * nv + j] = v;
          VV[j * nv + i] = v;
        }
      }
  }
}

// the gap term with the new Vxx, and the value function's stores (Vxx as
// one contiguous run, walked by `w`); returns whether the Vx entry this
// thread stored is finite
template <class S>
__device__ __noinline__ bool rc_gap_store(int ndx, int nu, int base, int buf, int tp,
                                          RcWalk w, bool infeasible, size_t bt, S* Vx_o,
                                          S* Vxx_o) {
  const RcLayout y = rc_layout(ndx, nu);
  S* sm = rc_smem<S>(base);
  const S* f = sm + buf + y.f;
  S* VV = sm + y.vv;
  const int nv = y.nv;
  bool fin = true;
  if (tp < ndx) {
    S v = VV[tp * nv + ndx];
    if (infeasible) {
      S acc = S(0);
      for (int j = 0; j < ndx; ++j) acc = acc + VV[tp * nv + j] * f[j];
      v = v + acc;
      VV[tp * nv + ndx] = v;
    }
    Vx_o[bt * ndx + tp] = v;
    fin = rc_finite(v);
  }
  S* out = Vxx_o + bt * ndx * ndx;
  int r = w.r0, c = w.c0;
#pragma unroll 1
  while (r < ndx) {
    out[r * ndx + c] = VV[r * nv + c];
    c += w.dc;
    r += w.dr;
    if (c >= ndx) c -= ndx, ++r;
  }
  return fin;
}

// the escalation's inputs and outputs; passes_o null: no escalation
template <class S>
struct RcEscalation {
  const S* LxT;                     // (B, ndx) terminal cost gradient
  const S* LxxT;                    // (B, ndx, ndx) terminal cost Hessian
  const S* fT;                      // (B, ndx) terminal gap
  const unsigned char* derivs_ok;   // (B,) the node derivatives are finite
  S factor, hi;                     // reg_factor, reg_max
  int max_retries;
  S* xreg_o;                        // (B,) the last pass's regularizations
  S* ureg_o;
  unsigned char* ok_o;              // (B,) the last pass is ok
  int* passes_o;                    // (B,) passes run
};

// a retry's terminal value, row tp of it per thread: VxxT = LxxT + xreg I
// and VxT = LxT (+ VxxT fT where infeasible), into [Vxx Vx] and over the
// global VxT and VxxT
template <class S>
__device__ __noinline__ void rc_terminal(int ndx, int nu, int base, int tp, S xr,
                                         bool infeasible, size_t b, const S* LxT,
                                         const S* LxxT, const S* fT, S* VxT, S* VxxT) {
  if (tp >= ndx) return;
  const RcLayout y = rc_layout(ndx, nu);
  S* VV = rc_smem<S>(base + y.vv) + tp * y.nv;
  const S* lxx = LxxT + (b * ndx + tp) * ndx;
  const S* f = fT + b * ndx;
  S* vxx = VxxT + (b * ndx + tp) * ndx;
  S acc = S(0);
  for (int j = 0; j < ndx; ++j) {
    const S v = lxx[j] + (j == tp ? xr : S(0));
    VV[j] = v;
    vxx[j] = v;
    acc = acc + v * f[j];
  }
  const S v = LxT[b * ndx + tp] + (infeasible ? acc : S(0));
  VV[ndx] = v;
  VxT[b * ndx + tp] = v;
}

// ESC: the escalating entry (esc's pointers set); without it the kernel
// is the one pass
template <class S, bool ESC>
__global__ void __launch_bounds__(RC_MAX_PPB * RC_NT)
riccati_kernel(int B, int T, int ndx, int nu, S rel_eps,
               const S* __restrict__ Fx, const S* __restrict__ Fu,
               const S* __restrict__ Lx, const S* __restrict__ Lu,
               const S* __restrict__ Lxx, const S* __restrict__ Lxu,
               const S* __restrict__ Luu, const S* __restrict__ fs,
               S* VxT, S* VxxT,
               const S* __restrict__ xreg, const S* __restrict__ ureg,
               const unsigned char* __restrict__ feasible,
               S* k_o, S* K_o, S* Qu_o, S* Quuk_o, S* Vx_o, S* Vxx_o,
               const RcEscalation<S> esc) {
  // warp w serves problem w % ppb, so the first warps of the block's
  // problems (which factor alone) sit on different schedulers
  const int ppb = blockDim.x / RC_NT, w = threadIdx.x / 32;
  const int p = w % ppb, tp = (w / ppb) * 32 + threadIdx.x % 32;
  const int b = blockIdx.x * ppb + p;
  if (b >= B) return;   // a ragged last block: the group has no problem
  const RcLayout y = rc_layout(ndx, nu);
  const int base = p * y.per, bar = 1 + p;
  S xr = xreg[b], ur = ureg[b];
  const bool infeasible = feasible[b] == 0;
  const bool copier = tp >= 32;
  const int tq = copier ? tp - 32 : 0;
  const RcWalk wx = rc_walk(ndx, tq, RC_PF_NT), wu = rc_walk(nu, tq, RC_PF_NT);
  const RcWalk wv = rc_walk(ndx, tp, RC_NT);

  S* VV = rc_smem<S>(base + y.vv);
  for (int r = 0; r < ndx; ++r)
    for (int c = tp; c <= ndx; c += RC_NT)
      cp_async_elem(VV + r * y.nv + c, c < ndx ? VxxT + ((size_t)b * ndx + r) * ndx + c
                                               : VxT + (size_t)b * ndx + r);
  // the escalation's ok flags, flag[(passes - 1) & 1] for a pass: set to 1
  // by thread 0 before the pass's first barrier, cleared after it by any
  // thread that stored a value of k, K or Vx that is not finite, or whose
  // entry of VxT is not, read by all after the pass's last barrier
  volatile int* flag = reinterpret_cast<volatile int*>(rc_smem<S>(base + y.flag));
  int passes = 1;
  if (ESC && tp == 0) flag[0] = 1;
  for (;;) {
    if (copier)
      rc_prefetch<S>(ndx, nu, base + y.op + ((T - 1) & 1) * y.opl, (size_t)b * T + T - 1, tq,
                     wx, wu, Fx, Fu, Lxx, Lxu, Luu, Lx, Lu, fs);
    cp_async_commit();

    for (int t = T - 1; t >= 0; --t) {
      const size_t bt = (size_t)b * T + t;
      const int buf = y.op + (t & 1) * y.opl;
      const int next = y.op + ((t - 1) & 1) * y.opl;
      // node t's copies have landed, and every thread is done with node t+1,
      // whose buffer node t-1's copies reuse
      cp_async_wait_all();
      rc_sync(bar);
      rc_product_g<S>(ndx, nu, base, buf, tp);
      rc_sync(bar);
      rc_product_q<S>(ndx, nu, base, buf, tp);
      rc_sync(bar);
      if (tp < 32) {
        bool fin = true;
        switch (nu) {
#define RC_FACTOR(N)                                                                  \
  case N:                                                                             \
    fin = rc_factor_solve<S, N>(ndx, base, tp, rel_eps, ur, bt, k_o, K_o, Qu_o, Quuk_o); \
    break;
          RC_FACTOR(1) RC_FACTOR(2) RC_FACTOR(3) RC_FACTOR(4) RC_FACTOR(5) RC_FACTOR(6)
          RC_FACTOR(7) RC_FACTOR(8) RC_FACTOR(9) RC_FACTOR(10) RC_FACTOR(11) RC_FACTOR(12)
#undef RC_FACTOR
        }
        if (ESC && !fin) flag[(passes - 1) & 1] = 0;
      } else {
        if (t > 0)
          rc_prefetch<S>(ndx, nu, base + next, bt - 1, tq, wx, wu, Fx, Fu, Lxx, Lxu, Luu, Lx,
                         Lu, fs);
        cp_async_commit();
      }
      rc_sync(bar);
      rc_value<S>(ndx, nu, base, tp, xr);
      rc_sync(bar);
      const bool fin = rc_gap_store<S>(ndx, nu, base, buf, tp, wv, infeasible, bt, Vx_o, Vxx_o);
      if (ESC && !fin) flag[(passes - 1) & 1] = 0;
    }
    if (!ESC) break;
    const int lv = (passes - 1) & 1;
    // VxT as this pass read it (this thread wrote it if the pass retried)
    if (tp < ndx && !rc_finite(VxT[(size_t)b * ndx + tp])) flag[lv] = 0;
    // every thread is past node 0 after this barrier, so the flag is
    // final and the terminal and the operand buffers may be written again
    rc_sync(bar);
    const bool ok = flag[lv] != 0;
    if (ok || !esc.derivs_ok[b] || !(xr < esc.hi) || passes > esc.max_retries) {
      if (tp == 0) {
        esc.xreg_o[b] = xr;
        esc.ureg_o[b] = ur;
        esc.ok_o[b] = ok ? 1 : 0;
        esc.passes_o[b] = passes;
      }
      break;
    }
    // the next pass's flag: its readers of two passes ago are past this
    // pass's barriers
    if (tp == 0) flag[lv ^ 1] = 1;
    // torch.clamp(reg * f, max=hi)
    xr = xr * esc.factor;
    xr = xr > esc.hi ? esc.hi : xr;
    ur = ur * esc.factor;
    ur = ur > esc.hi ? esc.hi : ur;
    ++passes;
    rc_terminal<S>(ndx, nu, base, tp, xr, infeasible, b, esc.LxT, esc.LxxT, esc.fT, VxT, VxxT);
  }
}

template <class S>
static int launch_riccati(int B, int T, int ndx, int nu, S rel_eps, const S* Fx,
                          const S* Fu, const S* Lx, const S* Lu, const S* Lxx,
                          const S* Lxu, const S* Luu, const S* fs, S* VxT, S* VxxT,
                          const S* xreg, const S* ureg, const unsigned char* feasible,
                          S* k, S* K, S* Qu, S* Quuk, S* Vx, S* Vxx,
                          const RcEscalation<S>& esc, void* stream) {
  // the solves take the ndx + 1 right-hand sides on one warp
  if (ndx < 1 || ndx + 1 > 32 || nu < 1 || nu > RC_MAX_NU)
    return (int)cudaErrorInvalidValue;
  // as many problems per block as the device's opt-in shared memory takes
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t per = (size_t)rc_layout(ndx, nu).per * sizeof(S);
  const int ppb = (int)(RC_MAX_PPB < optin / per ? RC_MAX_PPB : optin / per);
  if (ppb < 1) return (int)cudaErrorInvalidValue;
  const int smem = (int)(ppb * per);
  const bool escalating = esc.passes_o != nullptr;
  auto kernel = escalating ? riccati_kernel<S, true> : riccati_kernel<S, false>;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (B > 0 && T > 0)
    kernel<<<(B + ppb - 1) / ppb, ppb * RC_NT, smem, (cudaStream_t)stream>>>(
        B, T, ndx, nu, rel_eps, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs, VxT, VxxT, xreg,
        ureg, feasible, k, K, Qu, Quuk, Vx, Vxx, esc);
  return (int)cudaGetLastError();
}

// the C entries: eagle_riccati_<prec> one pass, eagle_riccati_escalating_<prec>
// the pass with the regularization escalation, which writes each retried
// problem's last terminal value over VxT and VxxT
#define RC_ENTRIES(S, P)                                                                 \
  int eagle_riccati_##P(int B, int T, int ndx, int nu, S rel_eps, const S* Fx,         \
                        const S* Fu, const S* Lx, const S* Lu, const S* Lxx,           \
                        const S* Lxu, const S* Luu, const S* fs, const S* VxT,         \
                        const S* VxxT, const S* xreg, const S* ureg,                   \
                        const unsigned char* feasible, S* k, S* K, S* Qu, S* Quuk,     \
                        S* Vx, S* Vxx, void* stream) {                                 \
    const RcEscalation<S> none = {};                                                    \
    return launch_riccati<S>(B, T, ndx, nu, rel_eps, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs, \
                             const_cast<S*>(VxT), const_cast<S*>(VxxT), xreg, ureg,     \
                             feasible, k, K, Qu, Quuk, Vx, Vxx, none, stream);         \
  }                                                                                     \
  int eagle_riccati_escalating_##P(                                                     \
      int B, int T, int ndx, int nu, S rel_eps, const S* Fx, const S* Fu, const S* Lx,  \
      const S* Lu, const S* Lxx, const S* Lxu, const S* Luu, const S* fs, S* VxT,      \
      S* VxxT, const S* xreg, const S* ureg, const unsigned char* feasible, S* k, S* K, \
      S* Qu, S* Quuk, S* Vx, S* Vxx, const S* LxT, const S* LxxT, const S* fT,         \
      const unsigned char* derivs_ok, S reg_factor, S reg_max, int max_retries,         \
      S* xreg_o, S* ureg_o, unsigned char* ok_o, int* passes_o, void* stream) {         \
    const RcEscalation<S> esc = {LxT,    LxxT,   fT,   derivs_ok, reg_factor, reg_max,  \
                                 max_retries, xreg_o, ureg_o, ok_o, passes_o};          \
    return launch_riccati<S>(B, T, ndx, nu, rel_eps, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs, \
                             VxT, VxxT, xreg, ureg, feasible, k, K, Qu, Quuk, Vx, Vxx,  \
                             esc, stream);                                              \
  }

extern "C" {

RC_ENTRIES(float, f32)
RC_ENTRIES(double, f64)

}  // extern "C"
