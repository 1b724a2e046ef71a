// K2: line-search rollouts for every (problem, alpha) lane.
//
// Replaces the TPU kernel eagle_mpc_tpu/ops/rollout_pallas.py::_rollout_kernel
// (pallas_call at rollout_pallas.py:170, built by _rollout_builder).
//
// Per lane (b, a), sequential over the T running nodes with the state
// carried from x0[b]:
//   x_try = keep ? x (+) f_t (alpha - 1) : x       (gap contraction)
//   u_try = u_t - alpha k_t - K_t (x_t^-1 x_try)   (feedback law; with box,
//           clipped to [s_lb, s_ub], the Box-DDP rollout)
//   x     = dyn_next(x_try, u_try)                 (squash, dynamics, Euler
//                                                   or RK4)
//   c_t   = running cost at (x_try, u_try)         (RK4: its quadrature over
//                                                   the four stage points)
// Outputs xs_try (B, A, T, nx), us_try (B, A, T, nu), cs (B, A, T) and the
// state after the last node, xn (B, A, nx). The terminal node and the
// divergence checks stay in PyTorch (solvers/fddp.py).
//
// Design: one block per problem b; in it one group of RO_G = 8 threads per
// alpha lane (A * RO_G threads, rounded up to whole warps; the groups past
// A compute lane A-1 again and store nothing). Eight, not a warp: at B=512
// and A=10 the 512 blocks of 96 threads are all resident at once on 132
// SMs (about 4 blocks, 12 warps each), where warp-sized groups (320
// threads a block) would run in about four waves; the four groups of a
// warp run the same instructions on different alphas, so they share its
// issue slots without diverging.
// - The per-node operands every alpha of b reads (x_t, u_t, k_t, K_t, f_t
//   and the node parameter row, about 320 values at the flagship) are
//   loaded once per block into shared memory with cp.async, double-
//   buffered: node t+1's copies are in flight while node t computes. The
//   problem's global row is loaded once.
// - Each step is coop_dyn_next (model.cuh), the cooperative node step:
//   the feedback law and the squash a control row per thread, the body
//   placements and forces a body per thread, the CRBA's 6x6 transforms an
//   entry per thread, the mass matrix a joint column per thread, the
//   Cholesky factor a column per barrier; the chains down and up the tree,
//   the solve and the Euler step on the group's first thread, while the
//   other threads take the running cost a slot each. A frame slot's
//   thread computes the kinematics of the frame's chain from x_try itself
//   (model.cuh frame_residual), so it reads nothing the first thread is
//   still writing. The group's working set lives in shared memory.
// - A contact spec adds the contact rows (on the group's last threads,
//   beside the body forces), M^-1 Jm^T a row per thread, and one barrier
//   before the KKT solve on the first thread; a friction-cone slot reads
//   the forces, so the first thread, which owns them, takes it after the
//   solve. Each group's CoopContact is allocated for a contact spec only:
//   a free-flight spec pays neither its shared memory nor its barrier.
// - An RK4 spec runs coop_dam, the dynamics pass, four times a node step,
//   at y0 = x_try and the stage points y1..y3 that the group's first
//   thread puts into the working set's state between the passes
//   (model.cuh rk4_stage); the cost threads of each pass take the slots at
//   that pass's stage point, weighted dt/6, dt/3, dt/3, dt/6. On a contact
//   spec each pass also runs the contact rows at its stage point, the
//   masked KKT solve and, on the first thread, the friction cone's cost
//   from that stage's forces (the contact's activity is the node's at all
//   four). Each group's CoopRk4 (x_try and the k-sum) is allocated for an
//   RK4 spec only; the kernel is instantiated per integrator and per path
//   (free flight or contacts), so the Euler step's code has no RK4 branch
//   and a free-flight spec's none of the contacts.
// - xs_try and us_try leave per node as contiguous runs written by the
//   group; cs is staged for the whole horizon and leaves as one run per
//   lane.
//
// What bounds it on an H100: latency. Every node is a chain of about 35
// barrier phases through shared memory (about 4 x 30 under RK4), and the
// 29 nodes follow one another; all 512 blocks are resident at once, so the
// kernel takes one block's chain. The bytes (about 18 MB in and 17 MB out
// in f32) would take about 11 us at 3.35 TB/s.
#include <cuda_runtime.h>

#include "model.cuh"

#define RO_G 8             // threads per alpha lane
#define RO_MAX_THREADS 256

// ---------------------------------------------------------------------------
// asynchronous copies of the per-node operands
// ---------------------------------------------------------------------------

template <class S>
__device__ __forceinline__ void cp_async_elem(S* smem, const S* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem),
               "n"(sizeof(S)));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prior1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// operand row of node t: [x_t (nx), u_t (nu), k_t (nu), K_t (nu ndx),
// f_t (ndx), node parameters (node_dim)]
__host__ __device__ inline int ro_op_len(int nx, int ndx, int nu, int node_dim) {
  return nx + 2 * nu + nu * ndx + ndx + node_dim;
}

template <class S>
__device__ __forceinline__ void ro_load_node(const ModelDesc& d, int b, int t, int T,
                                             const S* xs, const S* us, const S* kff,
                                             const S* Kfb, const S* fs,
                                             const S* node_par, S* op) {
  const int nx = d.nq + d.nv, ndx = 2 * d.nv, nu = d.nu;
  const size_t bt = (size_t)b * T + t, bt1 = (size_t)b * (T + 1) + t;
  const S* src[6] = {xs + bt1 * nx, us + bt * nu, kff + bt * nu,
                     Kfb + bt * nu * ndx, fs + bt1 * ndx, node_par + bt * d.node_dim};
  const int len[6] = {nx, nu, nu, nu * ndx, ndx, d.node_dim};
  int off = 0;
  for (int sg = 0; sg < 6; ++sg) {
    for (int i = threadIdx.x; i < len[sg]; i += blockDim.x)
      cp_async_elem(op + off + i, src[sg] + i);
    off += len[sg];
  }
}

// ---------------------------------------------------------------------------
// the serial parts of a step (the group's first thread)
// ---------------------------------------------------------------------------

// an RK4 step's state beside the working set: x_try and the k-sum
template <class S>
struct CoopRk4 {
  S x[EM_MAX_NX];
  S ksum[EM_MAX_NDX];
};

// x_try (gap contraction) and the feedback's state error
template <class S>
__device__ __noinline__ void ro_gap_and_error(const ModelDesc& d, CoopNode<S>& G, const S* xs_t,
                                              const S* f_t, S alpha, bool keep) {
  const int nx = d.nq + d.nv, ndx = 2 * d.nv;
  if (keep) {
    for (int i = 0; i < ndx; ++i) G.tmp[i] = f_t[i] * (alpha - S(1));
    integrate<S, S>(d, G.xc, G.tmp, G.xt);
  } else {
    for (int i = 0; i < nx; ++i) G.xt[i] = G.xc[i];
  }
  state_diff<S, S>(d, xs_t, G.xt, G.dx);
}

// the RK4 node step of one group: (xt = x_try, usq) -> xc and the running
// cost's quadrature into *c_out (a contact spec: the constrained dynamics
// and the cone's cost at each stage point, in C)
template <class S, bool CON>
__device__ __forceinline__ void rk4_dyn_next(const ModelDesc& d, int l, CoopNode<S>& W,
                                             CoopContact<S>* C, CoopRk4<S>& R, const S* np,
                                             const S* gp, S* c_out) {
  const int nx = d.nq + d.nv;
  for (int i = l; i < nx; i += RO_G) R.x[i] = W.xt[i];
  S c = S(0);
  for (int i = 0; i < 4; ++i) {
    coop_dam<S, RO_G, CON>(d, l, W, C, np, gp, true);
    if (l == 0) {
      c = c + S(rk4_coeff(d, i)) * coop_cost_sum(d, W);
      rk4_stage<S>(d, i, R.x, W.xt, W.rhs, R.ksum, i < 3 ? W.xt : W.xc);
    }
    __syncwarp();
  }
  if (l == 0) *c_out = c;
}

template <class S, bool CON, bool RK4>
__global__ void __launch_bounds__(RO_MAX_THREADS)
rollout_kernel(const ModelDesc* __restrict__ desc, int B, int A, int T, int box,
               const S* __restrict__ xs, const S* __restrict__ us,
               const S* __restrict__ kff, const S* __restrict__ Kfb,
               const S* __restrict__ fs, const S* __restrict__ x0,
               const S* __restrict__ alphas, const unsigned char* __restrict__ keep,
               const S* __restrict__ node_par, const S* __restrict__ glob_par,
               S* xs_try, S* us_try, S* cs, S* xn_last) {
  const ModelDesc& d = *desc;
  const int b = blockIdx.x;
  const int g = threadIdx.x / RO_G, l = threadIdx.x % RO_G;
  const int ngroups = blockDim.x / RO_G;
  const bool real = g < A;
  const int a = real ? g : A - 1;
  const int nv = d.nv, nx = d.nq + nv, ndx = 2 * nv, nu = d.nu;
  const int op_len = ro_op_len(nx, ndx, nu, d.node_dim);

  extern __shared__ unsigned char smem_raw[];
  CoopNode<S>* groups = reinterpret_cast<CoopNode<S>*>(smem_raw);
  CoopContact<S>* cons = reinterpret_cast<CoopContact<S>*>(groups + ngroups);
  CoopRk4<S>* rks = reinterpret_cast<CoopRk4<S>*>(cons + (CON ? ngroups : 0));
  S* op = reinterpret_cast<S*>(rks + (RK4 ? ngroups : 0));   // [2][op_len]
  S* gp = op + 2 * op_len;                           // [glob_dim]
  S* cst = gp + d.glob_dim;                          // [ngroups][T]
  CoopNode<S>& G = groups[g];

  const S alpha = alphas[a];
  const bool kp = real && keep[(size_t)b * A + a] != 0;
  const size_t lane = (size_t)b * A + a;
  for (int i = threadIdx.x; i < d.glob_dim; i += blockDim.x)
    gp[i] = glob_par[(size_t)b * d.glob_dim + i];
  for (int i = l; i < nx; i += RO_G) G.xc[i] = x0[(size_t)b * nx + i];

  ro_load_node<S>(d, b, 0, T, xs, us, kff, Kfb, fs, node_par, op);
  cp_async_commit();
  for (int t = 0; t < T; ++t) {
    if (t + 1 < T)
      ro_load_node<S>(d, b, t + 1, T, xs, us, kff, Kfb, fs, node_par,
                      op + ((t + 1) & 1) * op_len);
    cp_async_commit();
    cp_async_wait_prior1();
    __syncthreads();
    const S* xs_t = op + (t & 1) * op_len;
    const S* us_t = xs_t + nx;
    const S* k_t = us_t + nu;
    const S* K_t = k_t + nu;
    const S* f_t = K_t + nu * ndx;
    const S* np_t = f_t + ndx;

    if (l == 0) ro_gap_and_error<S>(d, G, xs_t, f_t, alpha, kp);
    __syncwarp();
    // feedback law (clipped to the bounds when box; NaN stays NaN, as in
    // the plain version's min/max) and squash, a control row per thread
    for (int i = l; i < nu; i += RO_G) {
      S acc = S(0);
      const S* Krow = K_t + i * ndx;
      for (int j = 0; j < ndx; ++j) acc = acc + Krow[j] * G.dx[j];
      S ui = us_t[i] - alpha * k_t[i] - acc;
      if (box) {
        const S lb = gp[1 + i], ub = gp[1 + nu + i];
        ui = ui < lb ? lb : (ui > ub ? ub : ui);
      }
      G.u[i] = ui;
      G.usq[i] = control_u<S, S>(d, i, ui, gp);
    }
    __syncwarp();
    if (real) {
      const size_t lt = lane * T + t;
      for (int i = l; i < nx; i += RO_G) xs_try[lt * nx + i] = G.xt[i];
      for (int i = l; i < nu; i += RO_G) us_try[lt * nu + i] = G.u[i];
    }
    if constexpr (RK4)
      rk4_dyn_next<S, CON>(d, l, G, cons + g, rks[g], np_t, gp, cst + g * T + t);
    else
      coop_dyn_next<S, RO_G, CON>(d, l, G, cons + g, np_t, gp, cst + g * T + t);
    __syncthreads();
  }
  if (real) {
    for (int t = l; t < T; t += RO_G) cs[lane * T + t] = cst[g * T + t];
    for (int i = l; i < nx; i += RO_G) xn_last[lane * nx + i] = G.xc[i];
  }
}

template <class S>
static int launch_rollout(const void* desc, const ModelDesc* hd, int B, int A, int T, int box,
                          const S* xs,
                          const S* us, const S* k, const S* K, const S* fs,
                          const S* x0, const S* alphas, const unsigned char* keep,
                          const S* node_par, const S* glob_par, S* xs_try,
                          S* us_try, S* cs, S* xn_last, void* stream) {
  const int threads = ((A * RO_G + 31) / 32) * 32;
  if (A < 1 || threads > RO_MAX_THREADS) return (int)cudaErrorInvalidValue;
  const int ngroups = threads / RO_G;
  const bool con = contact_path(*hd), rk4 = hd->integrator == EM_RK4;
  const size_t smem = ngroups * (sizeof(CoopNode<S>) + (con ? sizeof(CoopContact<S>) : 0)
                                 + (rk4 ? sizeof(CoopRk4<S>) : 0))
      + sizeof(S) * ((size_t)2 * ro_op_len(hd->nq + hd->nv, 2 * hd->nv, hd->nu, hd->node_dim)
                     + hd->glob_dim + (size_t)ngroups * T);
  const auto kernel = con ? (rk4 ? &rollout_kernel<S, true, true> : &rollout_kernel<S, true, false>)
                          : (rk4 ? &rollout_kernel<S, false, true> : &rollout_kernel<S, false, false>);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (B > 0 && T > 0)
    kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        (const ModelDesc*)desc, B, A, T, box, xs, us, k, K, fs, x0, alphas, keep,
        node_par, glob_par, xs_try, us_try, cs, xn_last);
  return (int)cudaGetLastError();
}

extern "C" {

int eagle_rollout_f32(const void* desc, const void* host_desc, int B, int A, int T, int box,
                      const float* xs,
                      const float* us, const float* k, const float* K,
                      const float* fs, const float* x0, const float* alphas,
                      const unsigned char* keep, const float* node_par,
                      const float* glob_par, float* xs_try, float* us_try,
                      float* cs, float* xn_last, void* stream) {
  return launch_rollout<float>(desc, (const ModelDesc*)host_desc, B, A, T, box, xs, us, k, K, fs, x0, alphas, keep, node_par,
                               glob_par, xs_try, us_try, cs, xn_last, stream);
}

int eagle_rollout_f64(const void* desc, const void* host_desc, int B, int A, int T, int box,
                      const double* xs,
                      const double* us, const double* k, const double* K,
                      const double* fs, const double* x0, const double* alphas,
                      const unsigned char* keep, const double* node_par,
                      const double* glob_par, double* xs_try, double* us_try,
                      double* cs, double* xn_last, void* stream) {
  return launch_rollout<double>(desc, (const ModelDesc*)host_desc, B, A, T, box, xs, us, k, K, fs, x0, alphas, keep, node_par,
                                glob_par, xs_try, us_try, cs, xn_last, stream);
}

}  // extern "C"
