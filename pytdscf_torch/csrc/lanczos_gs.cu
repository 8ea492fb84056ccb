// Improved relaxation's restarted-Lanczos ground state, every pass of one
// site in one launch.
//
// Replaces the JAX package's mps/tdvp.py:_ground_state_multi over
// mps/integrator.py:lanczos_ground_state: XLA's while_loop and eigh, no
// pl.pallas_call.  Launched from the host, the same work as torch
// operations would be ~25 launches a Krylov iteration and a host read a
// pass, up to 100 passes a site.  The effective operator comes as the
// Lanczos exponential's channels (cuda_lanczos.heff_channels):
//
//     H v = sum_c H_c (v Rt_c),   H_c (M, M),  Rt_c (r, r),  v (M, r).
//
// Semantics (the JAX package's, and the plain version's,
// cuda_lanczos.ground_state_plain):
//   * a pass from v: v_0 = v / ||v||; k_max = min(24, M r) iterations of
//     beta_k v_{k+1} = H v_k - alpha_k v_k - beta_{k-1} v_{k-1},
//     alpha_k = Re <v_k|H v_k>, no re-orthogonalisation; a breakdown
//     (beta_k < 1e-14) ends the pass, v_{k+1} = 0;
//   * T's lowest eigenpair in float64 (alpha and beta are the float32
//     sums, widened), over the k iterations that ran (the JAX package
//     solves the k_max-square T with its tail masked at 1e10: the tail is
//     decoupled and far above, so the lowest eigenpair is the same);
//   * the Ritz vector g = sum_j y_j v_j (y rounded to float32), normalised;
//   * the energy e = Re <g|H g> (one more matvec);
//   * passes run while |e - e_prev| > 1e-12 (e_prev = inf before the
//     first) and fewer than 100 ran: at least two run.
// status = (passes, Lanczos iterations, breakdowns), int32.
//
// T's eigenpair, on warp 0 of every CTA (all hold the same alpha and beta
// bits, so all get the same y): the eigenvalue by multisection on the
// Sturm count (each lane counts the eigenvalues below one of 32 points
// that split the Gershgorin interval, one ballot picks the subinterval,
// until it is a few ulps wide), then the eigenvector on lane 0 from the
// twisted factorisation of T - lambda (forward and backward LDL^T pivots,
// the twist where the two meet with the smallest pivot): O(k) with no
// iteration.
//
// Routes (cuda_lanczos.gs_plan): the Lanczos exponential's cluster layer
// (tdvp_device.cuh: ClusterRows, cluster_matvec, rank-ordered
// cluster_sum): one cluster of C CTAs of 1024 threads, rank q owning Mc =
// ceil(M / C) rows of every H_c, Krylov vector and of v; the small edge
// sites run the same kernel on one CTA (a cluster of one).  Three cluster
// barriers a Krylov iteration (the matvec's gather, alpha, beta), two a
// pass besides (the Ritz norm, the energy's matvec and sum).
//
// Bound on the H100: the matvecs, k_max + 1 a pass, in sequence: at the
// butadiene bulk site (nc = 30, M = 72, r = 12) 2.2 M complex
// multiply-adds each (8.7 M fp32 FMA), everything else a few passes over
// 864-entry vectors.  The 1e-12 stop test sits at the rounding of a
// float32 energy, so a pass count up to 100 is expected.
//
// Arithmetic: fp32 FMA (no TF32) outside T's solve; float64 inside it.
//
// Layout: complex64 as float2, row-major, contiguous.  Dynamic shared
// memory per CTA as lanczos_expm_cluster_kernel's (cuda_lanczos.smem_bytes):
// x gathered whole (M r), the matvec's intermediate (nc Mc r), w and the
// Ritz vector g (Mc r each), the CTA's rows of H (nc Mc rows of M + 1
// entries when `resident`, else a slice of kChunk + 1), two inboxes
// (2 C).  scratch holds C (kmax + 1) Mc r complex64: each CTA's rows of
// the Krylov vectors.

#include <cuda_runtime.h>

#include <cmath>

#include "tdvp_device.cuh"

namespace {

constexpr int kThreads = kTileThreads;  // 1024
constexpr int kWarps = kThreads / 32;
constexpr int kGsMaxK = 24;             // integrator.GS_BLOCK_DIM
constexpr int kGsMaxPasses = 100;       // integrator.GS_MAX_RESTARTS
constexpr double kGsTol = 1.0e-12;      // integrator.GS_TOL
constexpr double kPivMin = 1.0e-290;    // smallest pivot of a factorisation
constexpr int kBisectRounds = 40;

__device__ __forceinline__ double warp_min_d(double v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmin(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ double warp_max_d(double v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ double pivot(double q) {
  return fabs(q) < kPivMin ? -kPivMin : q;
}

// Eigenvalues of the k-square symmetric tridiagonal T (diagonal a,
// off-diagonal b) below x.
__device__ int sturm_count(const double* a, const double* b, int k, double x) {
  double q = pivot(a[0] - x);
  int n = q < 0.0;
  for (int i = 1; i < k; ++i) {
    q = pivot((a[i] - x) - b[i - 1] * b[i - 1] / q);
    n += q < 0.0;
  }
  return n;
}

// Warp 0: y[0..k) = the unit eigenvector of T's lowest eigenvalue, T the
// k-square symmetric tridiagonal with diagonal a and off-diagonal b (1 <=
// k <= kGsMaxK), in float64.
__device__ void tridiag_ground(const double* a, const double* b, int k,
                               double* y) {
  const int lane = threadIdx.x & 31;
  double lo = INFINITY, hi = -INFINITY;
  if (lane < k) {
    const double rad = (lane > 0 ? fabs(b[lane - 1]) : 0.0) +
                       (lane + 1 < k ? fabs(b[lane]) : 0.0);
    lo = a[lane] - rad;
    hi = a[lane] + rad;
  }
  lo = warp_min_d(lo);
  hi = warp_max_d(hi);
  // multisection: every lane computes the same lo and hi, so the loop is
  // uniform over the warp
  for (int round = 0; round < kBisectRounds; ++round) {
    const double w = hi - lo;
    if (!(w > 4.0 * 2.220446049250313e-16 * fmax(fabs(lo), fabs(hi)) +
                  kPivMin))
      break;
    const double x = lo + (double)(lane + 1) * (w / 33.0);
    const unsigned below = __ballot_sync(0xffffffffu, sturm_count(a, b, k, x) >= 1);
    if (below == 0u) {
      lo = lo + 32.0 * (w / 33.0);
    } else {
      const int j0 = __ffs(below) - 1;
      const double xj = lo + (double)(j0 + 1) * (w / 33.0);
      if (j0 > 0) lo = lo + (double)j0 * (w / 33.0);
      hi = xj;
    }
  }
  if (lane == 0) {
    const double lam = 0.5 * (lo + hi);
    double dp[kGsMaxK], dm[kGsMaxK];
    dp[0] = a[0] - lam;
    for (int i = 0; i + 1 < k; ++i)
      dp[i + 1] = (a[i + 1] - lam) - b[i] * b[i] / pivot(dp[i]);
    dm[k - 1] = a[k - 1] - lam;
    for (int i = k - 2; i >= 0; --i)
      dm[i] = (a[i] - lam) - b[i] * b[i] / pivot(dm[i + 1]);
    int tw = 0;
    double best = INFINITY;
    for (int i = 0; i < k; ++i) {
      const double g = fabs(dp[i] + dm[i] - (a[i] - lam));
      if (g < best) {
        best = g;
        tw = i;
      }
    }
    y[tw] = 1.0;
    for (int i = tw - 1; i >= 0; --i) y[i] = -b[i] * y[i + 1] / pivot(dp[i]);
    for (int i = tw + 1; i < k; ++i) y[i] = -b[i - 1] * y[i - 1] / pivot(dm[i]);
    double s = 0.0;
    for (int i = 0; i < k; ++i) s += y[i] * y[i];
    const double inv = 1.0 / sqrt(s);
    for (int i = 0; i < k; ++i) y[i] *= inv;
  }
}

__global__ void __launch_bounds__(kThreads)
lanczos_gs_kernel(const float2* __restrict__ H, const float2* __restrict__ Rt,
                  const float2* __restrict__ v_in, float2* __restrict__ out,
                  int* __restrict__ status, float2* scratch, int nc, int M,
                  int r, int kmax, int Mc, int resident) {
  extern __shared__ float2 smem[];
  __shared__ float2 red[kWarps];
  __shared__ double alpha[kGsMaxK];
  __shared__ double beta[kGsMaxK];
  __shared__ double y[kGsMaxK];
  float2* xs = smem;                          // (M, r)
  float2* T = xs + (size_t)M * r;             // (nc, Mc, r)
  float2* w = T + (size_t)nc * Mc * r;        // (Mc, r)
  float2* g = w + (size_t)Mc * r;             // (Mc, r) the pass's vector
  float2* stage = g + (size_t)Mc * r;         // (nc Mc, ks) H's rows
  ClusterRows c = cluster_rows(
      M, Mc, 1, nullptr,
      stage + (size_t)nc * Mc * ((resident ? M : kChunk) + 1));
  // this CTA's rows of the Krylov vectors: written and read back inside
  // the launch, so no __restrict__ const view of them may exist
  const size_t slot = (size_t)Mc * r;
  float2* V = scratch + (size_t)c.rank * (kmax + 1) * slot;
  const ClusterOp op{H, Rt, stage, nc, M, r, Mc, 1.f, resident != 0};
  const int tid = threadIdx.x, n = c.nh * r;
  const size_t row0 = (size_t)c.row0 * r;
  float2* xo = xs + row0;  // this CTA's rows of the matvec input
  // every CTA of the cluster runs before any addresses another's memory
  cg::this_cluster().sync();
  if (op.resident)  // (read first after the first matvec's barriers)
    stage_rows<kThreads>(H, stage, nc, M, c.row0, c.nh, 0, M, M, M + 1);

  // g = the start vector, normalised; each pass normalises its start again
  float s = 0.f;
  for (int i = tid; i < n; i += kThreads) {
    const float2 a = v_in[row0 + i];
    s += a.x * a.x + a.y * a.y;
  }
  float nrm = sqrtf(cluster_sum(c, block_sum2<kThreads>(s, 0.f, red).x));
  for (int i = tid; i < n; i += kThreads) {
    const float2 a = v_in[row0 + i];
    g[i] = make_float2(a.x / nrm, a.y / nrm);
  }

  int passes = 0, iters = 0, breaks = 0;
  double e_prev = INFINITY;
  for (;;) {
    // ---- one pass (lanczos_ground_state) from g
    s = 0.f;
    for (int i = tid; i < n; i += kThreads) {
      const float2 a = g[i];
      s += a.x * a.x + a.y * a.y;
    }
    nrm = sqrtf(cluster_sum(c, block_sum2<kThreads>(s, 0.f, red).x));
    for (int i = tid; i < n; i += kThreads) {
      const float2 a = g[i];
      const float2 v0 = make_float2(a.x / nrm, a.y / nrm);
      V[i] = v0;
      xo[i] = v0;
    }
    int k_fin = 0;
    bool broke = false;
    for (int k = 0; k < kmax; ++k) {
      const float2* vk = V + k * slot;
      cluster_matvec<kThreads>(c, op, xs, T, w);
      float ar = 0.f;
      for (int i = tid; i < n; i += kThreads) {
        const float2 a = vk[i], b = w[i];
        ar += a.x * b.x + a.y * b.y;  // Re conj(a) * b
      }
      const float al = cluster_sum(c, block_sum2<kThreads>(ar, 0.f, red).x);
      const float bprev = k > 0 ? (float)beta[k - 1] : 0.f;
      float s2 = 0.f;
      for (int i = tid; i < n; i += kThreads) {
        const float2 a = vk[i];
        float2 x = w[i];
        x.x -= al * a.x;
        x.y -= al * a.y;
        if (k > 0) {
          const float2 b = V[(k - 1) * slot + i];
          x.x -= bprev * b.x;
          x.y -= bprev * b.y;
        }
        w[i] = x;
        s2 += x.x * x.x + x.y * x.y;
      }
      const float bk =
          sqrtf(cluster_sum(c, block_sum2<kThreads>(s2, 0.f, red).x));
      const bool live = bk > kEpsBreakdown;
      // every peer finished gathering x before the alpha barrier, so this
      // CTA's rows of xs may now take the next input
      float2* vn = V + (k + 1) * slot;
      for (int i = tid; i < n; i += kThreads) {
        const float2 x = w[i];
        const float2 v =
            live ? make_float2(x.x / bk, x.y / bk) : make_float2(0.f, 0.f);
        vn[i] = v;
        xo[i] = v;
      }
      if (tid == 0) {
        alpha[k] = (double)al;
        beta[k] = (double)bk;
      }
      k_fin = k + 1;
      broke = bk < kEpsBreakdown;
      if (broke) break;
    }
    __syncthreads();
    if (tid < 32) tridiag_ground(alpha, beta, k_fin, y);
    __syncthreads();
    // the Ritz vector g = sum_j y_j v_j, normalised
    s = 0.f;
    for (int i = tid; i < n; i += kThreads) {
      float pr = 0.f, pi = 0.f;
      for (int j = 0; j < k_fin; ++j) {
        const float yj = (float)y[j];
        const float2 a = V[j * slot + i];
        pr += yj * a.x;
        pi += yj * a.y;
      }
      g[i] = make_float2(pr, pi);
      s += pr * pr + pi * pi;
    }
    nrm = sqrtf(cluster_sum(c, block_sum2<kThreads>(s, 0.f, red).x));
    for (int i = tid; i < n; i += kThreads) {
      const float2 a = g[i];
      const float2 v = make_float2(a.x / nrm, a.y / nrm);
      g[i] = v;
      xo[i] = v;
    }
    // ---- the energy Re <g|H g>
    cluster_matvec<kThreads>(c, op, xs, T, w);
    float er = 0.f;
    for (int i = tid; i < n; i += kThreads) {
      const float2 a = g[i], b = w[i];
      er += a.x * b.x + a.y * b.y;
    }
    const double e =
        (double)cluster_sum(c, block_sum2<kThreads>(er, 0.f, red).x);
    ++passes;
    iters += k_fin;
    breaks += broke ? 1 : 0;
    // the same bits in every CTA: all leave together
    if (!(fabs(e - e_prev) > kGsTol) || passes >= kGsMaxPasses) break;
    e_prev = e;
  }
  for (int i = tid; i < n; i += kThreads) out[row0 + i] = g[i];
  if (c.rank == 0 && tid == 0) {
    status[0] = passes;
    status[1] = iters;
    status[2] = breaks;
  }
  // no CTA leaves while another may still address its shared memory
  cg::this_cluster().sync();
}

}  // namespace

// One cluster of C CTAs (C = 1: the one-block route), ceil(M / C) rows
// each (cuda_lanczos.smem_bytes(nc, M, r, C, resident) bytes of shared
// memory per CTA); cudaErrorInvalidClusterSize if the card cannot
// schedule such a cluster.
extern "C" int pytdscf_lanczos_gs_c64(int device, const void* H,
                                      const void* Rt, const void* v,
                                      void* out, void* status, void* scratch,
                                      int nc, int M, int r, int kmax, int C,
                                      int resident, void* stream) {
  if (kmax < 1 || kmax > kGsMaxK) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int Mc = (M + C - 1) / C;
  const size_t smem =
      sizeof(float2) * ((size_t)M * r + (size_t)(nc + 2) * Mc * r +
                        (size_t)nc * Mc * ((resident ? M : kChunk) + 1) +
                        2 * C);
  return (int)launch_cluster(
      device, lanczos_gs_kernel, C, kThreads, smem,
      static_cast<cudaStream_t>(stream), static_cast<const float2*>(H),
      static_cast<const float2*>(Rt), static_cast<const float2*>(v),
      static_cast<float2*>(out), static_cast<int*>(status),
      static_cast<float2*>(scratch), nc, M, r, kmax, Mc, resident);
}
