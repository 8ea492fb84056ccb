// exp(scale·H) v by short-iterative Lanczos, the whole call in one launch.
//
// Replaces the JAX package's mps/pallas_lanczos.py:lanczos_expm_fused (Pallas
// body _lanczos_kernel / _lanczos_phase).  The effective operator comes as
// channels (built by cuda_lanczos.heff_channels / keff_channels):
//
//     H v = sum_c H_c (v Rt_c),   H_c (M, M),  Rt_c (r, r),  v (M, r).
//
// Lanczos semantics are those of the JAX package's mps/integrator.py:_lanczos_loop:
//   * oblique alpha_k = <v_0|H v_k>; Re(alpha_k) on the diagonal of T;
//   * beta_k v_{k+1} = H v_k - alpha_k v_k - beta_{k-1} v_{k-1};
//     breakdown when beta_k < 1e-14 (v_{k+1} = 0, the loop stops);
//   * psi(k) = V c(k), c(k) = exp(scale T_k) e_0; converged when k > 0 and
//     ||psi(k) - psi(k-1)|| < thresh; capped at k + 1 = kmax;
//   * bad = capped and neither converged nor broken down, and never when
//     kmax >= M r (the space was spanned);
//   * conserve != 0 renormalises psi, otherwise it is scaled by ||v||.
// c(k) is computed as the Pallas kernel does: order-10 Taylor in m
// substeps, m = ceil(|scale| (max|alpha| + 2 max beta) / 0.5) from the
// Gershgorin bound, so each substep has norm <= 0.5.
//
// Bound on the H100: the matvec.  At the chain's bulk site (nc = 4,
// M = 240, r = 30) one matvec is 7.8 M complex multiply-adds (31 M fp32
// FMA), and a call runs a few of them in sequence; everything else is a
// few passes over 7200-entry vectors.  On one SM that is ~120 µs a matvec
// at the SM's peak, so the kernel has two routes (cuda_lanczos.route):
//
//  * the cluster route (lanczos_expm_cluster_kernel): ONE thread-block
//    cluster of C CTAs (16, a non-portable size, or 8: the largest that
//    leaves each CTA 4 rows, cuda_lanczos.cluster_size) of 1024 threads
//    runs the whole recurrence (tdvp_device.cuh's cluster layer).
//    Rank q owns Mc = ceil(M / C) rows of every H_c, of every Krylov vector
//    and of ψ, and computes its rows of y = Σ_c (H_c x) Rt_c, the H_c x
//    product first so that the second one stays row-local.  The only
//    exchange per matvec is the gather of the whole x (57.6 KB at the
//    bulk) from the peers' shared memory; α, β, the error and the norm are
//    per-CTA partials summed over the cluster in rank order, so every CTA
//    sees the same bits and takes the same convergence and breakdown
//    branch.  The CTA's rows of H_c are loaded into its shared memory once
//    (115 KB at the bulk on 16 CTAs) where they fit, else streamed through
//    a shared-memory slice every matvec; the CTA's rows of the Krylov
//    vectors sit in a device-memory slice of its own.
//  * the one-block route (lanczos_expm_kernel): one block of 1024 threads,
//    the whole M on one SM (32 x 32 shared-memory tiles, plain fp32 FMA),
//    for shapes that leave fewer than 4 rows to a CTA of any cluster (the
//    chain's edge sites, M = 8).
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py's route sweep over
// every shape of a chain step; PERF.md §6): the bulk H step (k 5) takes
// 0.23 ms on 16 CTAs, 0.44 ms on 8 and 3.17 ms on one block; one
// iteration costs 0.043 ms on the cluster, about 5 µs of it per channel's
// matvec, the rest barriers, the gather and the reductions.  The (30, 30)
// K steps take 0.100 ms on 8 CTAs, 0.112 on 16 and 0.134 on one block; the
// edge steps (M = 8) 0.05-0.07 ms on one block, 0.05-0.10 on a cluster.
//
// Arithmetic: plain fp32 FMA on both routes (no TF32: the chain holds ⟨H⟩
// to 5e-6 in complex64).  One warp computes the tridiagonal exponential,
// lane j holding coefficient j (on the cluster route warp 0 of every CTA).
//
// Layout: complex64 as float2, row-major, contiguous.  status = (k_used,
// bad) as int32.  scratch holds (kmax + 3 + nc) * M * r complex64 on the
// one-block route, and C (kmax + 1) Mc r on the cluster route (each CTA's
// rows of the Krylov vectors).

#include <cuda_runtime.h>

#include "tdvp_device.cuh"

namespace {

constexpr int kThreads = kTileThreads;  // 1024: the tiled matvec's block
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
lanczos_expm_kernel(const float2* __restrict__ H, const float2* __restrict__ Rt,
                    const float2* __restrict__ v_in, float2* __restrict__ out,
                    int* __restrict__ status, float2* scratch, int nc, int M,
                    int r, int kmax, float sre, float sim, float thresh,
                    int conserve) {
  __shared__ float2 As[kTile][kTile + 1];
  __shared__ float2 Bs[kTile][kTile + 1];
  __shared__ float2 red[kWarps];
  __shared__ float alpha[kMaxK];
  __shared__ float beta[kMaxK];
  __shared__ float2 coef[kMaxK];
  const int n = M * r;
  // scratch is written and read back inside the launch: no __restrict__
  // const view of it may exist (the read-only cache is not coherent)
  float2* V = scratch;                          // (kmax + 1, n)
  float2* prev = V + (size_t)(kmax + 1) * n;    // (n) previous iterate
  float2* w = prev + n;                         // (n)
  float2* tmp = w + n;                          // (nc, n)

  // the env factor is folded into H: the matvec's own factor is 1
  auto mv = [&](const float2* x, float2* y) {
    matvec(H, Rt, x, tmp, y, nc, M, r, 1.f, As, Bs);
  };
  const KrylovRun run = lanczos_run(mv, v_in, V, prev, w, n, kmax, sre, sim,
                                    thresh, alpha, beta, coef, red);
  lanczos_result(prev, out, n, conserve, run.beta0, red);
  if (threadIdx.x == 0) {
    status[0] = run.k;
    status[1] = (run.bad && kmax < n) ? 1 : 0;
  }
}

// One cluster of C CTAs, Mc = ceil(M / C) rows each.  Dynamic shared
// memory per CTA (cuda_lanczos.smem_bytes): x gathered whole (M r), the
// matvec's intermediate (nc Mc r), w and prev (Mc r each), the CTA's rows
// of H (nc Mc rows of M + 1 entries, loaded once, when `resident`; else
// a slice of kChunk + 1), the two inboxes (2 C).
__global__ void __launch_bounds__(kThreads)
lanczos_expm_cluster_kernel(const float2* __restrict__ H,
                            const float2* __restrict__ Rt,
                            const float2* __restrict__ v_in,
                            float2* __restrict__ out, int* __restrict__ status,
                            float2* scratch, int nc, int M, int r, int kmax,
                            float sre, float sim, float thresh, int conserve,
                            int Mc, int resident) {
  extern __shared__ float2 smem[];
  __shared__ float2 red[kWarps];
  __shared__ float alpha[kMaxK];
  __shared__ float beta[kMaxK];
  __shared__ float2 coef[kMaxK];
  float2* xs = smem;                          // (M, r)
  float2* T = xs + (size_t)M * r;             // (nc, Mc, r)
  float2* w = T + (size_t)nc * Mc * r;        // (Mc, r)
  float2* prev = w + (size_t)Mc * r;          // (Mc, r)
  float2* stage = prev + (size_t)Mc * r;      // (nc Mc, ks) H's rows
  ClusterRows c = cluster_rows(
      M, Mc, 1, nullptr,
      stage + (size_t)nc * Mc * ((resident ? M : kChunk) + 1));
  // this CTA's rows of the Krylov vectors: written and read back inside
  // the launch, so no __restrict__ const view of them may exist
  float2* V = scratch + (size_t)c.rank * (kmax + 1) * Mc * r;
  const ClusterOp op{H, Rt, stage, nc, M, r, Mc, 1.f, resident != 0};
  // every CTA of the cluster runs before any addresses another's memory
  cg::this_cluster().sync();
  const size_t row0 = (size_t)c.row0 * r;
  const KrylovRun run = cluster_lanczos_run<kThreads>(
      c, op, v_in + row0, V, prev, w, xs, T, kmax, sre, sim, thresh, alpha,
      beta, coef, red);
  cluster_lanczos_result<kThreads>(c, prev, out + row0, c.nh * r, conserve,
                                   run.beta0, red);
  if (c.rank == 0 && threadIdx.x == 0) {
    status[0] = run.k;
    status[1] = (run.bad && kmax < M * r) ? 1 : 0;
  }
  // no CTA leaves while another may still address its shared memory
  cg::this_cluster().sync();
}

}  // namespace

extern "C" int pytdscf_lanczos_expm_c64(int device, const void* H,
                                        const void* Rt, const void* v,
                                        void* out, void* status, void* scratch,
                                        int nc, int M, int r, int kmax,
                                        float scale_re, float scale_im,
                                        float thresh, int conserve,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  lanczos_expm_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(H), static_cast<const float2*>(Rt),
      static_cast<const float2*>(v), static_cast<float2*>(out),
      static_cast<int*>(status), static_cast<float2*>(scratch), nc, M, r, kmax,
      scale_re, scale_im, thresh, conserve);
  return (int)cudaGetLastError();
}

// The cluster route: one cluster of C CTAs, ceil(M / C) rows each
// (cuda_lanczos.smem_bytes(nc, M, r, C, resident) bytes of shared memory
// per CTA);
// cudaErrorInvalidClusterSize if the card cannot schedule such a cluster.
extern "C" int pytdscf_lanczos_expm_cluster_c64(
    int device, const void* H, const void* Rt, const void* v, void* out,
    void* status, void* scratch, int nc, int M, int r, int kmax,
    float scale_re, float scale_im, float thresh, int conserve, int C,
    int resident, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int Mc = (M + C - 1) / C;
  const size_t smem =
      sizeof(float2) * ((size_t)M * r + (size_t)(nc + 2) * Mc * r +
                        (size_t)nc * Mc * ((resident ? M : kChunk) + 1) +
                        2 * C);
  return (int)launch_cluster(
      device, lanczos_expm_cluster_kernel, C, kThreads, smem,
      static_cast<cudaStream_t>(stream), static_cast<const float2*>(H),
      static_cast<const float2*>(Rt), static_cast<const float2*>(v),
      static_cast<float2*>(out), static_cast<int*>(status),
      static_cast<float2*>(scratch), nc, M, r, kmax, scale_re, scale_im,
      thresh, conserve, Mc, resident);
}
