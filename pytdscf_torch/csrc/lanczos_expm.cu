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
// M = 240, r = 30) one matvec is 7.8 M complex multiply-adds, and a call
// runs a few of them in sequence; everything else is a few passes over
// 7200-entry vectors.  Design of this first version: ONE block of 1024
// threads runs the whole recurrence, so the iterations need no grid-wide
// synchronisation; the matvec's second product is a 32 x 32 shared-memory
// tiled complex matmul in plain fp32 FMA (no TF32), so the kernel is bound
// by one SM's FP32 rate.  The Krylov vectors, the previous iterate and the
// (nc, M, r) intermediate live in device-memory scratch that the wrapper
// allocates (the 1.8 MB of H channels and 0.6 MB of Krylov vectors do not
// fit one SM's shared memory, and sit in the 50 MB L2).  One warp computes
// the tridiagonal exponential, lane j holding coefficient j.  Spreading the
// matvec over a cluster or cooperative grid is later work.
//
// The recurrence, the matvec and the tridiagonal exponential are the
// shared routines of tdvp_device.cuh (site_step.cu runs the same ones).
//
// Layout: complex64 as float2, row-major, contiguous.  status = (k_used,
// bad) as int32.  scratch holds (kmax + 3 + nc) * M * r complex64.

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
