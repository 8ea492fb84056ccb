// One whole non-last TDVP site update (Lanczos, one state) in one launch.
//
// Replaces the JAX package's mps/pallas_site.py:site_step_fused (Pallas body
// _site_kernel).  The kernel runs the forward update of a site psi (M, r),
// M = l d:
//
//   1. H-Krylov: psi1 = exp(scale H_eff) psi, the matvec
//      hfac · sum_c H_c (x Rt_c) with the channels H_c (nc, M, M) built
//      WITHOUT the env factor hfac = exp(lL + lR);
//   2. gauge: psi1 = Q sigma by MGS(×2) on the columns of psi1;
//   3. renormalisation: B_c = Q^H H_c Q (the same unscaled channels),
//      normalised by the Frobenius norm over all channels (floored at
//      1e-30), dl = log of that norm, log_new = l_sys + dl;
//   4. K-Krylov: sigma1 = exp(-scale K_eff) sigma with the matvec
//      kfac · sum_c B_c (x Rt_c), kfac = exp(log_new + l_env);
//   5. absorb: psi_next = sigma1 · next (r, P2).
//
// A backward update is the forward update of the mirrored site (psi
// permuted to (r, d, l), L and R swapped, W to (c, i, j, a)): the wrapper
// (mps/cuda_site.py) permutes the operands, so this kernel has one
// direction only, and the backward gauge factors psi as the unfused route's
// LQ does (its dead-column completions included).  The TPU kernel's
// workarounds are gone: no selection-matrix matmuls for the backward
// matricisation, no planar re/im split, no scalar vector in SMEM, no
// full-array store of dl, no dummy operands.
//
// Bound on the H100: the matvecs, as in lanczos_expm.cu.  At the chain's
// bulk site (nc = 4, M = 240, r = 30) one H matvec and the renormalisation
// are 6.9 M complex multiply-adds each; the K side works on (30, 30)
// matrices.  Design of this first version: ONE block of 1024 threads runs
// all five phases, so they need no grid-wide synchronisation; the Lanczos
// recurrence, the matvec, the tridiagonal exponential and the MGS passes are
// the shared routines of tdvp_device.cuh.  The H-side Krylov vectors, the
// (nc, M, M) channels, Q and the K-side Krylov vectors sit in device memory
// (the wrapper's scratch; 1.84 MB of channels at the bulk, in L2); the
// renormalised blocks, sigma and the MGS work vectors in shared memory.
//
// Layout: complex64 as float2, row-major, contiguous.  Inputs H (nc, M, M),
// Rt (nc, r, r), psi (M, r), next (r, P2), logs = (hfac, l_sys, l_env)
// float32 on the device.  Outputs site_out (M, r) = Q, psi_next (r, P2),
// blocks (r, nc, r), log_new (1) float32, status = (kH, badH, kK, badK)
// int32.  scratch holds (kmaxH + 5 + nc) M r + (kmaxK + 3 + nc) r r
// complex64.

#include <cuda_runtime.h>

#include "tdvp_device.cuh"

namespace {

constexpr int kThreads = kTileThreads;  // 1024
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
site_step_kernel(const float2* __restrict__ H, const float2* __restrict__ Rt,
                 const float2* __restrict__ psi, const float2* __restrict__ nxt,
                 const float* __restrict__ logs, float2* __restrict__ site_out,
                 float2* __restrict__ psi_next, float2* __restrict__ blocks_out,
                 float* __restrict__ log_new, int* __restrict__ status,
                 float2* scratch, int nc, int M, int r, int P2, int kmaxH,
                 int kmaxK, float sre, float sim, float thresh, int conserve) {
  __shared__ float2 As[kTile][kTile + 1];
  __shared__ float2 Bs[kTile][kTile + 1];
  __shared__ float2 red2[kWarps];
  __shared__ float red[kWarps];
  __shared__ float alpha[kMaxK];
  __shared__ float beta[kMaxK];
  __shared__ float2 coef[kMaxK];
  extern __shared__ float2 smem[];
  const int tid = threadIdx.x;
  const int n = M * r, r2 = r * r;
  float2* blk = smem;               // (nc, r, r) renormalised blocks
  float2* sig = blk + nc * r2;      // (r, r) sigma, then sigma1
  float2* v = sig + r2;             // (M) MGS column
  float2* e = v + M;                // (M) MGS completion
  float2* c1 = e + M;               // (r) MGS coefficients, three sets
  float2* c2 = c1 + r;
  float2* c3 = c2 + r;
  // scratch is written and read back inside the launch: no __restrict__
  // const view of it may exist (the read-only cache is not coherent)
  float2* VH = scratch;                           // (kmaxH + 1, n)
  float2* prevH = VH + (size_t)(kmaxH + 1) * n;   // (n)
  float2* wH = prevH + n;                         // (n)
  float2* tmpH = wH + n;                          // (nc, n); then H_c Q
  float2* psi1 = tmpH + (size_t)nc * n;           // (n)
  float2* Q = psi1 + n;                           // (r, M) column-major
  float2* VK = Q + n;                             // (kmaxK + 1, r2)
  float2* prevK = VK + (size_t)(kmaxK + 1) * r2;  // (r2)
  float2* wK = prevK + r2;                        // (r2)
  float2* tmpK = wK + r2;                         // (nc, r2)
  const float hfac = logs[0], l_sys = logs[1], l_env = logs[2];

  // 1. H-Krylov, the env factor on the matvec output
  auto mv_h = [&](const float2* x, float2* y) {
    matvec(H, Rt, x, tmpH, y, nc, M, r, hfac, As, Bs);
  };
  const KrylovRun kh = lanczos_run(mv_h, psi, VH, prevH, wH, n, kmaxH, sre,
                                   sim, thresh, alpha, beta, coef, red2);
  lanczos_result(prevH, psi1, n, conserve, kh.beta0, red2);
  __syncthreads();

  // 2. gauge psi1 = Q sigma
  mgs_factor<kThreads>(psi1, Q, sig, M, r, v, e, c1, c2, c3, red);

  // 3. renormalisation B_c = Q^H (H_c Q), then its norm and log-scale
  for (int c = 0; c < nc; ++c)
    cgemm<false>(H + (size_t)c * M * M, M, 1, Q, 1, M, tmpH + (size_t)c * n,
                 r, 1, M, r, M, As, Bs);
  for (int c = 0; c < nc; ++c)
    cgemm<true>(Q, M, 1, tmpH + (size_t)c * n, r, 1, blk + (size_t)c * r2, r,
                1, r, r, M, As, Bs);
  float s = 0.f;
  for (int i = tid; i < nc * r2; i += kThreads) {
    const float2 a = blk[i];
    s += a.x * a.x + a.y * a.y;
  }
  const float nrm = fmaxf(sqrtf(block_sum2<kThreads>(s, 0.f, red2).x), 1e-30f);
  for (int i = tid; i < nc * r2; i += kThreads) {
    const float2 a = blk[i];
    blk[i] = make_float2(a.x / nrm, a.y / nrm);
  }
  const float lnew = l_sys + logf(nrm);
  const float kfac = expf(lnew + l_env);
  __syncthreads();

  // 4. K-Krylov on sigma with -scale: kL = the new blocks, kR = Rt
  auto mv_k = [&](const float2* x, float2* y) {
    matvec(blk, Rt, x, tmpK, y, nc, r, r, kfac, As, Bs);
  };
  const KrylovRun kk = lanczos_run(mv_k, sig, VK, prevK, wK, r2, kmaxK, -sre,
                                   -sim, thresh, alpha, beta, coef, red2);
  lanczos_result(prevK, sig, r2, conserve, kk.beta0, red2);
  __syncthreads();

  // 5. absorb psi_next = sigma1 next; write Q row-major and the blocks as
  // (r, nc, r)
  cgemm<false>(sig, r, 1, nxt, P2, 1, psi_next, P2, 1, r, P2, r, As, Bs);
  for (int i = tid; i < n; i += kThreads) {
    const int row = i / r, col = i - row * r;
    site_out[i] = Q[(size_t)col * M + row];
  }
  for (int i = tid; i < nc * r2; i += kThreads) {
    const int c = i / r2, rem = i - c * r2;
    const int x = rem / r, y = rem - x * r;
    blocks_out[((size_t)x * nc + c) * r + y] = blk[i];
  }
  if (tid == 0) {
    log_new[0] = lnew;
    status[0] = kh.k;
    status[1] = (kh.bad && kmaxH < n) ? 1 : 0;
    status[2] = kk.k;
    status[3] = (kk.bad && kmaxK < r2) ? 1 : 0;
  }
}

// Dynamic shared memory of one launch (bytes): the blocks, sigma, the two
// MGS work vectors and three coefficient columns (cuda_site.smem_bytes).
int site_step_smem(int nc, int M, int r) {
  return (int)(sizeof(float2) * ((size_t)(nc + 1) * r * r + 2 * (size_t)M +
                                 3 * (size_t)r));
}

}  // namespace

extern "C" int pytdscf_site_step_c64(int device, const void* H, const void* Rt,
                                     const void* psi, const void* nxt,
                                     const void* logs, void* site_out,
                                     void* psi_next, void* blocks,
                                     void* log_new, void* status,
                                     void* scratch, int nc, int M, int r,
                                     int P2, int kmaxH, int kmaxK,
                                     float scale_re, float scale_im,
                                     float thresh, int conserve,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int smem = site_step_smem(nc, M, r);
  err = cudaFuncSetAttribute(site_step_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  site_step_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(H), static_cast<const float2*>(Rt),
      static_cast<const float2*>(psi), static_cast<const float2*>(nxt),
      static_cast<const float*>(logs), static_cast<float2*>(site_out),
      static_cast<float2*>(psi_next), static_cast<float2*>(blocks),
      static_cast<float*>(log_new), static_cast<int*>(status),
      static_cast<float2*>(scratch), nc, M, r, P2, kmaxH, kmaxK, scale_re,
      scale_im, thresh, conserve);
  return (int)cudaGetLastError();
}
