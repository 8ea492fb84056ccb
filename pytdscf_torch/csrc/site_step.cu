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
// matrices, ~100 times less.  Two routes (cuda_site.route):
//
//  * the cluster route (site_step_cluster_kernel): ONE thread-block
//    cluster of C CTAs of 1024 threads runs all five phases on the row
//    ownership of tdvp_device.cuh's cluster layer: rank q owns the same
//    Mc = ceil(M / C) rows of ψ, of ψ1 and of Q in every phase.
//      1. H-Krylov: cluster_lanczos_run with fac = hfac.
//      2. Gauge: ψ1 gathered whole and factored by the one-block
//         mgs_factor in every CTA alike, so each CTA holds the same Q and
//         σ = R.  (The cluster MGS on ψ1's rows where they sit pays three
//         cluster barriers a column, six for a dead one, 20 of 30 at the
//         chain's bulk: the bulk site took 1.05 ms with it against 0.89
//         ms with the whole-ψ1 gauge, PERF.md §6.)
//      3. Renormalisation: Q gathered whole from the peers' shared memory;
//         each rank forms (H_c Q)[rows] and its partial Q[rows]^H (H_c
//         Q)[rows] (nc r^2); the partials are summed in rank order by a
//         reduce-scatter over distributed shared memory (rank q sums slice
//         q of the nc r^2 entries over ranks 0..C-1) and gathered back, so
//         every CTA holds the same blocks, norm and log_new.
//      4. K-Krylov on the (r, r) σ: the one-block routines on rank 0
//         (the other ranks wait at the final barrier; running it on every
//         rank alike measured no faster, PERF.md §6).
//      5. Rank 0 writes ψ_next, the blocks, log_new and the status; each
//         rank writes its own rows of site_out.
//  * the one-block route (site_step_kernel): one block of 1024 threads runs
//    all five phases on the one-block layer, for shapes too small to gain
//    from a cluster or too large for its shared memory.
//
// Arithmetic: plain fp32 FMA throughout (no TF32).  The H channels stay in
// device memory (1.84 MB at the bulk, in L2; read with __ldg on the
// cluster route); the Krylov vectors in the wrapper's scratch.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py; PERF.md §6):
// the bulk forward site takes 0.89 ms on 16 CTAs and 4.22 ms on one block
// (on 8 CTAs the whole-ψ1 gauge does not fit beside the rest).  Its rows
// of H do not fit shared memory beside the gauge's buffers, so they
// stream through a slice every matvec.

// Layout: complex64 as float2, row-major, contiguous.  Inputs H (nc, M, M),
// Rt (nc, r, r), psi (M, r), next (r, P2), logs = (hfac, l_sys, l_env)
// float32 on the device.  Outputs site_out (M, r) = Q, psi_next (r, P2),
// blocks (r, nc, r), log_new (1) float32, status = (kH, badH, kK, badK)
// int32.  scratch holds (kmaxH + 5 + nc) M r + (kmaxK + 3 + nc) r r
// complex64 on the one-block route, C (kmaxH + 1) Mc r + (kmaxK + 3 + nc)
// r r on the cluster route.

#include <cuda_runtime.h>

#include <algorithm>

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
  __shared__ float red[2 * kWarps];
  __shared__ float alpha[kMaxK];
  __shared__ float beta[kMaxK];
  __shared__ float2 coef[kMaxK];
  extern __shared__ float2 smem[];
  const int tid = threadIdx.x;
  const int n = M * r, r2 = r * r;
  float2* blk = smem;               // (nc, r, r) renormalised blocks
  float2* sig = blk + nc * r2;      // (r, r) sigma, then sigma1
  float2* c1 = sig + r2;            // (r) MGS coefficients, three sets
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

  // 2. gauge psi1 = Q sigma, Q (column stride M) staged from psi1
  mgs_stage(psi1, Q, M, M, r);
  __syncthreads();
  mgs_factor<kThreads>(Q, M, sig, M, r, c1, c2, c3, red);

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

// One cluster of C CTAs, Mc = ceil(M / C) rows each.  Dynamic shared
// memory per CTA (site_step_cluster_smem, cuda_site.smem_bytes): a work
// area of max(M r, 2 nc r^2) (x gathered whole for the H matvecs; ψ1,
// then Q, gathered whole; then the partial blocks, the reduce-scatter's
// slice sums and the blocks), the matvec's intermediate (nc Mc r), w and
// prev (Mc r each), Q's rows (Mc rp), c1, c2, c3 (r each), two inboxes
// (2 C r), sigma (r^2), a slice of H's rows (nc Mc, kChunk + 1) and Q whole
// column-major (M r).
__global__ void __launch_bounds__(kThreads)
site_step_cluster_kernel(
    const float2* __restrict__ H, const float2* __restrict__ Rt,
    const float2* __restrict__ psi, const float2* __restrict__ nxt,
    const float* __restrict__ logs, float2* __restrict__ site_out,
    float2* __restrict__ psi_next, float2* __restrict__ blocks_out,
    float* __restrict__ log_new, int* __restrict__ status, float2* scratch,
    int nc, int M, int r, int P2, int kmaxH, int kmaxK, float sre, float sim,
    float thresh, int conserve, int Mc) {
  __shared__ float2 As[kTile][kTile + 1];
  __shared__ float2 Bs[kTile][kTile + 1];
  __shared__ float2 red2[kWarps];
  __shared__ float red[2 * kWarps];
  __shared__ float alpha[kMaxK];
  __shared__ float beta[kMaxK];
  __shared__ float2 coef[kMaxK];
  extern __shared__ float2 smem[];
  const int tid = threadIdx.x;
  const int r2 = r * r, nb = nc * r2;
  const int work_n = max(M * r, 2 * nb);
  const int rp = r | 1;
  float2* work = smem;                     // see above
  float2* T = work + work_n;               // (nc, Mc, r)
  float2* w = T + (size_t)nc * Mc * r;     // (Mc, r)
  float2* prev = w + (size_t)Mc * r;       // (Mc, r)
  float2* Q = prev + (size_t)Mc * r;       // (Mc, rp) this CTA's rows
  float2* c1 = Q + (size_t)Mc * rp;        // (r) MGS coefficients, three sets
  float2* c2 = c1 + r;
  float2* c3 = c2 + r;
  float2* inbox = c3 + r;                  // (2, C, r)
  ClusterRows c = cluster_rows(M, Mc, r, nullptr, inbox);
  float2* sig = inbox + 2 * c.size * r;    // (r, r) sigma, then sigma1
  float2* stage = sig + r2;                // (nc Mc, kChunk + 1) H's rows
  float2* Qc = stage + (size_t)nc * Mc * (kChunk + 1);  // (r, M) Q whole
  // scratch is written and read back inside the launch: no __restrict__
  // const view of it may exist (the read-only cache is not coherent)
  float2* VH = scratch + (size_t)c.rank * (kmaxH + 1) * Mc * r;
  // the K side's scratch, rank 0's alone
  float2* VK = scratch + (size_t)c.size * (kmaxH + 1) * Mc * r;
  float2* prevK = VK + (size_t)(kmaxK + 1) * r2;  // (r2)
  float2* wK = prevK + r2;                         // (r2)
  float2* tmpK = wK + r2;                          // (nc, r2)
  const float hfac = logs[0], l_sys = logs[1], l_env = logs[2];
  const size_t row0 = (size_t)c.row0 * r;
  cg::this_cluster().sync();

  // 1. H-Krylov over the cluster, the env factor on the matvec output
  const ClusterOp op{H, Rt, stage, nc, M, r, Mc, hfac, false};
  const KrylovRun kh = cluster_lanczos_run<kThreads>(
      c, op, psi + row0, VH, prev, w, work, T, kmaxH, sre, sim, thresh, alpha,
      beta, coef, red2);
  cluster_lanczos_result<kThreads>(c, prev, w, c.nh * r, conserve, kh.beta0,
                                   red2);
  __syncthreads();

  // 2. gauge psi1 = Q sigma: psi1 gathered whole and factored by the
  // one-block MGS in every CTA alike (the same bits give the same Q and
  // sigma everywhere); then work holds Q whole (row-major) and Q this
  // CTA's rows
  for (int i = tid; i < c.nh * r; i += kThreads) work[row0 + i] = w[i];
  cg::this_cluster().sync();
  cluster_gather<kThreads>(c, work, M, Mc, r);
  mgs_stage(work, Qc, M, M, r);
  __syncthreads();
  mgs_factor<kThreads>(Qc, M, sig, M, r, c1, c2, c3, red);
  cg::this_cluster().sync();  // every peer has gathered this CTA's rows
  for (int i = tid; i < M * r; i += kThreads) {
    const int n = i / r, j = i - n * r;
    const float2 qv = Qc[(size_t)j * M + n];
    work[i] = qv;
    if (n >= c.row0 && n < c.row0 + c.nh) Q[(n - c.row0) * rp + j] = qv;
  }
  __syncthreads();

  // 3. renormalisation: (H_c Q)[rows] in T, then the partial blocks
  rows_times_x<kThreads>(H, work, T, stage, nc, M, c.row0, c.nh, r, false);
  __syncthreads();
  // this CTA's partial blocks P[c][a][b] = sum_i conj(Q[i][a]) T[c][i][b]
  for (int idx = tid; idx < nb; idx += kThreads) {
    const int ch = idx / r2, ab = idx - ch * r2;
    const int a = ab / r, b = ab - a * r;
    const float2* t = T + (size_t)ch * c.nh * r + b;
    float sr = 0.f, si = 0.f;
    for (int i = 0; i < c.nh; ++i) {
      const float2 qa = Q[i * rp + a], tb = t[(size_t)i * r];
      sr += qa.x * tb.x + qa.y * tb.y;  // conj(qa) * tb
      si += qa.x * tb.y - qa.y * tb.x;
    }
    work[idx] = make_float2(sr, si);
  }
  // reduce-scatter: rank q sums slice q of the partials in rank order into
  // work[nb + slice]; then every CTA gathers the slices into work[0, nb)
  const int sl = (nb + c.size - 1) / c.size;
  cg::this_cluster().sync();
  {
    const int s0 = c.rank * sl, s1 = min(nb, s0 + sl);
    for (int idx = s0 + tid; idx < s1; idx += kThreads) {
      float2 t = cg::this_cluster().map_shared_rank(work, 0)[idx];
      for (int q = 1; q < c.size; ++q) {
        const float2 p = cg::this_cluster().map_shared_rank(work, q)[idx];
        t.x += p.x;
        t.y += p.y;
      }
      work[nb + idx] = t;
    }
  }
  cg::this_cluster().sync();
  for (int q = 0; q < c.size; ++q) {
    const int s0 = q * sl, s1 = min(nb, s0 + sl);
    const float2* src = cg::this_cluster().map_shared_rank(work, q);
    for (int idx = s0 + tid; idx < s1; idx += kThreads)
      work[idx] = src[nb + idx];
  }
  __syncthreads();
  float2* blk = work;  // (nc, r, r)
  float s = 0.f;
  for (int i = tid; i < nb; i += kThreads) {
    const float2 a = blk[i];
    s += a.x * a.x + a.y * a.y;
  }
  const float nrm = fmaxf(sqrtf(block_sum2<kThreads>(s, 0.f, red2).x), 1e-30f);
  for (int i = tid; i < nb; i += kThreads) {
    const float2 a = blk[i];
    blk[i] = make_float2(a.x / nrm, a.y / nrm);
  }
  const float lnew = l_sys + logf(nrm);
  const float kfac = expf(lnew + l_env);
  __syncthreads();

  // 5. (own rows) site_out = Q row-major
  for (int i = tid; i < c.nh * r; i += kThreads) {
    const int n = i / r, j = i - n * r;
    site_out[row0 + i] = Q[n * rp + j];
  }
  if (c.rank == 0) {
    // 4. K-Krylov on sigma with -scale: kL = the new blocks, kR = Rt, on
    // rank 0 alone (the others wait at the last barrier)
    auto mv_k = [&](const float2* x, float2* y) {
      matvec(blk, Rt, x, tmpK, y, nc, r, r, kfac, As, Bs);
    };
    const KrylovRun kk = lanczos_run(mv_k, sig, VK, prevK, wK, r2, kmaxK,
                                     -sre, -sim, thresh, alpha, beta, coef,
                                     red2);
    lanczos_result(prevK, sig, r2, conserve, kk.beta0, red2);
    __syncthreads();
    // 5. absorb psi_next = sigma1 next; the blocks as (r, nc, r)
    cgemm<false>(sig, r, 1, nxt, P2, 1, psi_next, P2, 1, r, P2, r, As, Bs);
    for (int i = tid; i < nb; i += kThreads) {
      const int ch = i / r2, rem = i - ch * r2;
      const int x = rem / r, y = rem - x * r;
      blocks_out[((size_t)x * nc + ch) * r + y] = blk[i];
    }
    if (tid == 0) {
      log_new[0] = lnew;
      status[0] = kh.k;
      status[1] = (kh.bad && kmaxH < M * r) ? 1 : 0;
      status[2] = kk.k;
      status[3] = (kk.bad && kmaxK < r2) ? 1 : 0;
    }
  }
  // no CTA leaves while another may still address its shared memory
  cg::this_cluster().sync();
}

// Dynamic shared memory of one launch (bytes): the blocks, sigma and
// three MGS coefficient columns (cuda_site.smem_bytes).
int site_step_smem(int nc, int M, int r) {
  return (int)(sizeof(float2) * ((size_t)(nc + 1) * r * r + 3 * (size_t)r));
}

// Dynamic shared memory of one CTA of the cluster route (bytes;
// cuda_site.smem_bytes(..., "cluster", C)).
size_t site_step_cluster_smem(int nc, int M, int r, int C) {
  const size_t Mc = (M + C - 1) / C, rr = (size_t)r * r;
  return sizeof(float2) *
         (std::max((size_t)M * r, 2 * nc * rr) + (nc + 2) * Mc * r +
          Mc * (r | 1) + (3 + 2 * (size_t)C) * r + rr +
          nc * Mc * (kChunk + 1) + (size_t)M * r);
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

// The cluster route: one cluster of C CTAs, ceil(M / C) rows each;
// cudaErrorInvalidClusterSize if the card cannot schedule such a cluster.
extern "C" int pytdscf_site_step_cluster_c64(
    int device, const void* H, const void* Rt, const void* psi,
    const void* nxt, const void* logs, void* site_out, void* psi_next,
    void* blocks, void* log_new, void* status, void* scratch, int nc, int M,
    int r, int P2, int kmaxH, int kmaxK, float scale_re, float scale_im,
    float thresh, int conserve, int C, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int Mc = (M + C - 1) / C;
  return (int)launch_cluster(
      device, site_step_cluster_kernel, C, kThreads,
      site_step_cluster_smem(nc, M, r, C),
      static_cast<cudaStream_t>(stream),
      static_cast<const float2*>(H), static_cast<const float2*>(Rt),
      static_cast<const float2*>(psi), static_cast<const float2*>(nxt),
      static_cast<const float*>(logs), static_cast<float2*>(site_out),
      static_cast<float2*>(psi_next), static_cast<float2*>(blocks),
      static_cast<float*>(log_new), static_cast<int*>(status),
      static_cast<float2*>(scratch), nc, M, r, P2, kmaxH, kmaxK, scale_re,
      scale_im, thresh, conserve, Mc);
}
