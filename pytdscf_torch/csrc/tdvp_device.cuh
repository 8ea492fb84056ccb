// Device building blocks of the TDVP kernels (lanczos_expm.cu, mgs_qr.cu,
// site_step.cu), in two layers.
//
// The one-block layer: block-wide reductions, the MGS(×2) thin QR, the
// channel matvec y = fac · Σ_c H_c (x Rt_c), a strided tiled complex
// matmul, the tridiagonal Taylor exponential and the Lanczos recurrence.
// Every function runs in ONE thread block and is called by all of its
// threads (each contains __syncthreads).  Functions whose loops stride by
// the block size take it as the template parameter kThreads; the matvec,
// the matmul and the Lanczos recurrence assume kThreads == kTile * kTile ==
// 1024.  Small shapes take this layer (cuda_lanczos.route, cuda_site.route),
// and the fused site step runs its (r, r) K-Krylov on it.
//
// The cluster layer (below the one-block layer): the same recurrence, the
// matvec and the MGS on ONE thread-block cluster of C CTAs.  Rank q owns
// rows [q·Mc, min(M, (q+1)·Mc)), Mc = ceil(M / C), of every H_c, of every
// Krylov vector and of ψ; a rank may own no rows and still reaches every
// barrier, adding zeros.  Every reduction is a per-CTA partial stored into
// slot [rank] of each CTA's inbox (distributed shared memory), summed in
// rank order 0..C-1 after one cluster barrier: every CTA gets the same bits
// and takes the same branch (convergence, breakdown, dead column), so none
// leaves a loop alone.  The matvec's only exchange is the gather of the
// whole x from the peers' shared memory (map_shared_rank); no exchange goes
// through global memory.  A CTA's rows of H_c sit in its shared memory,
// loaded once per call where they fit (the Lanczos kernel at the bulk on
// 16 CTAs, 115 KB), else stream from L2 through a slice of kChunk columns.
//
// Layout: complex64 as float2, row-major unless stated.  The definitions
// sit in an anonymous namespace, so each kernel source gets its own copy
// (no relocatable device code, no device link).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <mutex>
#include <vector>

namespace {

namespace cg = cooperative_groups;

constexpr int kTile = 32;  // the tiled products take kTile * kTile threads
constexpr int kTileThreads = kTile * kTile;
constexpr int kMaxK = 32;  // one warp holds the Lanczos coefficient vector
constexpr int kTaylorOrder = 10;
constexpr float kSubstepNorm = 0.5f;
constexpr int kMaxSubsteps = 65536;
constexpr float kEpsBreakdown = 1.0e-14f;
constexpr float kRankTol = 1.0e-7f;
// A dead column's completion: the first canonical vector e_j, j = k, k+1,
// ... (mod N), whose residual orthogonalised twice (plus the 1e-30 guard of
// its normalisation) reaches completion_tol(N): e_{k mod N} wherever it
// does (the JAX package's semantics).  The bar is the float32 noise floor
// of two Gram-Schmidt passes over N rows, kCompletionNoise * sqrt(N) (16
// eps sqrt N): a canonical vector that lies in the span of the earlier
// columns (the even ground state of H2O on its symmetric grid) leaves a
// residual below it (9e-16 to 5e-8 for H2O's N = 9, against a bar of
// 5.7e-6), and improved relaxation then finds the spurious low end of an
// environment built on it: H2O's ZPE collapsed to 7.8e-13 on the H100.
// Any residual above it is orthogonalised to ~eps by the second pass
// (cuda_qr.completion_tol).  Some e_j keeps at least 1 / sqrt N, so the
// scan ends for N < 5e5.
constexpr float kCompletionNoise = 16.0f * 1.1920929e-7f;

__device__ __forceinline__ float completion_tol(int N) {
  return kCompletionNoise * sqrtf(static_cast<float>(N));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the block, returned to every thread (all threads add the warp
// partials in the same order, so the result is identical in every thread).
template <int kThreads>
__device__ float block_sum(float v, float* red) {
  constexpr int kWarps = kThreads / 32;
  v = warp_sum(v);
  __syncthreads();  // red may still be read by a previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < kWarps; ++i) t += red[i];
  return t;
}

// Sums of two values over the block, returned to every thread (each thread
// adds the warp partials in the same order: identical results everywhere).
template <int kThreads>
__device__ float2 block_sum2(float a, float b, float2* red) {
  constexpr int kWarps = kThreads / 32;
  a = warp_sum(a);
  b = warp_sum(b);
  __syncthreads();  // red may still be read by a previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
  for (int i = 0; i < kWarps; ++i) {
    t.x += red[i].x;
    t.y += red[i].y;
  }
  return t;
}

// ------------------------------------------------------------ MGS(×2) QR
//
// The one-block thin QR (mgs_factor) of the standalone kernel (mgs_qr.cu)
// and of the fused site's gauge (site_step.cu).  Neither bytes nor FLOPs
// bound it (a (240, 30) factor is 58 KB and 0.35 MFLOP) but the serial
// chain of r columns: per column two Gram–Schmidt passes, each k dot
// products over N rows, a block barrier, and a k-term update of the N rows.
// Each step of that chain is short, so what a column costs on an H100 is
// the latency of its steps, not their FLOPs nor the barriers between them:
// at (240, 30) with 1024 threads a phase of dot products takes ~1700
// cycles, an update ~1350-1500, a barrier 82 (scripts/mgs_blocks.py).  The
// design keeps the chain short and each step's loads in flight together:
//
//  * Q is the caller's buffer, column-major (column j at Q + j * ld, ld >=
//    N), and holds m's columns on entry, staged once before the loop:
//    column k is orthogonalised in place, so no column is read from device
//    memory inside the loop and no separate work vector exists.
//  * Latency first: each loop issues its loads several steps deep before
//    their FMAs, and stores nothing (the column scaled late is scaled in
//    the update), so nothing orders the next step's loads behind it.  The
//    dot products take two consecutive earlier columns per warp (one load
//    of x feeds both; 16 warps of 1024 threads cover k <= 32 in one round)
//    and reduce the warp's four partial sums by one reduce-scatter
//    butterfly (seven shuffles).  The update takes one row per thread (the
//    coefficients broadcast): lanes read consecutive rows, so Q needs no
//    padding against bank conflicts, and no shuffle is needed.  Four
//    columns a warp, a column a warp, an update not unrolled and an update
//    split over 2, 4 or 8 lanes a row (combined by shuffles, at a stride
//    free of bank conflicts) each measured slower (scripts/mgs_blocks.py).  1024 threads, as the fused
//    site runs the factor, measured fastest at (560, 20) (a row a thread)
//    and within 4-10 % of 256 or 512 at the other path shapes.
//  * Four block barriers per live column: after each pass's dot products
//    and after each pass's update.  ||v||^2 is summed by the threads that
//    finish the second update and reduced at the barrier that ends it; the
//    scaling of column k by 1 / ||v|| waits for column k+1: its dot
//    product is scaled as it is written, its rows by their threads in the
//    first update; R's entries are written by the lanes that finish them.
//
// Every reduction sums partials by the same butterfly in every warp, so
// every thread holds the same bits of ||m||, ||v|| and ||e|| and takes the
// same dead/live decision; no atomics: a repeated launch is bit-identical.

// The (N, r) matrix m (row-major, device or shared memory) into Q
// (column-major, stride ld), entry pairs (n, 2p), (n, 2p + 1) to
// neighbouring lanes (16 contiguous bytes of m; the stores to Q cover every
// bank pair twice for any ld).  The caller synchronises.
__device__ void mgs_stage(const float2* m, float2* Q, int ld, int N, int r) {
  const int step = blockDim.x, span = 2 * N;
  int p = 0, i = threadIdx.x;  // entry i of column pair p
  while (i >= span) {
    i -= span;
    p += 2;
  }
  for (; p < r;) {
    const int j = p + (i & 1), n = i >> 1;
    if (j < r) Q[(size_t)j * ld + n] = m[(size_t)n * r + j];
    i += step;
    while (i >= span) {
      i -= span;
      p += 2;
    }
  }
}

// The block's sum of one float per thread, the same bits in every thread:
// warp partials into part (kThreads / 32 floats), one barrier, then every
// warp adds them by the same butterfly.  The caller ensures that no thread
// still reads part from an earlier call (a barrier in between).
template <int kThreads>
__device__ float mgs_block_sum(float v, float* part) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  v = warp_sum(v);
  if (lane == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_sum(lane < kWarps ? part[lane] : 0.f);
}

// c[j] = <Q_j|x> for j < k: warp w takes columns 2w and 2w + 1 (then 2w +
// 2 kWarps ...), lanes over rows, the row loop unrolled four deep (its
// loads in flight together; nothing is stored in it).  Column `fix` is
// still unscaled: its coefficient is scaled by `inv` as it is written
// (mgs_update scales the column).  With `add`, R[j, k] = add[j] + c[j] is
// written at R_k[j * r].
template <int kThreads>
__device__ void mgs_dots(const float2* Q, int ld, int N, int k,
                         const float2* x, float2* c, int fix, float inv,
                         const float2* add, float2* R_k, int r) {
  constexpr int kWarps = kThreads / 32;
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  for (int j0 = 2 * (threadIdx.x >> 5); j0 < k; j0 += 2 * kWarps) {
    const bool pair = j0 + 1 < k;
    const float2* q0 = Q + (size_t)j0 * ld;
    const float2* q1 = pair ? q0 + ld : q0;
    float v[4] = {0.f, 0.f, 0.f, 0.f};  // conj(Q_j0) x, conj(Q_j0+1) x
#pragma unroll 4
    for (int n = lane; n < N; n += 32) {
      const float2 b = x[n], a0 = q0[n], a1 = q1[n];
      v[0] = fmaf(a0.x, b.x, fmaf(a0.y, b.y, v[0]));
      v[1] = fmaf(a0.x, b.y, fmaf(-a0.y, b.x, v[1]));
      v[2] = fmaf(a1.x, b.x, fmaf(a1.y, b.y, v[2]));
      v[3] = fmaf(a1.x, b.y, fmaf(-a1.y, b.x, v[3]));
    }
    // reduce-scatter: lane l ends with the warp's sum of v[(l >> 3) & 3]
    const bool h16 = lane & 16, h8 = lane & 8;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float send = h16 ? v[i] : v[i + 2];
      const float keep = h16 ? v[i + 2] : v[i];
      v[i] = keep + __shfl_xor_sync(full, send, 16);
    }
    {
      const float send = h8 ? v[0] : v[1];
      const float keep = h8 ? v[1] : v[0];
      v[0] = keep + __shfl_xor_sync(full, send, 8);
    }
    v[0] += __shfl_xor_sync(full, v[0], 4);
    v[0] += __shfl_xor_sync(full, v[0], 2);
    v[0] += __shfl_xor_sync(full, v[0], 1);
    const int idx = (lane >> 3) & 3, j = j0 + (idx >> 1), part = idx & 1;
    if ((lane & 7) == 0 && (idx < 2 || pair)) {
      if (j == fix) v[0] *= inv;
      reinterpret_cast<float*>(c + j)[part] = v[0];
      if (add != nullptr)
        reinterpret_cast<float*>(R_k + (size_t)j * r)[part] =
            reinterpret_cast<const float*>(add + j)[part] + v[0];
    }
  }
}

// x[n] -= sum_{j<k} Q_j[n] c[j] for every row n, one row per thread, the
// terms unrolled four deep over two FMA chains; with hot >= 0, x is e_hot
// instead of its stored value and c[j] = conj(Q_j[hot]) (e_hot's dot
// products, exact: one term of each is nonzero).  With fix >= 0, each
// thread first scales its row of column fix by inv (the deferred
// normalisation of the previous column).  Returns this thread's share of
// ||x||^2 after it.
template <int kThreads>
__device__ float mgs_update(float2* Q, int ld, int N, int k, float2* x,
                            const float2* c, int hot, int fix = -1,
                            float inv = 1.f) {
  float ss = 0.f;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    if (fix >= 0) {
      float2* f = Q + (size_t)fix * ld + n;
      *f = make_float2(f->x * inv, f->y * inv);
    }
    float s[4] = {0.f, 0.f, 0.f, 0.f};  // two chains, (re, im) each
    const float2* q = Q + n;
    const int off = hot - n;  // e_hot's coefficient of column j at q[off]
#pragma unroll 4
    for (int j = 0; j < k; ++j) {
      const float2 a = q[(size_t)j * ld];
      float2 b;
      if (hot < 0) {
        b = c[j];
      } else {
        b = q[(size_t)j * ld + off];
        b.y = -b.y;
      }
      const int h = 2 * (j & 1);
      s[h] = fmaf(a.x, b.x, fmaf(-a.y, b.y, s[h]));
      s[h + 1] = fmaf(a.x, b.y, fmaf(a.y, b.x, s[h + 1]));
    }
    const float2 xv = hot < 0 ? x[n] : make_float2(n == hot ? 1.f : 0.f, 0.f);
    const float2 y = make_float2(xv.x - (s[0] + s[2]), xv.y - (s[1] + s[3]));
    x[n] = y;
    ss += y.x * y.x + y.y * y.y;
  }
  return ss;
}

// Thin QR m = Q R of the (N, r) matrix m, N >= r >= 1, by MGS with two
// passes per column, in place: Q (column-major, column j at Q + j * ld,
// ld >= N) holds m's columns on entry and Q's on exit; R row-major (r, r).
// scale = ||m||_F + 1e-30; column k is projected twice (R[:k, k] = c1 +
// c2); nv = ||v|| < 1e-7 scale marks a dead column, which gets a zero R
// diagonal and the first canonical vector e_j, j = k, k+1, ... (mod N),
// orthogonalised twice whose residual reaches completion_tol(N) (e_{k mod
// N} wherever it does).  A column is scaled by the reciprocal of its norm.
// c1, c2, c3 hold r entries each, red 2 kThreads / 32 floats.  Q and R may
// lie in shared or device memory.
template <int kThreads>
__device__ void mgs_factor(float2* Q, int ld, float2* R, int N, int r,
                           float2* c1, float2* c2, float2* c3, float* red) {
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x;
  float* part = red;             // ||v||^2, ||e||^2 partials
  float* part_m = red + kWarps;  // ||m||^2 partials
  for (int a = 1; a < r; ++a)
    for (int b = tid; b < a; b += kThreads)
      R[(size_t)a * r + b] = make_float2(0.f, 0.f);
  float s = 0.f;
  for (int j = 0; j < r; ++j)
    for (int n = tid; n < N; n += kThreads) {
      const float2 a = Q[(size_t)j * ld + n];
      s += a.x * a.x + a.y * a.y;
    }
  const float scale = sqrtf(mgs_block_sum<kThreads>(s, part_m)) + 1e-30f;

  float div = 1.f;  // the previous column's norm (nv, or ne if dead)
  for (int k = 0; k < r; ++k) {
    float2* x = Q + (size_t)k * ld;
    if (k > 0) {
      // column k - 1 is scaled by 1 / div here: its coefficient as the
      // dot products write it, its rows in the first update
      const float inv = 1.f / div;
      mgs_dots<kThreads>(Q, ld, N, k, x, c1, k - 1, inv, nullptr, nullptr, r);
      __syncthreads();
      mgs_update<kThreads>(Q, ld, N, k, x, c1, -1, k - 1, inv);
      __syncthreads();
      mgs_dots<kThreads>(Q, ld, N, k, x, c2, -1, 1.f, c1, R + k, r);
      __syncthreads();
    }
    const float nv = sqrtf(mgs_block_sum<kThreads>(
        mgs_update<kThreads>(Q, ld, N, k, x, c2, -1), part));
    const bool bad = nv < kRankTol * scale;  // uniform across the block
    div = nv;
    if (bad) {
      float ne = 0.f;
      for (int t = 0; t < N; ++t) {  // (ne is uniform across the block)
        mgs_update<kThreads>(Q, ld, N, k, x, nullptr, (k + t) % N);
        __syncthreads();
        mgs_dots<kThreads>(Q, ld, N, k, x, c3, -1, 1.f, nullptr, nullptr, r);
        __syncthreads();
        ne = sqrtf(mgs_block_sum<kThreads>(
                 mgs_update<kThreads>(Q, ld, N, k, x, c3, -1), part)) +
             1e-30f;
        if (ne >= completion_tol(N)) break;
      }
      div = ne;
    }
    if (tid == 0) R[(size_t)k * r + k] = make_float2(bad ? 0.f : nv, 0.f);
  }
  const float inv = 1.f / div;
  float2* last = Q + (size_t)(r - 1) * ld;
  for (int n = tid; n < N; n += kThreads)
    last[n] = make_float2(last[n].x * inv, last[n].y * inv);
  __syncthreads();
}

// --------------------------------------------------------- tiled products

// y = fac · sum_c H_c (x Rt_c): H (nc, M, M), Rt (nc, r, r), x and y (M, r);
// tmp holds the (nc, M, r) products x Rt_c.  The second product is a
// kTile x kTile shared-memory tiled complex matmul in plain fp32 FMA.
__device__ void matvec(const float2* __restrict__ H,
                       const float2* __restrict__ Rt, const float2* x,
                       float2* tmp, float2* y, int nc, int M, int r, float fac,
                       float2 (*As)[kTile + 1], float2 (*Bs)[kTile + 1]) {
  const int n = M * r;
  for (int idx = threadIdx.x; idx < nc * n; idx += kTileThreads) {
    const int c = idx / n, rem = idx - c * n;
    const int row = rem / r, col = rem - row * r;
    const float2* xr = x + (size_t)row * r;
    const float2* rt = Rt + (size_t)c * r * r + col;
    float sr = 0.f, si = 0.f;
    for (int j = 0; j < r; ++j) {
      const float2 a = xr[j], b = rt[(size_t)j * r];
      sr += a.x * b.x - a.y * b.y;
      si += a.x * b.y + a.y * b.x;
    }
    tmp[idx] = make_float2(sr, si);
  }
  __syncthreads();
  const int ty = threadIdx.x / kTile, tx = threadIdx.x % kTile;
  const float2 zero = make_float2(0.f, 0.f);
  for (int row0 = 0; row0 < M; row0 += kTile) {
    for (int col0 = 0; col0 < r; col0 += kTile) {
      float sr = 0.f, si = 0.f;
      for (int c = 0; c < nc; ++c) {
        const float2* Hc = H + (size_t)c * M * M;
        const float2* Tc = tmp + (size_t)c * n;
        for (int k0 = 0; k0 < M; k0 += kTile) {
          const int hr = row0 + ty, hk = k0 + tx;
          As[ty][tx] = (hr < M && hk < M) ? Hc[(size_t)hr * M + hk] : zero;
          const int tk = k0 + ty, tc = col0 + tx;
          Bs[ty][tx] = (tk < M && tc < r) ? Tc[(size_t)tk * r + tc] : zero;
          __syncthreads();
#pragma unroll 8
          for (int kk = 0; kk < kTile; ++kk) {
            const float2 a = As[ty][kk], b = Bs[kk][tx];
            sr += a.x * b.x - a.y * b.y;
            si += a.x * b.y + a.y * b.x;
          }
          __syncthreads();
        }
      }
      const int orow = row0 + ty, ocol = col0 + tx;
      if (orow < M && ocol < r)
        y[(size_t)orow * r + ocol] = make_float2(sr * fac, si * fac);
    }
  }
  __syncthreads();
}

// C(i, j) = sum_k op(A)(i, k) B(k, j), i < m, j < n, k < kd, with element
// (i, k) of A at A[i * ars + k * acs] (conjugated if kConjA), (k, j) of B at
// B[k * brs + j * bcs] and (i, j) of C at C[i * crs + j * ccs]: the strides
// let one routine read a column-major factor or write a permuted output.
template <bool kConjA>
__device__ void cgemm(const float2* A, int ars, int acs, const float2* B,
                      int brs, int bcs, float2* C, int crs, int ccs, int m,
                      int n, int kd, float2 (*As)[kTile + 1],
                      float2 (*Bs)[kTile + 1]) {
  const int ty = threadIdx.x / kTile, tx = threadIdx.x % kTile;
  const float2 zero = make_float2(0.f, 0.f);
  for (int row0 = 0; row0 < m; row0 += kTile) {
    for (int col0 = 0; col0 < n; col0 += kTile) {
      float sr = 0.f, si = 0.f;
      for (int k0 = 0; k0 < kd; k0 += kTile) {
        const int ar = row0 + ty, ak = k0 + tx;
        float2 a = (ar < m && ak < kd) ? A[(size_t)ar * ars + (size_t)ak * acs]
                                       : zero;
        if (kConjA) a.y = -a.y;
        As[ty][tx] = a;
        const int bk = k0 + ty, bc = col0 + tx;
        Bs[ty][tx] = (bk < kd && bc < n)
                         ? B[(size_t)bk * brs + (size_t)bc * bcs] : zero;
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < kTile; ++kk) {
          const float2 p = As[ty][kk], q = Bs[kk][tx];
          sr += p.x * q.x - p.y * q.y;
          si += p.x * q.y + p.y * q.x;
        }
        __syncthreads();
      }
      const int orow = row0 + ty, ocol = col0 + tx;
      if (orow < m && ocol < n)
        C[(size_t)orow * crs + (size_t)ocol * ccs] = make_float2(sr, si);
    }
  }
  __syncthreads();
}

// ------------------------------------------------------------ Lanczos

// Warp 0: coef[0..k] = exp(scale T_k) e_0 for the symmetric tridiagonal
// T_k with diagonal alpha[0..k] and off-diagonal beta[0..k-1]; lane j
// holds entry j, lanes above k stay exactly zero.  Order-10 Taylor in m
// substeps, m = ceil(|scale| (max|alpha| + 2 max beta) / 0.5) from the
// Gershgorin bound, so each substep has norm <= 0.5.
__device__ void tridiag_expm_e0(const float* alpha, const float* beta, int k,
                                float sre, float sim, float2* coef) {
  const int j = threadIdx.x & 31;
  const float aj = j <= k ? alpha[j] : 0.f;
  const float bj = j < k ? beta[j] : 0.f;                     // T[j][j+1]
  const float bjm = (j >= 1 && j <= k) ? beta[j - 1] : 0.f;   // T[j][j-1]
  const float amax = warp_max(fabsf(aj));
  const float bmax = warp_max(bj);
  const float bound = sqrtf(sre * sre + sim * sim) * (amax + 2.f * bmax);
  const float q = ceilf(bound / kSubstepNorm);
  // a non-finite bound takes one substep (the NaN propagates to the result)
  const int msub = !(q >= 1.f) ? 1 : (q >= (float)kMaxSubsteps ? kMaxSubsteps : (int)q);
  const float inv = 1.f / (float)msub;
  const float ssr = sre * inv, ssi = sim * inv;
  float yr = j == 0 ? 1.f : 0.f, yi = 0.f;
  for (int s = 0; s < msub; ++s) {
    float tr = yr, ti = yi;
    for (int o = 1; o <= kTaylorOrder; ++o) {
      const float io = 1.f / (float)o;
      const float tmr = __shfl_up_sync(0xffffffffu, tr, 1);
      const float tmi = __shfl_up_sync(0xffffffffu, ti, 1);
      const float tpr = __shfl_down_sync(0xffffffffu, tr, 1);
      const float tpi = __shfl_down_sync(0xffffffffu, ti, 1);
      const float zr = aj * tr + bjm * tmr + bj * tpr;
      const float zi = aj * ti + bjm * tmi + bj * tpi;
      tr = (ssr * zr - ssi * zi) * io;
      ti = (ssr * zi + ssi * zr) * io;
      yr += tr;
      yi += ti;
    }
  }
  coef[j] = make_float2(yr, yi);
}

struct KrylovRun {
  int k;       // Krylov dimension used
  bool bad;    // capped without converging or breaking down
  float beta0; // ||v_in||
};

// The short-iterative Lanczos recurrence for exp(scale H) v_in, with
// mv(x, y) computing y = H x over n entries; leaves psi(k) = V c(k) in prev.
// Semantics of the JAX package's mps/integrator.py:_lanczos_loop:
//   * oblique alpha_k = <v_0|H v_k>; Re(alpha_k) on the diagonal of T;
//   * beta_k v_{k+1} = H v_k - alpha_k v_k - beta_{k-1} v_{k-1};
//     breakdown when beta_k < 1e-14 (v_{k+1} = 0, the loop stops);
//   * converged when k > 0 and ||psi(k) - psi(k-1)|| < thresh; capped at
//     k + 1 = kmax.
// V holds (kmax + 1) n entries, prev and w n each; alpha, beta and coef
// kMaxK each (shared), red kTileThreads / 32.  v_in is read before the
// first matvec only, so it may alias the output of lanczos_result.
template <class MatVec>
__device__ KrylovRun lanczos_run(MatVec mv, const float2* v_in, float2* V,
                                 float2* prev, float2* w, int n, int kmax,
                                 float sre, float sim, float thresh,
                                 float* alpha, float* beta, float2* coef,
                                 float2* red) {
  const int tid = threadIdx.x;
  float s = 0.f;
  for (int i = tid; i < n; i += kTileThreads) {
    const float2 a = v_in[i];
    s += a.x * a.x + a.y * a.y;
  }
  const float beta0 = sqrtf(block_sum2<kTileThreads>(s, 0.f, red).x);
  for (int i = tid; i < n; i += kTileThreads) {
    const float2 a = v_in[i];
    V[i] = make_float2(a.x / beta0, a.y / beta0);
    prev[i] = make_float2(0.f, 0.f);
  }
  __syncthreads();

  int k_fin = 0;
  bool bad = false;
  for (int k = 0; k < kmax; ++k) {
    const float2* vk = V + (size_t)k * n;
    mv(vk, w);
    // oblique alpha = <v_0|H v_k>
    float ar = 0.f, ai = 0.f;
    for (int i = tid; i < n; i += kTileThreads) {
      const float2 a = V[i], b = w[i];
      ar += a.x * b.x + a.y * b.y;
      ai += a.x * b.y - a.y * b.x;
    }
    const float2 al = block_sum2<kTileThreads>(ar, ai, red);
    const float bprev = k > 0 ? beta[k - 1] : 0.f;
    float s2 = 0.f;
    for (int i = tid; i < n; i += kTileThreads) {
      const float2 a = vk[i];
      float2 x = w[i];
      x.x -= al.x * a.x - al.y * a.y;
      x.y -= al.x * a.y + al.y * a.x;
      if (k > 0) {
        const float2 b = V[(size_t)(k - 1) * n + i];
        x.x -= bprev * b.x;
        x.y -= bprev * b.y;
      }
      w[i] = x;
      s2 += x.x * x.x + x.y * x.y;
    }
    const float bk = sqrtf(block_sum2<kTileThreads>(s2, 0.f, red).x);
    const bool live = bk > kEpsBreakdown;
    float2* vn = V + (size_t)(k + 1) * n;
    for (int i = tid; i < n; i += kTileThreads) {
      const float2 x = w[i];
      vn[i] = live ? make_float2(x.x / bk, x.y / bk) : make_float2(0.f, 0.f);
    }
    if (tid == 0) {
      alpha[k] = al.x;
      beta[k] = live ? bk : 0.f;
    }
    __syncthreads();
    if (tid < 32) tridiag_expm_e0(alpha, beta, k, sre, sim, coef);
    __syncthreads();
    // psi(k) = sum_{j <= k} coef_j v_j; err = ||psi(k) - psi(k-1)||
    float e2 = 0.f;
    for (int i = tid; i < n; i += kTileThreads) {
      float pr = 0.f, pi = 0.f;
      for (int j = 0; j <= k; ++j) {
        const float2 c = coef[j], a = V[(size_t)j * n + i];
        pr += c.x * a.x - c.y * a.y;
        pi += c.x * a.y + c.y * a.x;
      }
      const float2 p = prev[i];
      const float dr = pr - p.x, di = pi - p.y;
      e2 += dr * dr + di * di;
      prev[i] = make_float2(pr, pi);
    }
    const float err = sqrtf(block_sum2<kTileThreads>(e2, 0.f, red).x);
    const bool conv = k > 0 && err < thresh;
    const bool capped = k + 1 >= kmax;
    k_fin = k + 1;
    if (conv || !live || capped) {
      bad = capped && !conv && live;
      break;
    }
  }
  return KrylovRun{k_fin, bad, beta0};
}

// out = prev · (conserve ? 1 / ||prev|| : beta0) over n entries.
__device__ void lanczos_result(const float2* prev, float2* out, int n,
                               int conserve, float beta0, float2* red) {
  const int tid = threadIdx.x;
  float p2 = 0.f;
  for (int i = tid; i < n; i += kTileThreads) {
    const float2 a = prev[i];
    p2 += a.x * a.x + a.y * a.y;
  }
  const float fac =
      conserve ? 1.f / sqrtf(block_sum2<kTileThreads>(p2, 0.f, red).x) : beta0;
  for (int i = tid; i < n; i += kTileThreads) {
    const float2 a = prev[i];
    out[i] = make_float2(a.x * fac, a.y * fac);
  }
}

// ======================================================== the cluster layer

constexpr int kStrips = 4;  // row strips of the MGS dot products

// One CTA's view of the cluster: its rank, its rows and its inboxes.  A
// cluster-wide sum fills the inbox of the current parity and flips it; two
// alternate, so a CTA writes the next sum's partials only after passing the
// barrier of the previous one, which every CTA reaches only after it has
// read the inbox that is about to be reused.
struct ClusterRows {
  int rank;
  int size;       // CTAs in the cluster
  int row0;       // first row held here
  int nh;         // rows held here (Mc; fewer, or none, in the last CTAs)
  int r;          // entries of one rank's slot in an inbox (columns of Q)
  int rp;         // row stride of Q here (MGS): r rounded up to an odd number
  float2* part;   // [kStrips][r] strip partials of the MGS dot products
  float2* inbox;  // [2][size][r]
  int parity;

  // [size][r] inbox of the current sum
  __device__ float2* box() const { return inbox + parity * size * r; }
};

// This CTA's view of a cluster over M rows, Mc rows per rank.
__device__ ClusterRows cluster_rows(int M, int Mc, int r, float2* part,
                                    float2* inbox) {
  ClusterRows c;
  c.rank = (int)cg::this_cluster().block_rank();
  c.size = (int)cg::this_cluster().num_blocks();
  c.row0 = c.rank * Mc;
  c.nh = max(0, min(Mc, M - c.row0));
  c.r = r;
  c.rp = r | 1;
  c.part = part;
  c.inbox = inbox;
  c.parity = 0;
  return c;
}

// Cluster-wide sum of one complex value per CTA (`part`, the same in every
// thread of the CTA), returned to every thread of every CTA with the same
// bits: the partials are added in rank order.  kC: the cluster size when
// the kernel fixes it at compile time (its loops then unroll), or 0 for
// c.size; the same below.
template <int kC = 0>
__device__ float2 cluster_sum2(ClusterRows& c, float2 part) {
  const int C = kC > 0 ? kC : c.size;
  float2* box = c.box();
  if (threadIdx.x < C)
    cg::this_cluster().map_shared_rank(box, threadIdx.x)[c.rank * c.r] = part;
  cg::this_cluster().sync();
  float2 t = box[0];
  for (int q = 1; q < C; ++q) {
    t.x += box[q * c.r].x;
    t.y += box[q * c.r].y;
  }
  c.parity ^= 1;
  return t;
}

template <int kC = 0>
__device__ float cluster_sum(ClusterRows& c, float part) {
  return cluster_sum2<kC>(c, make_float2(part, 0.f)).x;
}

// ||x||^2 over the cluster's rows of x (this CTA's nh entries).
template <int kThreads, int kC = 0>
__device__ float cluster_norm2(ClusterRows& c, const float2* x, float* red) {
  float s = 0.f;
  for (int n = threadIdx.x; n < c.nh; n += kThreads) {
    const float2 a = x[n];
    s += a.x * a.x + a.y * a.y;
  }
  return cluster_sum<kC>(c, block_sum<kThreads>(s, red));
}

// One Gram–Schmidt pass of x (this CTA's rows) against Q[:, :k] over all
// rows: the coefficients cf[j] = <Q_j|x> (partials over each CTA's rows,
// summed in rank order), then x -= sum_j Q_j cf[j] on this CTA's rows.
// Q is row-major with an odd row stride, so that both the dot products
// (threads over j, one row strip per warp) and the update (threads over n)
// read distinct banks.
template <int kThreads, int kC = 0>
__device__ void cluster_gs_pass(ClusterRows& c, const float2* Q, float2* x,
                                float2* cf, int k) {
  constexpr int kStripCols = kThreads / kStrips;  // columns per strip round
  const int C = kC > 0 ? kC : c.size;
  const int strip = threadIdx.x / kStripCols, jt = threadIdx.x % kStripCols;
  const int len = (c.nh + kStrips - 1) / kStrips;
  const int n0 = strip * len, n1 = min(c.nh, n0 + len);
  for (int j = jt; j < k; j += kStripCols) {
    float re = 0.f, im = 0.f;
    for (int n = n0; n < n1; ++n) {
      const float2 a = Q[n * c.rp + j], b = x[n];
      re += a.x * b.x + a.y * b.y;  // conj(a) * b
      im += a.x * b.y - a.y * b.x;
    }
    c.part[strip * c.r + j] = make_float2(re, im);
  }
  __syncthreads();
  float2* box = c.box();
  for (int j = threadIdx.x; j < k; j += kThreads) {
    float2 t = c.part[j];
    for (int s = 1; s < kStrips; ++s) {
      t.x += c.part[s * c.r + j].x;
      t.y += c.part[s * c.r + j].y;
    }
    for (int q = 0; q < C; ++q)
      cg::this_cluster().map_shared_rank(box, q)[c.rank * c.r + j] = t;
  }
  cg::this_cluster().sync();
  for (int j = threadIdx.x; j < k; j += kThreads) {
    float2 t = box[j];
    for (int q = 1; q < C; ++q) {
      t.x += box[q * c.r + j].x;
      t.y += box[q * c.r + j].y;
    }
    cf[j] = t;
  }
  c.parity ^= 1;
  __syncthreads();
  for (int n = threadIdx.x; n < c.nh; n += kThreads) {
    float sr = 0.f, si = 0.f;
    for (int j = 0; j < k; ++j) {
      const float2 a = Q[n * c.rp + j], b = cf[j];
      sr += a.x * b.x - a.y * b.y;
      si += a.x * b.y + a.y * b.x;
    }
    const float2 xv = x[n];
    x[n] = make_float2(xv.x - sr, xv.y - si);
  }
  __syncthreads();
}

// Thin QR over the cluster by MGS(×2), with mgs_factor's semantics (dead
// columns completed by the first canonical vector from e_{k mod N} on
// whose residual orthogonalised twice reaches completion_tol(N), zero R
// diagonal).
// Q (this CTA's nh rows, row stride c.rp, in its shared memory) holds the
// rows of m on entry and the rows of Q on return; N is the number of rows
// over the cluster, r = c.r the number of columns.  R (r, r), if not null,
// receives every column whole (every CTA computes the same values).  A
// column costs three cluster barriers (two passes and ||v||), six if it is
// dead.  v and e hold nh entries, c1, c2, c3 r each.
template <int kThreads, int kC = 0>
__device__ void cluster_mgs_factor(ClusterRows& c, float2* Q, float2* R,
                                   int N, float2* v, float2* e, float2* c1,
                                   float2* c2, float2* c3, float* red) {
  const int tid = threadIdx.x, r = c.r;
  __syncthreads();
  float s = 0.f;
  for (int i = tid; i < c.nh * r; i += kThreads) {
    const int n = i / r, j = i - n * r;
    const float2 a = Q[n * c.rp + j];
    s += a.x * a.x + a.y * a.y;
  }
  // every CTA of the cluster runs before any addresses another's memory
  cg::this_cluster().sync();
  const float scale =
      sqrtf(cluster_sum<kC>(c, block_sum<kThreads>(s, red))) + 1e-30f;

  for (int k = 0; k < r; ++k) {
    // column k of Q, which still holds column k of m
    for (int n = tid; n < c.nh; n += kThreads) v[n] = Q[n * c.rp + k];
    __syncthreads();
    if (k > 0) {  // (against no columns a pass leaves v as it is)
      cluster_gs_pass<kThreads, kC>(c, Q, v, c1, k);
      cluster_gs_pass<kThreads, kC>(c, Q, v, c2, k);
    }
    const float nv = sqrtf(cluster_norm2<kThreads, kC>(c, v, red));
    const bool bad = nv < kRankTol * scale;  // the same in every CTA
    if (bad) {
      float ne = 0.f;
      for (int t = 0; t < N; ++t) {  // (ne is the same in every CTA)
        const int hot = (k + t) % N - c.row0;  // row of e_j here, if any
        for (int n = tid; n < c.nh; n += kThreads)
          e[n] = make_float2(n == hot ? 1.f : 0.f, 0.f);
        __syncthreads();
        if (k > 0) {
          cluster_gs_pass<kThreads, kC>(c, Q, e, c3, k);
          cluster_gs_pass<kThreads, kC>(c, Q, e, c3, k);
        }
        ne = sqrtf(cluster_norm2<kThreads, kC>(c, e, red)) + 1e-30f;
        if (ne >= completion_tol(N)) break;
      }
      for (int n = tid; n < c.nh; n += kThreads)
        Q[n * c.rp + k] = make_float2(e[n].x / ne, e[n].y / ne);
    } else {
      for (int n = tid; n < c.nh; n += kThreads)
        Q[n * c.rp + k] = make_float2(v[n].x / nv, v[n].y / nv);
    }
    if (R != nullptr) {  // column k of R, whole
      for (int j = tid; j < r; j += kThreads) {
        float2 rv = make_float2(0.f, 0.f);
        if (j < k) rv = make_float2(c1[j].x + c2[j].x, c1[j].y + c2[j].y);
        if (j == k && !bad) rv = make_float2(nv, 0.f);
        R[(size_t)j * r + k] = rv;
      }
    }
    __syncthreads();
  }
}

// Copies every peer's rows of a row-major (M, r) matrix, held as xs in
// each CTA's shared memory (rank q's rows at xs + q Mc r), into this CTA's
// xs.  The caller has passed a cluster barrier since every CTA wrote its
// rows.
template <int kThreads>
__device__ void cluster_gather(const ClusterRows& c, float2* xs, int M,
                               int Mc, int r) {
  for (int q = 0; q < c.size; ++q) {
    if (q == c.rank) continue;
    const int i0 = min(M, q * Mc) * r, i1 = min(M, (q + 1) * Mc) * r;
    const float2* src = cg::this_cluster().map_shared_rank(xs, q);
    for (int i = i0 + threadIdx.x; i < i1; i += kThreads) xs[i] = src[i];
  }
  __syncthreads();
}

constexpr int kChunk = 32;  // depth of one staged slice of H's rows

// Copies this CTA's nc nh rows of H (nc, M, M), columns [k0, k0 + kn),
// into stage (row stride ks: odd, so rows two apart sit in other banks),
// coalesced; columns past kn up to kc are zeroed.
template <int kThreads>
__device__ void stage_rows(const float2* __restrict__ H, float2* stage,
                           int nc, int M, int row0, int nh, int k0, int kn,
                           int kc, int ks) {
  for (int e = threadIdx.x; e < nc * nh * kc; e += kThreads) {
    const int row = e / kc, kk = e - row * kc;
    const int c = row / nh, i = row - c * nh;
    stage[row * ks + kk] = kk < kn
        ? H[((size_t)c * M + row0 + i) * M + k0 + kk] : make_float2(0.f, 0.f);
  }
}

// T[c][i][j] = sum_k H_c[row0 + i][k] x[k][j] for this CTA's nh rows: H
// (nc, M, M) in device memory, x (M, r) whole in shared memory, T (nc, nh,
// r).  The CTA's rows of H come from stage: all M columns, loaded once by
// the caller (resident: row stride M + 1, stage_rows), or kChunk columns
// at a time loaded here (row stride kChunk + 1).  Each thread computes a
// 2 x 2 tile (rows ci, ci + 1 of the nc nh rows, columns j, j + 1), so one
// read of H and of x feeds two products each.  (A bulk Lanczos iteration
// on 16 CTAs took 0.063 ms with one output per thread and H read straight
// from device memory, 0.054 ms with 2 x 2 tiles and slices, 0.043 ms with
// the rows resident; chip_smoke.py, PERF.md §6.)
template <int kThreads>
__device__ void rows_times_x(const float2* __restrict__ H, const float2* xs,
                             float2* T, float2* stage, int nc, int M,
                             int row0, int nh, int r, bool resident) {
  const int rows = nc * nh, rp = (rows + 1) / 2, cp = (r + 1) / 2;
  const int kc = resident ? M : kChunk, ks = kc + 1;
  for (int base = 0; base < rp * cp; base += kThreads) {
    const int idx = base + threadIdx.x;
    const bool mine = idx < rp * cp;
    const int ci = mine ? 2 * (idx / cp) : 0;
    const int j = mine ? 2 * (idx - (idx / cp) * cp) : 0;
    const bool row2 = ci + 1 < rows, col2 = j + 1 < r;
    const float2* h0 = stage + (size_t)ci * ks;
    const float2* h1 = h0 + (row2 ? ks : 0);
    float2 t00 = make_float2(0.f, 0.f), t01 = t00, t10 = t00, t11 = t00;
    for (int k0 = 0; k0 < M; k0 += kc) {
      const int kn = min(kc, M - k0);
      if (!resident) {
        __syncthreads();  // the previous slice is no longer read
        stage_rows<kThreads>(H, stage, nc, M, row0, nh, k0, kn, kc, ks);
        __syncthreads();
      }
      if (mine) {
#pragma unroll 4
        for (int kk = 0; kk < kn; ++kk) {
          const float2* xr = xs + (k0 + kk) * r + j;
          const float2 x0 = xr[0], x1 = col2 ? xr[1] : x0;
          const float2 a = h0[kk], b = h1[kk];
          t00.x += a.x * x0.x - a.y * x0.y;
          t00.y += a.x * x0.y + a.y * x0.x;
          t01.x += a.x * x1.x - a.y * x1.y;
          t01.y += a.x * x1.y + a.y * x1.x;
          t10.x += b.x * x0.x - b.y * x0.y;
          t10.y += b.x * x0.y + b.y * x0.x;
          t11.x += b.x * x1.x - b.y * x1.y;
          t11.y += b.x * x1.y + b.y * x1.x;
        }
      }
    }
    if (mine) {
      T[(size_t)ci * r + j] = t00;
      if (col2) T[(size_t)ci * r + j + 1] = t01;
      if (row2) T[(size_t)(ci + 1) * r + j] = t10;
      if (row2 && col2) T[(size_t)(ci + 1) * r + j + 1] = t11;
    }
  }
}

// y[i][j] = fac · sum_c sum_m T[c][i][m] Rt_c[m][j], i < nh: the second
// product of the matvec, row-local.
template <int kThreads>
__device__ void rows_times_rt(const float2* T, const float2* __restrict__ Rt,
                              float2* y, int nc, int nh, int r, float fac) {
  for (int idx = threadIdx.x; idx < nh * r; idx += kThreads) {
    const int i = idx / r, j = idx - i * r;
    float sr = 0.f, si = 0.f;
    for (int c = 0; c < nc; ++c) {
      const float2* t = T + ((size_t)c * nh + i) * r;
      const float2* rt = Rt + (size_t)c * r * r + j;
      for (int m = 0; m < r; ++m) {
        const float2 a = t[m], b = __ldg(rt + (size_t)m * r);
        sr += a.x * b.x - a.y * b.y;
        si += a.x * b.y + a.y * b.x;
      }
    }
    y[idx] = make_float2(sr * fac, si * fac);
  }
}

// The operator of a cluster Lanczos run: y = fac · sum_c H_c (x Rt_c),
// Mc rows of H_c per rank.
struct ClusterOp {
  const float2* H;   // (nc, M, M), device memory
  const float2* Rt;  // (nc, r, r), device memory
  float2* stage;     // shared memory: the CTA's rows of H (rows_times_x)
  int nc, M, r, Mc;
  float fac;
  bool resident;     // stage holds all M columns, loaded once
};

// y (this CTA's rows) = the operator applied to x, whose rows each CTA has
// written into its own rows of xs (M, r).  Starts with the cluster barrier
// that makes the peers' rows readable, gathers them, then runs both
// products on this CTA's rows.  T holds (nc, Mc, r).
template <int kThreads>
__device__ void cluster_matvec(ClusterRows& c, const ClusterOp& op,
                               float2* xs, float2* T, float2* y) {
  cg::this_cluster().sync();
  cluster_gather<kThreads>(c, xs, op.M, op.Mc, op.r);
  rows_times_x<kThreads>(op.H, xs, T, op.stage, op.nc, op.M, c.row0, c.nh,
                         op.r, op.resident);
  __syncthreads();
  rows_times_rt<kThreads>(T, op.Rt, y, op.nc, c.nh, op.r, op.fac);
  __syncthreads();
}

// lanczos_run over the cluster: the same recurrence, sums and decisions,
// each CTA on its own rows.  v_in: this CTA's rows (nh r entries).  V:
// this CTA's rows of the kmax + 1 Krylov vectors, Mc r apart, in device
// memory of its own (only this CTA reads them).  prev and w: its rows, in
// shared memory; xs (M, r) the gathered matvec input, T the matvec's
// intermediate.  alpha, beta, coef kMaxK each, red kThreads / 32.  Four
// cluster barriers an iteration: the matvec's gather, alpha, beta and the
// error.  Every CTA runs tridiag_expm_e0 (warp 0) on the same alpha and
// beta bits, so all stop at the same k.  The caller has passed a cluster
// barrier since the kernel started.
template <int kThreads>
__device__ KrylovRun cluster_lanczos_run(ClusterRows& c, const ClusterOp& op,
                                         const float2* v_in, float2* V,
                                         float2* prev, float2* w, float2* xs,
                                         float2* T, int kmax, float sre,
                                         float sim, float thresh,
                                         float* alpha, float* beta,
                                         float2* coef, float2* red) {
  const int tid = threadIdx.x, n = c.nh * op.r;
  const size_t slot = (size_t)op.Mc * op.r;
  float2* xo = xs + (size_t)c.row0 * op.r;  // this CTA's rows of x
  if (op.resident)  // (read first after the matvec's barriers)
    stage_rows<kThreads>(op.H, op.stage, op.nc, op.M, c.row0, c.nh, 0, op.M,
                         op.M, op.M + 1);
  float s = 0.f;
  for (int i = tid; i < n; i += kThreads) {
    const float2 a = v_in[i];
    s += a.x * a.x + a.y * a.y;
  }
  const float beta0 =
      sqrtf(cluster_sum(c, block_sum2<kThreads>(s, 0.f, red).x));
  for (int i = tid; i < n; i += kThreads) {
    const float2 a = v_in[i];
    const float2 v0 = make_float2(a.x / beta0, a.y / beta0);
    V[i] = v0;
    xo[i] = v0;
    prev[i] = make_float2(0.f, 0.f);
  }

  int k_fin = 0;
  bool bad = false;
  for (int k = 0; k < kmax; ++k) {
    const float2* vk = V + k * slot;
    cluster_matvec<kThreads>(c, op, xs, T, w);
    // oblique alpha = <v_0|H v_k>
    float ar = 0.f, ai = 0.f;
    for (int i = tid; i < n; i += kThreads) {
      const float2 a = V[i], b = w[i];
      ar += a.x * b.x + a.y * b.y;
      ai += a.x * b.y - a.y * b.x;
    }
    const float2 al = cluster_sum2(c, block_sum2<kThreads>(ar, ai, red));
    const float bprev = k > 0 ? beta[k - 1] : 0.f;
    float s2 = 0.f;
    for (int i = tid; i < n; i += kThreads) {
      const float2 a = vk[i];
      float2 x = w[i];
      x.x -= al.x * a.x - al.y * a.y;
      x.y -= al.x * a.y + al.y * a.x;
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
      alpha[k] = al.x;
      beta[k] = live ? bk : 0.f;
    }
    __syncthreads();
    if (tid < 32) tridiag_expm_e0(alpha, beta, k, sre, sim, coef);
    __syncthreads();
    // psi(k) = sum_{j <= k} coef_j v_j; err = ||psi(k) - psi(k-1)||
    float e2 = 0.f;
    for (int i = tid; i < n; i += kThreads) {
      float pr = 0.f, pi = 0.f;
      for (int j = 0; j <= k; ++j) {
        const float2 cj = coef[j], a = V[j * slot + i];
        pr += cj.x * a.x - cj.y * a.y;
        pi += cj.x * a.y + cj.y * a.x;
      }
      const float2 p = prev[i];
      const float dr = pr - p.x, di = pi - p.y;
      e2 += dr * dr + di * di;
      prev[i] = make_float2(pr, pi);
    }
    const float err =
        sqrtf(cluster_sum(c, block_sum2<kThreads>(e2, 0.f, red).x));
    const bool conv = k > 0 && err < thresh;
    const bool capped = k + 1 >= kmax;
    k_fin = k + 1;
    if (conv || !live || capped) {
      bad = capped && !conv && live;
      break;
    }
  }
  return KrylovRun{k_fin, bad, beta0};
}

// lanczos_result over the cluster: out (this CTA's rows) = prev ·
// (conserve ? 1 / ||prev|| : beta0), the norm a cluster sum.
template <int kThreads>
__device__ void cluster_lanczos_result(ClusterRows& c, const float2* prev,
                                       float2* out, int n, int conserve,
                                       float beta0, float2* red) {
  float p2 = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float2 a = prev[i];
    p2 += a.x * a.x + a.y * a.y;
  }
  const float fac =
      conserve
          ? 1.f / sqrtf(cluster_sum(c, block_sum2<kThreads>(p2, 0.f, red).x))
          : beta0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float2 a = prev[i];
    out[i] = make_float2(a.x * fac, a.y * fac);
  }
}

// Makes `kernel`'s cluster launch `cfg` ready on `device`, once per
// (device, kernel, C, bytes): raises the kernel's dynamic shared memory
// limit to the largest size asked for so far (never lowering it under a
// size already made ready), allows the non-portable sizes above 8, and
// checks with cudaOccupancyMaxActiveClusters that the card can hold one
// such cluster (cudaErrorInvalidClusterSize if not; a refused shape is
// not remembered, so it is refused again).  Later launches of a ready
// shape find it in the table and touch no attribute.  A shape first seen
// while its stream is being captured into a CUDA graph is refused with
// cudaErrorStreamCaptureUnsupported: a recorded launch must find its
// set-up done by a launch that ran.  A mutex guards the table: host
// threads may launch at once.
template <class Kernel>
cudaError_t cluster_ready(int device, Kernel kernel,
                          const cudaLaunchConfig_t& cfg) {
  struct Limit {  // what is set on one kernel on one device
    int device;
    const void* fn;
    size_t smem;
    bool nonportable;
  };
  struct Ready {
    int device;
    const void* fn;
    unsigned size;
    size_t smem;
  };
  static std::mutex mu;
  static std::vector<Limit> limits;
  static std::vector<Ready> ready;
  const void* fn = reinterpret_cast<const void*>(kernel);
  const unsigned size = cfg.gridDim.x;
  const size_t smem = cfg.dynamicSmemBytes;
  std::lock_guard<std::mutex> lock(mu);
  for (const Ready& e : ready)
    if (e.device == device && e.fn == fn && e.size == size && e.smem == smem)
      return cudaSuccess;
  cudaStreamCaptureStatus capture = cudaStreamCaptureStatusNone;
  cudaError_t err = cudaStreamIsCapturing(cfg.stream, &capture);
  if (err != cudaSuccess) return err;
  if (capture != cudaStreamCaptureStatusNone)
    return cudaErrorStreamCaptureUnsupported;
  size_t i = 0;
  while (i < limits.size() && !(limits[i].device == device &&
                                limits[i].fn == fn))
    ++i;
  if (i == limits.size()) limits.push_back(Limit{device, fn, 0, false});
  if (smem > limits[i].smem) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    limits[i].smem = smem;
  }
  if (size > 8 && !limits[i].nonportable) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    limits[i].nonportable = true;
  }
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (active < 1) return cudaErrorInvalidClusterSize;
  ready.push_back(Ready{device, fn, size, smem});
  return cudaSuccess;
}

// Launches `kernel` on `device` (the current device) as ONE cluster of C
// CTAs of `threads` threads with `smem` bytes of dynamic shared memory
// each, after cluster_ready.  Returns a CUDA error code;
// cudaErrorInvalidClusterSize when no such cluster fits.
template <class Kernel, class... Args>
cudaError_t launch_cluster(int device, Kernel kernel, int C, int threads,
                           size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cluster_ready(device, kernel, cfg);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
