// Device building blocks of the one-block TDVP kernels (lanczos_expm.cu,
// mgs_qr.cu, site_step.cu): block-wide reductions, the MGS(×2) thin QR, the
// channel matvec y = fac · Σ_c H_c (x Rt_c), a strided tiled complex matmul,
// the tridiagonal Taylor exponential and the Lanczos recurrence.
//
// Every function runs in ONE thread block and is called by all of its
// threads (each contains __syncthreads).  Functions whose loops stride by
// the block size take it as the template parameter kThreads; the matvec,
// the matmul and the Lanczos recurrence assume kThreads == kTile * kTile ==
// 1024.  Layout: complex64 as float2, row-major unless stated.  The
// definitions sit in an anonymous namespace, so each kernel source gets its
// own copy (no relocatable device code, no device link).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;  // the tiled products take kTile * kTile threads
constexpr int kTileThreads = kTile * kTile;
constexpr int kMaxK = 32;  // one warp holds the Lanczos coefficient vector
constexpr int kTaylorOrder = 10;
constexpr float kSubstepNorm = 0.5f;
constexpr int kMaxSubsteps = 65536;
constexpr float kEpsBreakdown = 1.0e-14f;
constexpr float kRankTol = 1.0e-7f;

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

// One Gram–Schmidt pass of x (N) against Q[:, :k] (column-major, column j
// at Q + j * N): c[j] = <Q_j|x> for j < k, then x -= sum_j Q_j c[j].
template <int kThreads>
__device__ void gs_pass(const float2* Q, float2* x, float2* c, int N, int k) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = warp; j < k; j += kWarps) {
    const float2* q = Q + (size_t)j * N;
    float re = 0.f, im = 0.f;
    for (int n = lane; n < N; n += 32) {
      const float2 a = q[n], b = x[n];
      re += a.x * b.x + a.y * b.y;  // conj(a) * b
      im += a.x * b.y - a.y * b.x;
    }
    re = warp_sum(re);
    im = warp_sum(im);
    if (lane == 0) c[j] = make_float2(re, im);
  }
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += kThreads) {
    float sr = 0.f, si = 0.f;
    for (int j = 0; j < k; ++j) {
      const float2 a = Q[(size_t)j * N + n], b = c[j];
      sr += a.x * b.x - a.y * b.y;
      si += a.x * b.y + a.y * b.x;
    }
    const float2 xv = x[n];
    x[n] = make_float2(xv.x - sr, xv.y - si);
  }
  __syncthreads();
}

template <int kThreads>
__device__ float norm2(const float2* x, int N, float* red) {
  float s = 0.f;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    const float2 a = x[n];
    s += a.x * a.x + a.y * a.y;
  }
  return block_sum<kThreads>(s, red);
}

// Thin QR m = Q R of the (N, r) matrix m, N >= r >= 1, by MGS with two
// passes per column; Q comes out column-major (column j at Q + j * N), R
// row-major (r, r).  scale = ||m||_F + 1e-30; column k is projected twice
// (R[:k, k] = c1 + c2); nv = ||v|| < 1e-7 scale marks a dead column, which
// gets the canonical vector e_{k mod N} orthogonalised twice and a zero R
// diagonal.  v and e hold N entries, c1, c2, c3 r entries each.
template <int kThreads>
__device__ void mgs_factor(const float2* m, float2* Q, float2* R, int N, int r,
                           float2* v, float2* e, float2* c1, float2* c2,
                           float2* c3, float* red) {
  const int tid = threadIdx.x;
  for (int i = tid; i < N * r; i += kThreads) Q[i] = make_float2(0.f, 0.f);
  for (int i = tid; i < r * r; i += kThreads) R[i] = make_float2(0.f, 0.f);
  float s = 0.f;
  for (int i = tid; i < N * r; i += kThreads) {
    const float2 a = m[i];
    s += a.x * a.x + a.y * a.y;
  }
  const float scale = sqrtf(block_sum<kThreads>(s, red)) + 1e-30f;

  for (int k = 0; k < r; ++k) {
    for (int n = tid; n < N; n += kThreads) v[n] = m[(size_t)n * r + k];
    __syncthreads();
    gs_pass<kThreads>(Q, v, c1, N, k);
    gs_pass<kThreads>(Q, v, c2, N, k);
    const float nv = sqrtf(norm2<kThreads>(v, N, red));
    const bool bad = nv < kRankTol * scale;  // uniform across the block
    float2* col = Q + (size_t)k * N;
    if (bad) {
      for (int n = tid; n < N; n += kThreads)
        e[n] = make_float2(n == k % N ? 1.f : 0.f, 0.f);
      __syncthreads();
      gs_pass<kThreads>(Q, e, c3, N, k);
      gs_pass<kThreads>(Q, e, c3, N, k);
      const float ne = sqrtf(norm2<kThreads>(e, N, red)) + 1e-30f;
      for (int n = tid; n < N; n += kThreads)
        col[n] = make_float2(e[n].x / ne, e[n].y / ne);
    } else {
      for (int n = tid; n < N; n += kThreads)
        col[n] = make_float2(v[n].x / nv, v[n].y / nv);
    }
    for (int j = tid; j < k; j += kThreads)
      R[(size_t)j * r + k] = make_float2(c1[j].x + c2[j].x, c1[j].y + c2[j].y);
    if (tid == 0) R[(size_t)k * r + k] = make_float2(bad ? 0.f : nv, 0.f);
    __syncthreads();
  }
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

}  // namespace
