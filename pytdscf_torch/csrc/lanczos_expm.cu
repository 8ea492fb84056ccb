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
// Layout: complex64 as float2, row-major, contiguous.  status = (k_used,
// bad) as int32.  scratch holds (kmax + 3 + nc) * M * r complex64.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // kThreads == kTile * kTile
constexpr int kMaxK = 32;  // one warp holds the coefficient vector
constexpr int kTaylorOrder = 10;
constexpr float kSubstepNorm = 0.5f;
constexpr int kMaxSubsteps = 65536;
constexpr float kEpsBreakdown = 1.0e-14f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sums of two values over the block, returned to every thread (each thread
// adds the warp partials in the same order: identical results everywhere).
__device__ float2 block_sum2(float a, float b, float2* red) {
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

// y = sum_c H_c (x Rt_c); tmp holds the (nc, M, r) products x Rt_c.
__device__ void matvec(const float2* __restrict__ H,
                       const float2* __restrict__ Rt, const float2* x,
                       float2* tmp, float2* y, int nc, int M, int r,
                       float2 (*As)[kTile + 1], float2 (*Bs)[kTile + 1]) {
  const int n = M * r;
  for (int idx = threadIdx.x; idx < nc * n; idx += kThreads) {
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
      if (orow < M && ocol < r) y[(size_t)orow * r + ocol] = make_float2(sr, si);
    }
  }
  __syncthreads();
}

// Warp 0: coef[0..k] = exp(scale T_k) e_0 for the symmetric tridiagonal
// T_k with diagonal alpha[0..k] and off-diagonal beta[0..k-1]; lane j
// holds entry j, lanes above k stay exactly zero.
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
  const int tid = threadIdx.x;
  const int n = M * r;
  // scratch is written and read back inside the launch: no __restrict__
  // const view of it may exist (the read-only cache is not coherent)
  float2* V = scratch;                          // (kmax + 1, n)
  float2* prev = V + (size_t)(kmax + 1) * n;    // (n) previous iterate
  float2* w = prev + n;                         // (n)
  float2* tmp = w + n;                          // (nc, n)

  float s = 0.f;
  for (int i = tid; i < n; i += kThreads) {
    const float2 a = v_in[i];
    s += a.x * a.x + a.y * a.y;
  }
  const float beta0 = sqrtf(block_sum2(s, 0.f, red).x);
  for (int i = tid; i < n; i += kThreads) {
    const float2 a = v_in[i];
    V[i] = make_float2(a.x / beta0, a.y / beta0);
    prev[i] = make_float2(0.f, 0.f);
  }
  __syncthreads();

  int k_fin = 0;
  bool bad = false;
  for (int k = 0; k < kmax; ++k) {
    const float2* vk = V + (size_t)k * n;
    matvec(H, Rt, vk, tmp, w, nc, M, r, As, Bs);
    // oblique alpha = <v_0|H v_k>
    float ar = 0.f, ai = 0.f;
    for (int i = tid; i < n; i += kThreads) {
      const float2 a = V[i], b = w[i];
      ar += a.x * b.x + a.y * b.y;
      ai += a.x * b.y - a.y * b.x;
    }
    const float2 al = block_sum2(ar, ai, red);
    const float bprev = k > 0 ? beta[k - 1] : 0.f;
    float s2 = 0.f;
    for (int i = tid; i < n; i += kThreads) {
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
    const float bk = sqrtf(block_sum2(s2, 0.f, red).x);
    const bool live = bk > kEpsBreakdown;
    float2* vn = V + (size_t)(k + 1) * n;
    for (int i = tid; i < n; i += kThreads) {
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
    for (int i = tid; i < n; i += kThreads) {
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
    const float err = sqrtf(block_sum2(e2, 0.f, red).x);
    const bool conv = k > 0 && err < thresh;
    const bool capped = k + 1 >= kmax;
    k_fin = k + 1;
    if (conv || !live || capped) {
      bad = capped && !conv && live;
      break;
    }
  }
  float p2 = 0.f;
  for (int i = tid; i < n; i += kThreads) {
    const float2 a = prev[i];
    p2 += a.x * a.x + a.y * a.y;
  }
  const float fac = conserve ? 1.f / sqrtf(block_sum2(p2, 0.f, red).x) : beta0;
  for (int i = tid; i < n; i += kThreads) {
    const float2 a = prev[i];
    out[i] = make_float2(a.x * fac, a.y * fac);
  }
  if (tid == 0) {
    status[0] = k_fin;
    status[1] = (bad && kmax < n) ? 1 : 0;
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
