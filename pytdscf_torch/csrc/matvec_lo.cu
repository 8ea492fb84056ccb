// Relaxed-Krylov matvec: the single-bf16-pass H_eff chain.
//
// Replaces the JAX package's mps/pallas_matvec.py:heff_pallas (its
// pl.pallas_call at :175, Pallas body _heff_kernel).  What it computes:
//
//   T1[k,j,x,c] = bf16( sum_r   psi[k,j,r] * R[x,c,r] )
//   T2[k,i,a,x] = bf16( sum_j,c W[a,i,j,c] * T1[k,j,x,c] )
//   out[b,i,x]  =       sum_a,k L[b,a,k] * T2[k,i,a,x]
//
// (The K_eff chain, the same with d = 1 and no W, is keff_tc.cu.)
// L, W, R arrive as bf16 (re, im) pairs (the per-site operands of
// cuda_matvec.py), psi as complex64 and is rounded to bf16 on load
// (round to nearest even); every product of two bf16 values is exact in
// float32 and every sum is accumulated in float32, so the kernel rounds at
// exactly the points of kernels.heff_apply_lo, its plain version.  Only the
// order of the float32 sums differs.
//
// What bounds it on the H100: arithmetic.  A bulk chi=1024 H_eff matvec
// (d = 4, w = 8) is 2 x 34 G complex multiply-adds; the two chain
// intermediates T1 and T2 are 256 MB each as complex64, and keeping them
// out of device memory is what the TPU kernel was for.  Design: a block
// owns one (Tk x Tx) tile of the contraction indices (k, x), computes its
// T1 tile (a 128 x 128 x 2r complex product, float32 FMA from shared
// memory) and its T2 tile into shared memory as bf16, then streams all of
// L through shared memory and stores its partial out[:, :, x-tile] of its
// k tile into a scratch slot.  T1 and T2 never leave the SM.  The Pallas
// kernel kept the output tile resident across an ordered k grid; blocks
// here run in no order, so a second kernel sums the k-tile slots in a
// fixed order (32 slots, 1 GB of scratch at the bulk: about 2 GB of
// traffic, a few percent of the matvec).  Float32 atomics would be cheaper
// but change the order of the sums from run to run, and the relaxed Krylov
// trajectory amplifies that into run-to-run differences of the
// observables; the fixed order makes the result repeatable.
// Tiles (chosen by the wrapper, checked here): Tk rows of k with
// Tk * d <= 128 and Tx columns of x with Tx * max(w_l, w_r) <= 128, so T1
// and T2 hold at most 128 x 128 complex bf16 (64 KB each).  Every shape
// the chain produces is taken; ragged tiles are masked.  Tensor cores
// (cgemm_bf16.cuh, as keff_tc.cu uses them) are later work.
//
// Layouts (row-major, complex as interleaved (re, im)):
//   psi (K, d, Rd) complex64 | L (B, wl, K) bf16x2 | W (wl, d, d, wr) bf16x2
//   R (X, wr, Rd) bf16x2     | part (ceil(K / Tk), B, d, X) complex64 scratch
//   out (B, d, X) complex64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTile = 128;         // rows (k,j) and columns (x,c) of a T1 tile
constexpr int kRC = 16;            // r values per staged chunk of psi and R
constexpr int kStage = kTile + 1;  // padded row of the staged chunks
constexpr int kMaxDW = 32;         // d * w_r: one T1 column in registers
constexpr int kStageL = 4096;      // (a,k) x b entries of a staged L chunk
// the staged chunks of phase 1 (psi and R) and of phase 3 (L, with one
// padding column per row) share one region
constexpr int kStageLen = 2 * kRC * kStage > kStageL + 32
                              ? 2 * kRC * kStage : kStageL + 32;

static_assert(kThreads == 32 * 16, "phase-1 thread grid is 32 x 16");

__device__ __forceinline__ float bf_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float2 ld_bf2(const __nv_bfloat162* p) {
  return __bfloat1622float2(*p);
}

__device__ __forceinline__ __nv_bfloat162 to_bf2(float2 v) {
  return __floats2bfloat162_rn(v.x, v.y);
}

// acc += a * b (complex); the two products of each part are exact for bf16
// operands, and each FMA rounds once in float32.
__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

size_t smem_bytes(int d, int wl, int wr) {
  const size_t w = sizeof(float2) * (size_t)wl * d * d * wr;
  return w + sizeof(float2) * kStageLen +
         2 * sizeof(__nv_bfloat162) * (size_t)kTile * kTile;
}

__global__ void __launch_bounds__(kThreads, 1)
matvec_lo_kernel(const float2* __restrict__ psi,
                 const __nv_bfloat162* __restrict__ L,
                 const __nv_bfloat162* __restrict__ W,
                 const __nv_bfloat162* __restrict__ R,
                 float2* __restrict__ part, int B, int K, int X, int Rd,
                 int d, int wl, int wr, int Tk, int Tx) {
  extern __shared__ float4 smem_raw[];
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * Tx;
  const int k0 = blockIdx.y * Tk;
  const int M1 = Tk * d;   // T1 rows (k, j)
  const int N1 = Tx * wr;  // T1 columns (x, c)
  const int K3 = wl * Tk;  // T2 rows (a, k)
  const int N3 = d * Tx;   // T2 columns (i, x)
  const int nW = wl * d * d * wr;

  float2* Ws = reinterpret_cast<float2*>(smem_raw);
  float2* stage = Ws + nW;
  float2* Ps = stage;                // [kRC][kStage]  psi chunk
  float2* Rs = stage + kRC * kStage; // [kRC][kStage]  R chunk
  float2* Ls = stage;                // L chunk (phase 3)
  __nv_bfloat162* T1s = reinterpret_cast<__nv_bfloat162*>(stage + kStageLen);
  __nv_bfloat162* T2s = T1s + kTile * kTile;

  for (int e = tid; e < nW; e += kThreads) Ws[e] = ld_bf2(&W[e]);

  // ---- phase 1: T1 = psi . R over r (float32 FMA), rounded to bf16.
  // Thread (tr, tc) owns rows tr + 32 i and columns tc + 16 j, so that a
  // half-warp reads 16 consecutive staged entries.
  const int tr = tid / 16, tc = tid % 16;
  float2 acc1[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc1[i][j] = make_float2(0.f, 0.f);
  const long rows_psi = (long)K * d;
  const long rows_R = (long)X * wr;
  for (int r0 = 0; r0 < Rd; r0 += kRC) {
    __syncthreads();  // the previous chunk has been consumed
    for (int e = tid; e < kTile * kRC; e += kThreads) {
      const int m = e / kRC, rr = e % kRC, r = r0 + rr;
      float2 v = make_float2(0.f, 0.f);
      const long gp = (long)k0 * d + m;
      if (m < M1 && gp < rows_psi && r < Rd) {
        const float2 p = psi[gp * Rd + r];
        v = make_float2(bf_round(p.x), bf_round(p.y));
      }
      Ps[rr * kStage + m] = v;
      float2 u = make_float2(0.f, 0.f);
      const long gr = (long)x0 * wr + m;
      if (m < N1 && gr < rows_R && r < Rd) u = ld_bf2(&R[gr * Rd + r]);
      Rs[rr * kStage + m] = u;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < kRC; ++rr) {
      float2 a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Ps[rr * kStage + tr + 32 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Rs[rr * kStage + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) cmac(acc1[i][j], a[i], b[j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = tr + 32 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = tc + 16 * j;
      if (m < M1 && n < N1) T1s[m * N1 + n] = to_bf2(acc1[i][j]);
    }
  }
  __syncthreads();

  // ---- phase 2: T2[(a,k)][(i,x)] from T1[(k,j)][(x,c)]
  {
    const int dw = d * wr;
    for (int col = tid; col < Tk * Tx; col += kThreads) {
      const int k = col / Tx, x = col % Tx;
      float2 t[kMaxDW];
#pragma unroll
      for (int q = 0; q < kMaxDW; ++q) {
        t[q] = make_float2(0.f, 0.f);
        if (q < dw) {
          const int j = q / wr, c = q % wr;
          t[q] = __bfloat1622float2(T1s[(k * d + j) * N1 + x * wr + c]);
        }
      }
      for (int ai = 0; ai < wl * d; ++ai) {
        const float2* wrow = Ws + ai * dw;
        float2 acc = make_float2(0.f, 0.f);
#pragma unroll
        for (int q = 0; q < kMaxDW; ++q)
          if (q < dw) cmac(acc, wrow[q], t[q]);
        const int a = ai / d, i = ai % d;
        T2s[(a * Tk + k) * N3 + i * Tx + x] = to_bf2(acc);
      }
    }
  }

  // ---- phase 3: part[k tile][b, (i,x)] = sum_(a,k) L[b,a,k] T2[(a,k)][(i,x)]
  // Thread tile: 4 rows of b x 4 columns (i,x), over nG column groups and
  // kThreads / nG row groups; a narrow T2 (N3 <= 16) takes nG = 4 so that
  // no thread computes empty columns.
  const int nG = N3 <= 16 ? 4 : 16;
  const int bG = kThreads / nG;
  const int bchunk = 4 * bG;
  const int kc = kStageL / bchunk;  // (a,k) rows per staged L chunk
  const int ls = bchunk + 1;        // padded row of the staged L chunk
  const int tb = tid / nG, tn = tid % nG;
  for (int n0 = 0; n0 < N3; n0 += 4 * nG) {
    for (int b0 = 0; b0 < B; b0 += bchunk) {
      float2 acc3[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc3[i][j] = make_float2(0.f, 0.f);
      for (int kk0 = 0; kk0 < K3; kk0 += kc) {
        __syncthreads();  // T2 is complete / the previous L chunk consumed
        for (int e = tid; e < kc * bchunk; e += kThreads) {
          const int bb = e / kc, kk = e % kc;
          const int kidx = kk0 + kk;
          const int a = kidx / Tk, kg = k0 + kidx % Tk, b = b0 + bb;
          float2 v = make_float2(0.f, 0.f);
          if (kidx < K3 && b < B && kg < K)
            v = ld_bf2(&L[((long)b * wl + a) * K + kg]);
          Ls[kk * ls + bb] = v;
        }
        __syncthreads();
        const int kn = min(kc, K3 - kk0);
        for (int kk = 0; kk < kn; ++kk) {
          float2 l[4], t[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) l[i] = Ls[kk * ls + tb + bG * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = n0 + tn + nG * j;
            t[j] = n < N3 ? __bfloat1622float2(T2s[(kk0 + kk) * N3 + n])
                          : make_float2(0.f, 0.f);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) cmac(acc3[i][j], l[i], t[j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int b = b0 + tb + bG * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + tn + nG * j;
          if (b >= B || n >= N3) continue;
          const int ii = n / Tx, xg = x0 + n % Tx;
          if (xg >= X) continue;
          // this block is the only writer of its k tile's slot entry
          part[(size_t)blockIdx.y * B * d * X + ((size_t)b * d + ii) * X + xg] =
              acc3[i][j];
        }
      }
    }
  }
}

// out[e] = sum over the k-tile slots of part[t][e], always in slot order
__global__ void sum_ktiles_kernel(const float2* __restrict__ part,
                                  float2* __restrict__ out, size_t n,
                                  int nkt) {
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    float2 acc = part[e];
    for (int t = 1; t < nkt; ++t) {
      const float2 v = part[(size_t)t * n + e];
      acc.x += v.x;
      acc.y += v.y;
    }
    out[e] = acc;
  }
}

int launch(const void* psi, const void* L, const void* W, const void* R,
           void* part, void* out, int B, int K, int X, int Rd, int d, int wl,
           int wr, int Tk, int Tx, void* stream) {
  const int wmax = wl > wr ? wl : wr;
  if (Tk < 1 || Tx < 1 || Tk * d > kTile || Tx * wmax > kTile ||
      d * wr > kMaxDW)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d, wl, wr);
  cudaError_t err = cudaFuncSetAttribute(
      matvec_lo_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nkt = (K + Tk - 1) / Tk;
  const dim3 grid((X + Tx - 1) / Tx, nkt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  matvec_lo_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float2*>(psi),
      static_cast<const __nv_bfloat162*>(L),
      static_cast<const __nv_bfloat162*>(W),
      static_cast<const __nv_bfloat162*>(R), static_cast<float2*>(part), B, K,
      X, Rd, d, wl, wr, Tk, Tx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)B * d * X;
  const int threads = 256;
  const size_t blocks = (n + threads - 1) / threads;
  sum_ktiles_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), threads, 0,
                      st>>>(static_cast<const float2*>(part),
                            static_cast<float2*>(out), n, nkt);
  return (int)cudaGetLastError();
}

}  // namespace

// H_eff: out (B, d, X) = chain(psi (K, d, Rd)); part holds ceil(K / Tk)
// slots of (B, d, X).  Requires d * wr <= 32, Tk * d <= 128 and
// Tx * max(wl, wr) <= 128 (cudaErrorInvalidValue otherwise).
extern "C" int pytdscf_heff_lo_c64(int device, const void* psi, const void* L,
                                   const void* W, const void* R, void* part,
                                   void* out, int B, int K, int X, int Rd,
                                   int d, int wl, int wr, int Tk, int Tx,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch(psi, L, W, R, part, out, B, K, X, Rd, d, wl, wr, Tk, Tx,
                stream);
}
