// Complex GEMM on the tensor cores over bf16 planes, float32 accumulation:
// the core of the relaxed-matvec and bf16x3 chain kernels (keff_tc.cu,
// chain_tc.cu).
//
//   C[m, n] = sum_d A[m, d] * B[n, d]      m < M, n < N, d < D (complex)
//
// A and B arrive as bf16 planes: element (m, d) of plane p of A at
// A.p + p * A.plane + m * A.ld + d, and B alike, one row per output column
// n with the depth contiguous (the "col" operand of mma).  D, the leading
// dimensions, the plane strides and the base addresses are multiples of 8
// elements, so that every row of a tile is staged as 16-byte cp.async
// copies; rows past M or N and depth past D are staged as zeros.
//
// Two modes, by the template parameter kPasses:
//   * kPasses = 1: two planes (re, im).  The complex product is four real
//     products of the planes, each exact in float32, accumulated in
//     float32 by mma.sync m16n8k16 bf16:
//       re += Ar * Br + Ai * (-Bi),   im += Ar * Bi + Ai * Br
//     (negating a bf16 value is exact).
//   * kPasses = 3 (bf16x3): four planes (re_hi, im_hi, re_lo, im_lo), each
//     value x carried as hi + lo.  Every real product x*y is the three bf16
//     products xh*yh + xh*yl + xl*yh (lo*lo dropped), so a complex product
//     is twelve mma.
// No 3M (Gauss) trick: it sums bf16 values before the product, which is
// not exact in bf16 and would move the rounding points away from the plain
// versions'.
//
// A block computes one BM x BN tile of C over the whole depth, with no
// split of the depth and no atomics, so the sums run in one fixed order and
// a launch repeats its result bit for bit.  The tensor cores truncate as
// they accumulate (round toward zero), so a long depth run through one
// accumulator drifts by about 2^-24 of the running sum per mma: 4e-5 over
// the 8192-deep sums of the bf16x3 chain, twice its bar.  With kFlush each
// kBK-deep chunk accumulates into fresh registers and is then added to the
// running float32 sum (IEEE, round to nearest), which keeps the truncation
// to the dozen mma of one chunk.  The depth streams through a
// kStages-deep ring of kBK-deep chunks in shared memory (cp.async, one
// commit group per chunk); WM x WN warps each own a (BM / WM) x (BN / WN)
// warp tile of 16 x 8 mma tiles, fed by ldmatrix from rows padded to 80
// bytes (the eight rows an ldmatrix phase reads fall in distinct banks).
// The epilogue functor receives each pair of accumulators,
// epi(m, n, re(m, n), im(m, n), re(m, n + 1), im(m, n + 1)) for even n, and
// masks the ragged edge itself.
//
// Everything sits in an anonymous namespace: each kernel source that
// includes this header gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace cgemm {

constexpr int kBK = 32;                 // depth of one staged chunk
constexpr int kRow = kBK + 8;           // padded row of a staged chunk
constexpr uint32_t kNeg = 0x80008000u;  // flips the sign of both bf16

// bf16 planes of an operand in each mode
__host__ __device__ constexpr int planes(int passes) {
  return passes == 3 ? 4 : 2;
}

// One operand: bf16 planes of `rows` rows of depth D.
struct Operand {
  const __nv_bfloat16* p;  // plane 0 (re or re_hi); plane q at p + q * plane
  long plane;              // elements between the planes
  long ld;                 // elements between rows
  int rows;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (nothing read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a * b: one m16n8k16 bf16 product with float32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory of one block: kStages chunks of every plane of the A and
// B tiles.
template <int BM, int BN, int kPasses = 1, int kStages = 4>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)kStages * planes(kPasses) *
         (BM + BN) * kRow;
}

// Stages depth chunk [d0, d0 + kBK) of the `rows` x kBK tile of every
// plane of `op` from row r0 into `dst` ([planes][rows][kRow]); kThreads
// threads.
template <int kRows, int kThreads, int kPlanes = 2>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                           const Operand& op, int r0, int d0,
                                           int D) {
  constexpr int kChunks = kPlanes * kRows * (kBK / 8);  // 16-byte copies
  static_assert(kChunks % kThreads == 0, "whole copies per thread");
#pragma unroll
  for (int i = 0; i < kChunks / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int plane = c / (kRows * (kBK / 8));
    const int rem = c % (kRows * (kBK / 8));
    const int row = rem / (kBK / 8), d = d0 + 8 * (rem % (kBK / 8));
    const bool valid = r0 + row < op.rows && d < D;
    const __nv_bfloat16* src =
        valid ? op.p + plane * op.plane + (long)(r0 + row) * op.ld + d : op.p;
    cp_async16(dst + (plane * kRows + row) * kRow + (d - d0), src, valid);
  }
}

// re, im += A * B of one 16 x 8 x 16 step from the fragments of every
// plane: a[p] (16 x 16 of A), b[p] (16 x 8 of B).
template <int kPasses>
__device__ __forceinline__ void cmma(float (&re)[4], float (&im)[4],
                                     const uint32_t (&a)[planes(kPasses)][4],
                                     const uint32_t (&b)[planes(kPasses)][2]) {
  if constexpr (kPasses == 1) {
    mma(re, a[0], b[0][0], b[0][1]);
    mma(re, a[1], b[1][0] ^ kNeg, b[1][1] ^ kNeg);
    mma(im, a[0], b[1][0], b[1][1]);
    mma(im, a[1], b[0][0], b[0][1]);
  } else {
    // planes 0 re_hi, 1 im_hi, 2 re_lo, 3 im_lo
    // re: Are*Bre - Aim*Bim, three passes each
    mma(re, a[0], b[0][0], b[0][1]);
    mma(re, a[0], b[2][0], b[2][1]);
    mma(re, a[2], b[0][0], b[0][1]);
    mma(re, a[1], b[1][0] ^ kNeg, b[1][1] ^ kNeg);
    mma(re, a[1], b[3][0] ^ kNeg, b[3][1] ^ kNeg);
    mma(re, a[3], b[1][0] ^ kNeg, b[1][1] ^ kNeg);
    // im: Are*Bim + Aim*Bre
    mma(im, a[0], b[1][0], b[1][1]);
    mma(im, a[0], b[3][0], b[3][1]);
    mma(im, a[2], b[1][0], b[1][1]);
    mma(im, a[1], b[0][0], b[0][1]);
    mma(im, a[1], b[2][0], b[2][1]);
    mma(im, a[3], b[0][0], b[0][1]);
  }
}

template <int BM, int BN, int WM, int WN, int kPasses, int kStages,
          bool kFlush, class Epi>
__global__ void __launch_bounds__(WM * WN * 32)
cgemm_kernel(Operand A, Operand B, int D, Epi epi) {
  constexpr int kThreads = WM * WN * 32;
  constexpr int kP = planes(kPasses);
  constexpr int kMI = BM / WM / 16;  // 16-row mma tiles per warp
  constexpr int kNI = BN / WN / 8;   // 8-column mma tiles per warp
  static_assert(kMI >= 1 && kNI >= 2 && kNI % 2 == 0, "warp tile");
  static_assert(kStages >= 2, "a ring of at least two chunks");
  constexpr int kTileA = kP * BM * kRow, kTileB = kP * BN * kRow;
  extern __shared__ float4 smem_raw[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sB = sA + kStages * kTileA;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp / WN) * (BM / WM), wn0 = (warp % WN) * (BN / WN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (D + kBK - 1) / kBK;

  float re[kMI][kNI][4], im[kMI][kNI][4];
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNI; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) re[i][j][q] = im[i][j][q] = 0.f;

  // the ring: chunk t in slot t % kStages, one commit group per chunk
  // (empty past the last, so that the wait counts stay uniform)
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) {
      stage_tile<BM, kThreads, kP>(sA + s * kTileA, A, m0, s * kBK, D);
      stage_tile<BN, kThreads, kP>(sB + s * kTileB, B, n0, s * kBK, D);
    }
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kStages - 2>();  // chunk t has landed (this thread's part)
    __syncthreads();               // ... everyone's, and slot t - 1 is free
    const int tn = t + kStages - 1;
    if (tn < nk) {
      stage_tile<BM, kThreads, kP>(sA + (tn % kStages) * kTileA, A, m0,
                                   tn * kBK, D);
      stage_tile<BN, kThreads, kP>(sB + (tn % kStages) * kTileB, B, n0,
                                   tn * kBK, D);
    }
    cp_async_commit();
    const __nv_bfloat16* a_s = sA + (t % kStages) * kTileA;
    const __nv_bfloat16* b_s = sB + (t % kStages) * kTileB;
    // the chunk's products into (cr, ci)
    auto chunk = [&](float (&cr)[kMI][kNI][4], float (&ci)[kMI][kNI][4]) {
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        uint32_t a[kMI][kP][4], b[kNI][kP][2];
#pragma unroll
        for (int i = 0; i < kMI; ++i)
#pragma unroll
          for (int p = 0; p < kP; ++p)
            ldmatrix_x4(a[i][p], a_s + (p * BM + wm0 + i * 16 + (lane & 15)) *
                                           kRow + kk + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < kNI; j += 2)
#pragma unroll
          for (int p = 0; p < kP; ++p) {
            uint32_t f[4];
            ldmatrix_x4(f, b_s + (p * BN + wn0 + j * 8 + (lane & 7) +
                                  ((lane >> 4) << 3)) * kRow +
                               kk + ((lane >> 3) & 1) * 8);
            b[j][p][0] = f[0];
            b[j][p][1] = f[1];
            b[j + 1][p][0] = f[2];
            b[j + 1][p][1] = f[3];
          }
#pragma unroll
        for (int i = 0; i < kMI; ++i)
#pragma unroll
          for (int j = 0; j < kNI; ++j)
            cmma<kPasses>(cr[i][j], ci[i][j], a[i], b[j]);
      }
    };
    if constexpr (kFlush) {
      float pr[kMI][kNI][4], pi[kMI][kNI][4];
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int j = 0; j < kNI; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) pr[i][j][q] = pi[i][j][q] = 0.f;
      chunk(pr, pi);
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int j = 0; j < kNI; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            re[i][j][q] += pr[i][j][q];
            im[i][j][q] += pi[i][j][q];
          }
    } else {
      chunk(re, im);
    }
  }
  cp_async_wait<0>();

  const int g = lane / 4, t4 = lane % 4;  // accumulator coordinates
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNI; ++j) {
      const int m = m0 + wm0 + i * 16 + g, n = n0 + wn0 + j * 8 + 2 * t4;
      epi(m, n, re[i][j][0], im[i][j][0], re[i][j][1], im[i][j][1]);
      epi(m + 8, n, re[i][j][2], im[i][j][2], re[i][j][3], im[i][j][3]);
    }
}

// Launches cgemm_kernel over the (M = A.rows, N = B.rows) output: one block
// per tile, N tiles along x.
template <int BM, int BN, int WM, int WN, int kPasses = 1, int kStages = 4,
          bool kFlush = false, class Epi>
cudaError_t launch(const Operand& A, const Operand& B, int D, Epi epi,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<BM, BN, kPasses, kStages>();
  static_assert(smem <= 232448, "227 KB of shared memory per block");
  auto kernel = cgemm_kernel<BM, BN, WM, WN, kPasses, kStages, kFlush, Epi>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B.rows + BN - 1) / BN, (A.rows + BM - 1) / BM);
  kernel<<<grid, WM * WN * 32, smem, stream>>>(A, B, D, epi);
  return cudaGetLastError();
}

// out (P, rows_p, cols_p) = the bf16 planes of x (rows, cols) complex64,
// zero past rows and cols: P = 2 (re, im), rounded to nearest even, or
// P = 4 (re_hi, im_hi, re_lo, im_lo) with hi = bf16(x) and lo = bf16(x -
// hi), both rounded to nearest even (x - hi is exact in float32).
template <int kPasses>
__global__ void planes_kernel(const float2* __restrict__ x,
                              __nv_bfloat16* __restrict__ out, int rows,
                              int rows_p, int cols, int cols_p,
                              int* __restrict__ count) {
  const size_t n = (size_t)rows_p * cols_p;
  // one per launch of the chain this kernel opens (a launch count kept on
  // the device, so a CUDA graph's replays count what they ran)
  if (count != nullptr && blockIdx.x == 0 && threadIdx.x == 0) *count += 1;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int r = (int)(e / cols_p), c = (int)(e % cols_p);
    float2 v = make_float2(0.f, 0.f);
    if (r < rows && c < cols) v = x[(size_t)r * cols + c];
    const __nv_bfloat16 hr = __float2bfloat16_rn(v.x);
    const __nv_bfloat16 hi = __float2bfloat16_rn(v.y);
    out[e] = hr;
    out[n + e] = hi;
    if constexpr (kPasses == 3) {
      out[2 * n + e] = __float2bfloat16_rn(v.x - __bfloat162float(hr));
      out[3 * n + e] = __float2bfloat16_rn(v.y - __bfloat162float(hi));
    }
  }
}

template <int kPasses>
cudaError_t launch_planes(const void* x, __nv_bfloat16* out, int rows,
                          int rows_p, int cols, int cols_p, int* count,
                          cudaStream_t stream) {
  const size_t blocks = ((size_t)rows_p * cols_p + 255) / 256;
  planes_kernel<kPasses><<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                           stream>>>(static_cast<const float2*>(x), out,
                                     rows, rows_p, cols, cols_p, count);
  return cudaGetLastError();
}

// Epilogue stores.  Planes<kPasses> writes output entries into bf16 planes
// (plane q at p + q * plane): kPasses = 1 rounds (re, im) to nearest even;
// kPasses = 3 splits each float32 value x by truncation, hi = x with its
// low 16 bits cleared (a bf16 value) and lo = bf16(x - hi) rounded to
// nearest even, into (re_hi, im_hi, re_lo, im_lo).
template <int kPasses>
struct Planes {
  __nv_bfloat16* p;
  long plane;

  __device__ __forceinline__ static __nv_bfloat16 hi(float x) {
    return __ushort_as_bfloat16((unsigned short)(__float_as_uint(x) >> 16));
  }
  __device__ __forceinline__ static __nv_bfloat16 lo(float x) {
    const float h = __uint_as_float(__float_as_uint(x) & 0xffff0000u);
    return __float2bfloat16_rn(x - h);
  }
  // one entry at element offset off
  __device__ __forceinline__ void put(long off, float re, float im) const {
    if constexpr (kPasses == 1) {
      p[off] = __float2bfloat16_rn(re);
      p[plane + off] = __float2bfloat16_rn(im);
    } else {
      p[off] = hi(re);
      p[plane + off] = hi(im);
      p[2 * plane + off] = lo(re);
      p[3 * plane + off] = lo(im);
    }
  }
  // two consecutive entries at an even element offset off
  __device__ __forceinline__ void put2(long off, float r0, float i0, float r1,
                                       float i1) const {
    auto pair = [&](long q, __nv_bfloat16 a, __nv_bfloat16 b) {
      *reinterpret_cast<__nv_bfloat162*>(p + q * plane + off) =
          __halves2bfloat162(a, b);
    };
    if constexpr (kPasses == 1) {
      *reinterpret_cast<__nv_bfloat162*>(p + off) =
          __floats2bfloat162_rn(r0, r1);
      *reinterpret_cast<__nv_bfloat162*>(p + plane + off) =
          __floats2bfloat162_rn(i0, i1);
    } else {
      pair(0, hi(r0), hi(r1));
      pair(1, hi(i0), hi(i1));
      pair(2, lo(r0), lo(r1));
      pair(3, lo(i0), lo(i1));
    }
  }
};

// C[m, n] into planes, row-major with rows of ld elements (ld even)
template <int kPasses>
struct RowStore {
  Planes<kPasses> out;
  int M, N;
  long ld;
  __device__ void operator()(int m, int n, float r0, float i0, float r1,
                             float i1) const {
    if (m >= M || n >= N) return;
    const long off = (long)m * ld + n;
    if (n + 1 < N)  // n and ld even: a 4-byte aligned pair
      out.put2(off, r0, i0, r1, i1);
    else
      out.put(off, r0, i0);
  }
};

// C[m, n] as complex64, row-major (M, N)
struct OutStore {
  float2* out;
  int M, N;
  __device__ void operator()(int m, int n, float r0, float i0, float r1,
                             float i1) const {
    if (m >= M || n >= N) return;
    float2* p = out + (size_t)m * N + n;
    p[0] = make_float2(r0, i0);
    if (n + 1 < N) p[1] = make_float2(r1, i1);
  }
};

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace cgemm
}  // namespace
