// Complex GEMM on the tensor cores over bf16 planes, float32 accumulation:
// the core of the relaxed-matvec kernels (keff_tc.cu).
//
//   C[m, n] = sum_d A[m, d] * B[n, d]      m < M, n < N, d < D (complex)
//
// A and B arrive as two bf16 planes each, re then im: element (m, d) of
// plane p of A at A.p + p * A.plane + m * A.ld + d, and B alike, one row per
// output column n with the depth contiguous (the "col" operand of mma).
// D, the leading dimensions, the plane strides and the base addresses are
// multiples of 8 elements, so that every row of a tile is staged as 16-byte
// cp.async copies; rows past M or N and depth past D are staged as zeros.
//
// The complex product is four real products of the planes, each exact in
// float32, accumulated in float32 by mma.sync m16n8k16 bf16:
//   re += Ar * Br + Ai * (-Bi),   im += Ar * Bi + Ai * Br
// (negating a bf16 value is exact).  No 3M (Gauss) trick: it sums bf16
// values before the product, which is not exact in bf16 and would move the
// rounding points away from the plain version's.
//
// A block computes one BM x BN tile of C over the whole depth, with no
// split of the depth and no atomics, so the sums run in one fixed order and
// a launch repeats its result bit for bit.  The depth streams through a
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
constexpr int kStages = 4;              // chunks in flight
constexpr uint32_t kNeg = 0x80008000u;  // flips the sign of both bf16

// One operand: two bf16 planes (re, im) of `rows` rows of depth D.
struct Operand {
  const __nv_bfloat16* p;  // plane 0 (re); plane 1 at p + plane
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

// Shared memory of one block: kStages chunks of both planes of the A and
// B tiles.
template <int BM, int BN>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)kStages * 2 * (BM + BN) * kRow;
}

// Stages depth chunk [d0, d0 + kBK) of the `rows` x kBK tile of both planes
// of `op` from row r0 into `dst` ([2][rows][kRow]); kThreads threads.
template <int kRows, int kThreads>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                           const Operand& op, int r0, int d0,
                                           int D) {
  constexpr int kChunks = 2 * kRows * (kBK / 8);  // 16-byte copies
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

template <int BM, int BN, int WM, int WN, class Epi>
__global__ void __launch_bounds__(WM * WN * 32)
cgemm_kernel(Operand A, Operand B, int D, Epi epi) {
  constexpr int kThreads = WM * WN * 32;
  constexpr int kMI = BM / WM / 16;  // 16-row mma tiles per warp
  constexpr int kNI = BN / WN / 8;   // 8-column mma tiles per warp
  static_assert(kMI >= 1 && kNI >= 2 && kNI % 2 == 0, "warp tile");
  constexpr int kTileA = 2 * BM * kRow, kTileB = 2 * BN * kRow;
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
      stage_tile<BM, kThreads>(sA + s * kTileA, A, m0, s * kBK, D);
      stage_tile<BN, kThreads>(sB + s * kTileB, B, n0, s * kBK, D);
    }
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kStages - 2>();  // chunk t has landed (this thread's part)
    __syncthreads();               // ... everyone's, and slot t - 1 is free
    const int tn = t + kStages - 1;
    if (tn < nk) {
      stage_tile<BM, kThreads>(sA + (tn % kStages) * kTileA, A, m0, tn * kBK,
                               D);
      stage_tile<BN, kThreads>(sB + (tn % kStages) * kTileB, B, n0, tn * kBK,
                               D);
    }
    cp_async_commit();
    const __nv_bfloat16* a_s = sA + (t % kStages) * kTileA;
    const __nv_bfloat16* b_s = sB + (t % kStages) * kTileB;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[kMI][2][4], b[kNI][2][2];
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          ldmatrix_x4(a[i][p], a_s + (p * BM + wm0 + i * 16 + (lane & 15)) *
                                         kRow + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < kNI; j += 2)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
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
        for (int j = 0; j < kNI; ++j) {
          mma(re[i][j], a[i][0], b[j][0][0], b[j][0][1]);
          mma(re[i][j], a[i][1], b[j][1][0] ^ kNeg, b[j][1][1] ^ kNeg);
          mma(im[i][j], a[i][0], b[j][1][0], b[j][1][1]);
          mma(im[i][j], a[i][1], b[j][0][0], b[j][0][1]);
        }
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

// Launches cgemm_kernel<BM, BN, WM, WN> over the (M = A.rows, N = B.rows)
// output: one block per tile, N tiles along x.
template <int BM, int BN, int WM, int WN, class Epi>
cudaError_t launch(const Operand& A, const Operand& B, int D, Epi epi,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<BM, BN>();
  auto kernel = cgemm_kernel<BM, BN, WM, WN, Epi>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B.rows + BN - 1) / BN, (A.rows + BM - 1) / BM);
  kernel<<<grid, WM * WN * 32, smem, stream>>>(A, B, D, epi);
  return cudaGetLastError();
}

}  // namespace cgemm
}  // namespace
