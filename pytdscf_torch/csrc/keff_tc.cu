// Relaxed-Krylov K_eff matvec: two bf16 tensor-core GEMMs with T1 in
// device memory.
//
// Replaces the JAX package's mps/pallas_matvec.py:keff_pallas (its
// pl.pallas_call at :244, Pallas body _keff_kernel).  What it computes, with
// the rounding points of its plain version kernels.keff_apply_lo:
//
//   stage 1:  T1[k, x, a] = bf16( sum_r bf16(sig)[k, r] * R[x, a, r] )
//   stage 2:  out[b, x]   =       sum_(a,k) L[b, a, k] * T1[k, x, a]
//
// sig is rounded to bf16 (round to nearest even), every product of two bf16
// values is exact in float32, every sum is accumulated in float32 (by the
// tensor cores, cgemm_bf16.cuh), T1 is rounded to bf16 once, the output is
// stored as complex64.  Only the order of the float32 sums differs from the
// plain version.
//
// What bounds it on the H100: arithmetic.  At the chi = 1024 bulk (B = K =
// X = Rd = 1024, w = 8) each stage is 8.6 G complex multiply-adds, four
// bf16 products each: 137.4 GFLOP of bf16 products, 0.139 ms at the card's
// 989 TFLOP/s dense bf16 rate; its 84 MB of operands and output take
// 0.025 ms at 3.35 TB/s.  Design: both stages run on the tensor cores
// (mma.sync, cgemm_bf16.cuh), each over the whole card:
//   * stage 1 is computed transposed, T1t[(x,a), k] = sum_r R[(x,a), r]
//     sig[k, r] (M = X w, N = K, depth Rd; 128 x 128 tiles, 512 of them at
//     the bulk), so that its epilogue writes T1 with (a, k) contiguous for
//     each x: exactly the layout stage 2 reads as its B operand;
//   * stage 2 is out[b, x] = sum_(a,k) L[b, (a,k)] T1t[x, (a,k)] (M = B,
//     N = X, depth w K; 128 x 64 tiles, 128 at the bulk, one per SM), with
//     no split of the depth, so a launch repeats its result bit for bit.
// T1 leaves the SM: the Pallas kernel kept it in VMEM, but on this card it
// is 32 MB at the bulk (K X w bf16 pairs), which fits the 50 MB L2 and costs
// about 20 microseconds to write and read back against milliseconds of
// arithmetic; keeping it on chip would tie the two GEMMs to one tiling.
// A first small kernel rounds sig into bf16 planes (cgemm::planes_kernel).
//
// Layouts (bf16 planes (re, im) first; the depth axes k and r zero-padded
// to Kp = ceil8(K) and Rp = ceil8(Rd), as cuda_matvec.keff_operands builds
// them, so that every row is 16-byte aligned):
//   sig (K, Rd) complex64 | L (2, B, w, Kp) | R (2, X, w, Rp)
//   sigp (2, Kp, Rp) scratch | t1 (2, X, w, Kp) scratch | out (B, X) complex64

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cgemm_bf16.cuh"

// out (B, X) = K_eff chain of sig (K, Rd) over L (2, B, w, Kp) and
// R (2, X, w, Rp) (layouts above); sigp and t1 are scratch of 2 Kp Rp and
// 2 X w Kp bf16; count (or null) a device int32 that the launch adds one
// to.  cudaErrorInvalidValue if a size is below 1 or a bf16 buffer is not
// 16-byte aligned.
extern "C" int pytdscf_keff_tc_c64(int device, const void* sig, const void* L,
                                   const void* R, void* sigp, void* t1,
                                   void* out, int B, int K, int X, int Rd,
                                   int w, void* count, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || K < 1 || X < 1 || Rd < 1 || w < 1 || !cgemm::aligned16(L) ||
      !cgemm::aligned16(R) || !cgemm::aligned16(sigp) ||
      !cgemm::aligned16(t1))
    return (int)cudaErrorInvalidValue;
  const int Kp = (K + 7) / 8 * 8, Rp = (Rd + 7) / 8 * 8;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* sp = static_cast<__nv_bfloat16*>(sigp);
  __nv_bfloat16* tp = static_cast<__nv_bfloat16*>(t1);
  err = cgemm::launch_planes<1>(sig, sp, K, Kp, Rd, Rp,
                                static_cast<int*>(count), st);
  if (err != cudaSuccess) return (int)err;

  // stage 1: T1t (X w, Kp) = R (X w, Rp) . sigp (Kp, Rp)^T
  const long xw = (long)X * w;
  const cgemm::Operand Rop{static_cast<const __nv_bfloat16*>(R), xw * Rp, Rp,
                           (int)xw};
  const cgemm::Operand Sop{sp, (long)Kp * Rp, Rp, Kp};
  err = cgemm::launch<128, 128, 2, 4>(
      Rop, Sop, Rp, cgemm::RowStore<1>{{tp, xw * Kp}, (int)xw, Kp, Kp}, st);
  if (err != cudaSuccess) return (int)err;

  // stage 2: out (B, X) = L (B, w Kp) . T1t (X, w Kp)^T
  const long depth = (long)w * Kp;
  const cgemm::Operand Lop{static_cast<const __nv_bfloat16*>(L),
                           (long)B * depth, depth, B};
  const cgemm::Operand Top{tp, xw * Kp, depth, X};
  return (int)cgemm::launch<128, 64, 4, 2>(
      Lop, Top, (int)depth, cgemm::OutStore{static_cast<float2*>(out), B, X},
      st);
}
