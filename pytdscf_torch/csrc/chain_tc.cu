// The four-tensor chain as staged tensor-core GEMMs: the relaxed-Krylov
// H_eff matvec (one bf16 pass) and the bf16x3 chain (environment transfer
// and "high" Krylov matvec).
//
// Replaces two kernels of the JAX package:
//   * mps/pallas_matvec.py:heff_pallas (its pl.pallas_call at :175, Pallas
//     body _heff_kernel), whose plain version is kernels.heff_apply_lo;
//   * mps/pallas_renorm.py:_renorm3_pallas (its pl.pallas_call at :223,
//     Pallas body _renorm3_kernel), whose plain version is
//     kernels.chain3_plain.
// In H_eff roles both compute
//
//   T1[(x,k), (j,c)] = sum_r     psi[(k,j), r] * R[(x,c), r]      j < din
//   T2[(i,x), (a,k)] = sum_(j,c) W[(a,i), (j,c)] * T1[(x,k), (j,c)] i < dout
//   out[b, (i,x)]    = sum_(a,k) L[b, (a,k)] * T2[(i,x), (a,k)]
//
// (the environment transfers are the same chain with the roles permuted,
// cuda_renorm.py).  Rounding points, those of the plain versions:
//   * one pass (heff_lo): psi is rounded to bf16, T1 and T2 are rounded to
//     bf16 (nearest even) after float32 accumulation, every product of two
//     bf16 values is exact in float32, the output is complex64;
//   * bf16x3 (chain3): every operand carries hi = bf16(x) and lo = bf16(x -
//     hi) (nearest even; the wrapper splits L, W and R, a first small
//     kernel psi), T1 and T2 are accumulated in float32 and split by
//     truncation (cgemm::Planes<3>), every real product is xh*yh + xh*yl +
//     xl*yh, the output is complex64.
// Only the order of the float32 sums differs from the plain versions.
// K_eff in bf16x3 (din = dout = 1, W the identity over the MPO bond) is two
// GEMMs: the first, computed transposed, writes T1 straight into the layout
// the last one reads (T2 = T1, as keff_tc.cu does for the one-pass K_eff).
//
// What bounds it on the H100: arithmetic.  At the chi = 1024 bulk (B = K =
// X = Rd = 1024, d = 4, w = 8) the chain is two 34.4 G complex
// multiply-add stages and a 1.1 G one (the W mix): four bf16 products per
// complex product, 0.56 ms at the card's 989 TFLOP/s dense bf16 rate, and
// three times that at bf16x3.  Design: all three stages run on the tensor
// cores through cgemm_bf16.cuh (mma.sync m16n8k16, ldmatrix, a cp.async
// ring), each over the whole card and over its whole depth, with no split of
// the depth and no atomics, so a launch repeats its result bit for bit.
// T1 and T2 go through device memory: at the bulk they are 134 MB each as
// bf16 (re, im) planes (268 MB at bf16x3), more than the 50 MB L2; writing
// and reading both is about 0.16 ms (0.32 ms) at 3.35 TB/s, against the
// milliseconds of arithmetic.  Each epilogue scatters its tile straight
// into the layout the next GEMM reads, its depth contiguous and padded to a
// multiple of 8 (the padding is zero: the wrapper zeroes a padded scratch).
// Every shape is taken: rows past a tile's edge are staged as zeros.
//
// Layouts (P bf16 planes first, P = 2 (re, im) or 4 (re_hi, im_hi, re_lo,
// im_lo); DWp = ceil8(din wr), Kp = ceil8(K), Rp = ceil8(Rd)):
//   psi (K, din, Rd) complex64 | L (P, B, wl, Kp) | W (P, wl, dout, DWp)
//   R (P, X, wr, Rp) | psip (P, K din, Rp) scratch
//   t1 (P, X, K, DWp) scratch | t2 (P, dout, X, wl, Kp) scratch
//   out (B, dout, X) complex64.
// K_eff (W == NULL): psip (P, Kp, Rp) and t2 (P, X, wr, Kp); no t1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <initializer_list>

#include "cgemm_bf16.cuh"

namespace {

using cgemm::Operand;
using cgemm::Planes;

int pad8(int n) { return (n + 7) / 8 * 8; }

// GEMM 1 epilogue: C[(k,j), (x,c)] -> T1[(x,k), (j,c)], rows of dwp
template <int kPasses>
struct T1Scatter {
  Planes<kPasses> t1;
  int M, N;  // K din, X wr
  int din, wr, K, dwp;
  __device__ long at(int m, int n) const {
    const int k = m / din, j = m % din, x = n / wr, c = n % wr;
    return ((long)x * K + k) * dwp + j * wr + c;
  }
  __device__ void operator()(int m, int n, float r0, float i0, float r1,
                             float i1) const {
    if (m >= M || n >= N) return;
    const long off = at(m, n);
    if (n + 1 >= N) {
      t1.put(off, r0, i0);
    } else if ((n + 1) % wr != 0 && (off & 1) == 0) {  // same x: contiguous
      t1.put2(off, r0, i0, r1, i1);
    } else {
      t1.put(off, r0, i0);
      t1.put(at(m, n + 1), r1, i1);
    }
  }
};

// GEMM 2 epilogue: C[(a,i), (x,k)] -> T2[(i,x), (a,k)], rows of wl Kp
template <int kPasses>
struct T2Scatter {
  Planes<kPasses> t2;
  int M, N;  // wl dout, X K
  int dout, K, X, Kp;
  long depth;  // wl Kp
  __device__ long at(int m, int n) const {
    const int a = m / dout, i = m % dout, x = n / K, k = n % K;
    return ((long)i * X + x) * depth + (long)a * Kp + k;
  }
  __device__ void operator()(int m, int n, float r0, float i0, float r1,
                             float i1) const {
    if (m >= M || n >= N) return;
    const long off = at(m, n);
    if (n + 1 >= N) {
      t2.put(off, r0, i0);
    } else if ((n + 1) % K != 0 && (off & 1) == 0) {  // same x: contiguous
      t2.put2(off, r0, i0, r1, i1);
    } else {
      t2.put(off, r0, i0);
      t2.put(at(m, n + 1), r1, i1);
    }
  }
};

// Tiles of each mode: (BM, BN, WM, WN, stages) of the two large GEMMs and
// of the W mix, whose M (wl dout, 32 at the bulk) is small.  Every GEMM
// flushes its accumulators once per chunk (cgemm_bf16.cuh, kFlush), which
// holds a second set of them in registers: warp tiles of 32 x 32 (one
// pass) and 32 x 16 (bf16x3, whose four planes double the fragments) keep
// both sets within 255 registers, and the ring within 227 KB of shared
// memory.
template <int kPasses>
struct Tiles;
template <>
struct Tiles<1> {
  template <class Epi>
  static cudaError_t big(const Operand& A, const Operand& B, int D, Epi e,
                         cudaStream_t st) {
    return cgemm::launch<128, 64, 4, 2, 1, 4, true>(A, B, D, e, st);
  }
  template <class Epi>
  static cudaError_t mix(const Operand& A, const Operand& B, int D, Epi e,
                         cudaStream_t st) {
    return cgemm::launch<32, 128, 2, 4, 1, 2, true>(A, B, D, e, st);
  }
};
template <>
struct Tiles<3> {
  template <class Epi>
  static cudaError_t big(const Operand& A, const Operand& B, int D, Epi e,
                         cudaStream_t st) {
    return cgemm::launch<64, 64, 2, 4, 3, 3, true>(A, B, D, e, st);
  }
  template <class Epi>
  static cudaError_t mix(const Operand& A, const Operand& B, int D, Epi e,
                         cudaStream_t st) {
    return cgemm::launch<32, 128, 2, 4, 3, 2, true>(A, B, D, e, st);
  }
};

#define RETURN_IF_ERROR(call)              \
  do {                                     \
    const cudaError_t e_ = (call);         \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

// H_eff roles: out (B, dout, X) = chain(psi (K, din, Rd)) (layouts above)
template <int kPasses>
int chain(const void* psi, const void* L, const void* W, const void* R,
          void* psip, void* t1, void* t2, void* out, int B, int K, int X,
          int Rd, int din, int dout, int wl, int wr, int* count,
          cudaStream_t st) {
  using T = __nv_bfloat16;
  const int Kp = pad8(K), Rp = pad8(Rd), dwp = pad8(din * wr);
  T* pp = static_cast<T*>(psip);
  T* t1p = static_cast<T*>(t1);
  T* t2p = static_cast<T*>(t2);
  RETURN_IF_ERROR(
      cgemm::launch_planes<kPasses>(psi, pp, K * din, K * din, Rd, Rp, count,
                                    st));

  // GEMM 1: T1 (M = K din, N = X wr, depth Rp)
  const Operand Pop{pp, (long)K * din * Rp, Rp, K * din};
  const Operand Rop{static_cast<const T*>(R), (long)X * wr * Rp, Rp, X * wr};
  const long n1 = (long)X * K * dwp;
  RETURN_IF_ERROR(Tiles<kPasses>::big(
      Pop, Rop, Rp,
      T1Scatter<kPasses>{{t1p, n1}, K * din, X * wr, din, wr, K, dwp}, st));

  // GEMM 2, the W mix: T2 (M = wl dout, N = X K, depth dwp)
  const long depth = (long)wl * Kp;
  const Operand Wop{static_cast<const T*>(W), (long)wl * dout * dwp, dwp,
                    wl * dout};
  const Operand T1op{t1p, n1, dwp, X * K};
  const long n2 = (long)dout * X * depth;
  RETURN_IF_ERROR(Tiles<kPasses>::mix(
      Wop, T1op, dwp,
      T2Scatter<kPasses>{{t2p, n2}, wl * dout, X * K, dout, K, X, Kp, depth},
      st));

  // GEMM 3: out (M = B, N = dout X, depth wl Kp)
  const Operand Lop{static_cast<const T*>(L), (long)B * depth, depth, B};
  const Operand T2op{t2p, n2, depth, dout * X};
  return (int)Tiles<kPasses>::big(
      Lop, T2op, (int)depth,
      cgemm::OutStore{static_cast<float2*>(out), B, dout * X}, st);
}

// K_eff at bf16x3: out (B, X) = sum L[b,a,k] R[x,a,r] sig[k,r] (w = wl = wr)
int keff3(const void* sig, const void* L, const void* R, void* sigp,
          void* t2, void* out, int B, int K, int X, int Rd, int w, int* count,
          cudaStream_t st) {
  using T = __nv_bfloat16;
  const int Kp = pad8(K), Rp = pad8(Rd);
  T* sp = static_cast<T*>(sigp);
  T* t2p = static_cast<T*>(t2);
  RETURN_IF_ERROR(
      cgemm::launch_planes<3>(sig, sp, K, Kp, Rd, Rp, count, st));

  // GEMM 1, transposed: T2[(x,a), k] = sum_r R[(x,a), r] sig[k, r]
  const long xw = (long)X * w;
  const Operand Rop{static_cast<const T*>(R), xw * Rp, Rp, (int)xw};
  const Operand Sop{sp, (long)Kp * Rp, Rp, Kp};
  RETURN_IF_ERROR(Tiles<3>::big(Rop, Sop, Rp,
                      cgemm::RowStore<3>{{t2p, xw * Kp}, (int)xw, Kp, Kp},
                      st));

  // GEMM 3: out[b, x] = sum_(a,k) L[b, (a,k)] T2[x, (a,k)]
  const long depth = (long)w * Kp;
  const Operand Lop{static_cast<const T*>(L), (long)B * depth, depth, B};
  const Operand Top{t2p, xw * Kp, depth, X};
  return (int)Tiles<3>::big(Lop, Top, (int)depth,
                            cgemm::OutStore{static_cast<float2*>(out), B, X},
                            st);
}

bool aligned(std::initializer_list<const void*> buffers) {
  for (const void* p : buffers)
    if (!cgemm::aligned16(p)) return false;
  return true;
}

}  // namespace

// One bf16 pass: out (B, dout, X) = chain(psi (K, din, Rd)) over
// L (2, B, wl, Kp), W (2, wl, dout, ceil8(din wr)), R (2, X, wr, Rp);
// scratch psip (2, K din, Rp), t1 (2, X, K, ceil8(din wr)), t2 (2, dout, X,
// wl, Kp), their padding zero: the relaxed H_eff matvec (din = dout = d) and
// the one-pass environment transfer (the roles of cuda_renorm.py).  count
// (or null): a device int32 that the launch adds one to.
// cudaErrorInvalidValue if a size is below 1 or a bf16 buffer is not
// 16-byte aligned.
extern "C" int pytdscf_heff_tc_c64(int device, const void* psi, const void* L,
                                   const void* W, const void* R, void* psip,
                                   void* t1, void* t2, void* out, int B,
                                   int K, int X, int Rd, int din, int dout,
                                   int wl, int wr, void* count,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || K < 1 || X < 1 || Rd < 1 || din < 1 || dout < 1 || wl < 1 ||
      wr < 1 || !aligned({L, W, R, psip, t1, t2}))
    return (int)cudaErrorInvalidValue;
  return chain<1>(psi, L, W, R, psip, t1, t2, out, B, K, X, Rd, din, dout, wl,
                  wr, static_cast<int*>(count),
                  static_cast<cudaStream_t>(stream));
}

// bf16x3 chain: out (B, dout, X) = chain(psi (K, din, Rd)) over the
// four-plane L, W, R (layouts above), or with W == NULL (and t1 unused)
// the K_eff form, din = dout = 1 and wl = wr.  cudaErrorInvalidValue if a
// size is below 1, the K_eff form gets other widths, or a bf16 buffer is
// not 16-byte aligned.  count (or null): a device int32 that the launch adds
// one to.
extern "C" int pytdscf_chain3_c64(int device, const void* psi, const void* L,
                                  const void* W, const void* R, void* psip,
                                  void* t1, void* t2, void* out, int B, int K,
                                  int X, int Rd, int din, int dout, int wl,
                                  int wr, void* count, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || K < 1 || X < 1 || Rd < 1 || din < 1 || dout < 1 || wl < 1 ||
      wr < 1 || !aligned({L, R, psip, t2}))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* n = static_cast<int*>(count);
  if (W == nullptr) {
    if (din != 1 || dout != 1 || wl != wr) return (int)cudaErrorInvalidValue;
    return keff3(psi, L, R, psip, t2, out, B, K, X, Rd, wr, n, st);
  }
  if (!aligned({W, t1})) return (int)cudaErrorInvalidValue;
  return chain<3>(psi, L, W, R, psip, t1, t2, out, B, K, X, Rd, din, dout, wl,
                  wr, n, st);
}
