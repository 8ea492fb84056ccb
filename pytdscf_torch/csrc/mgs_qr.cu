// Thin QR by modified Gram–Schmidt with two passes per column (MGS×2).
//
// Replaces the JAX package's mps/pallas_qr.py:mgs_qr_fused.  Semantics are those
// of its mps/kernels.py:_mgs_qr, line by line:
//   scale = ||m||_F + 1e-30; for each column k: two Gram–Schmidt passes
//   against Q[:, :k] (coefficients c1, c2), R[:k, k] = c1 + c2,
//   nv = ||v||; a column with nv < 1e-7 * scale is dead: Q[:, k] is the
//   canonical vector e_{k mod N} orthogonalised twice, R[k, k] = 0;
//   otherwise Q[:, k] = v / nv and R[k, k] = nv.
//
// Bound on the H100: the serial chain of r columns, each a handful of
// block-wide reductions; the data (a (240, 30) complex64 factor is 58 KB)
// and the arithmetic are small.  Design: one block of 256 threads keeps Q
// in dynamic shared memory, column-major (Q[j * N + n]), so that the dot
// products <Q_j|v> (one warp per column j, lanes over n) and the update
// v -= Q c (threads over n) both read consecutive banks.  A Q too large for
// shared memory (the large-bond chain's (1024, 64) edge gauge) lives in a
// device-memory scratch the wrapper passes, with the same layout; it then
// sits in L2.
//
// The factorisation is tdvp_device.cuh's mgs_factor (site_step.cu runs the
// same one inside its fused site update).
//
// Layout: m (N, r) complex64 row-major (torch's contiguous layout, float2
// interleaved), Q (N, r) row-major, R (r, r) row-major.  N >= r >= 1.

#include <cuda_runtime.h>

#include "tdvp_device.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
mgs_qr_kernel(const float2* __restrict__ m, float2* __restrict__ q_out,
              float2* __restrict__ r_out, float2* qwork, int N, int r) {
  extern __shared__ float2 smem[];
  // (r, N): column j at Q + j * N; in shared memory unless qwork is given
  float2* Q = qwork != nullptr ? qwork : smem;
  float2* v = qwork != nullptr ? smem : Q + (size_t)N * r;  // (N) current column
  float2* e = v + N;           // (N) completion vector
  float2* c1 = e + N;          // (r) first-pass coefficients
  float2* c2 = c1 + r;         // (r) second-pass coefficients
  float2* c3 = c2 + r;         // (r) coefficients of the completion passes
  __shared__ float red[kWarps];

  mgs_factor<kThreads>(m, Q, r_out, N, r, v, e, c1, c2, c3, red);
  for (int i = threadIdx.x; i < N * r; i += kThreads) {
    const int n = i / r, j = i - n * r;
    q_out[i] = Q[(size_t)j * N + n];
  }
}

}  // namespace

// qwork: nullptr (Q in shared memory) or an (r, N) complex64 scratch.
extern "C" int pytdscf_mgs_qr_c64(int device, const void* m, void* q,
                                  void* r_out, void* qwork, int N, int r,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t q_smem = qwork != nullptr ? 0 : (size_t)N * r;
  const size_t smem = sizeof(float2) * (q_smem + 2 * (size_t)N + 3 * (size_t)r);
  err = cudaFuncSetAttribute(mgs_qr_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  mgs_qr_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(m), static_cast<float2*>(q),
      static_cast<float2*>(r_out), static_cast<float2*>(qwork), N, r);
  return (int)cudaGetLastError();
}

// Message of a CUDA error code returned by any entry point of this library.
extern "C" const char* pytdscf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
