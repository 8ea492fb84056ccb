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
// Layout: m (N, r) complex64 row-major (torch's contiguous layout, float2
// interleaved), Q (N, r) row-major, R (r, r) row-major.  N >= r >= 1.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kRankTol = 1.0e-7f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block, returned to every thread (all threads add the warp
// partials in the same order, so the result is identical in every thread).
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // red may still be read by a previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < kWarps; ++i) t += red[i];
  return t;
}

// One Gram–Schmidt pass of x (N, shared) against Q[:, :k] (shared,
// column-major): c[j] = <Q_j|x> for j < k, then x -= sum_j Q_j c[j].
__device__ void gs_pass(const float2* Q, float2* x, float2* c, int N, int k) {
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

__device__ float norm2(const float2* x, int N, float* red) {
  float s = 0.f;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    const float2 a = x[n];
    s += a.x * a.x + a.y * a.y;
  }
  return block_sum(s, red);
}

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
  const int tid = threadIdx.x;

  for (int i = tid; i < N * r; i += kThreads) Q[i] = make_float2(0.f, 0.f);
  for (int i = tid; i < r * r; i += kThreads) r_out[i] = make_float2(0.f, 0.f);
  float s = 0.f;
  for (int i = tid; i < N * r; i += kThreads) {
    const float2 a = m[i];
    s += a.x * a.x + a.y * a.y;
  }
  const float scale = sqrtf(block_sum(s, red)) + 1e-30f;

  for (int k = 0; k < r; ++k) {
    for (int n = tid; n < N; n += kThreads) v[n] = m[(size_t)n * r + k];
    __syncthreads();
    gs_pass(Q, v, c1, N, k);
    gs_pass(Q, v, c2, N, k);
    const float nv = sqrtf(norm2(v, N, red));
    const bool bad = nv < kRankTol * scale;  // uniform across the block
    float2* col = Q + (size_t)k * N;
    if (bad) {
      for (int n = tid; n < N; n += kThreads)
        e[n] = make_float2(n == k % N ? 1.f : 0.f, 0.f);
      __syncthreads();
      gs_pass(Q, e, c3, N, k);
      gs_pass(Q, e, c3, N, k);
      const float ne = sqrtf(norm2(e, N, red)) + 1e-30f;
      for (int n = tid; n < N; n += kThreads)
        col[n] = make_float2(e[n].x / ne, e[n].y / ne);
    } else {
      for (int n = tid; n < N; n += kThreads)
        col[n] = make_float2(v[n].x / nv, v[n].y / nv);
    }
    for (int j = tid; j < k; j += kThreads)
      r_out[(size_t)j * r + k] =
          make_float2(c1[j].x + c2[j].x, c1[j].y + c2[j].y);
    if (tid == 0) r_out[(size_t)k * r + k] = make_float2(bad ? 0.f : nv, 0.f);
    __syncthreads();
  }
  for (int i = tid; i < N * r; i += kThreads) {
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
