// The control step of the Krylov exponential (Arnoldi, and Lanczos over the
// einsums), and the CUDA-graph IF nodes that guard each Krylov iteration of a
// captured step.
//
// No Pallas kernel has a counterpart: the JAX package runs the same control
// as the body of an XLA while_loop (mps/integrator.py:_arnoldi_loop,
// _lanczos_loop), whose condition the device evaluates.  Here each Krylov
// iteration k of integrator._program ends with one launch of this kernel,
// which decides on the device whether iteration k + 1 runs:
//
//   A = scale T[:m, :m]                           m = k + 1
//   c = exp(A)[:, 0]                               order-12 Taylor, scaled
//   err = ||c - c_prev||         (Arnoldi: V is orthonormal)
//       = sqrt(Re (c - c_prev)^H G (c - c_prev))  (Lanczos: the oblique
//         recurrence's V is not orthogonal; G is its Gram matrix)
//   conv = k > 0 and err < thresh; breakdown = T[k+1, k] < 1e-14;
//   capped = m >= kmax; done = conv | breakdown | capped
//   flags[0] = !done (the next iteration's IF-node predicate),
//   flags[1 + k] = done (which gather body forms psi = c V),
//   status = [m, capped & !conv & !breakdown & !exact, relaxed matvecs]
//
// The exponential is integrator._expm_taylor_small's: s = ceil(log2 ||A||_1)
// + 3 squarings clamped to 0..64 (0 on a non-finite norm), A / 2^s, the
// reverse Horner p = I + A p / c for c = 12..1, then s squarings.  Only the
// order of the float32 sums differs from the plain version (torch's), and
// log2 near a power of two may take one squaring more or fewer: the result
// agrees at round-off, not bit for bit.
//
// What bounds it: latency.  m <= 64, so A, p and a product's output are at
// most 3 * 64 * 64 complex64 values (96 KB of shared memory); a call does
// 12 + s dense m x m products, at m = 8 about 5 k multiply-adds each, and a
// few reductions.  One block of 256 threads keeps everything in shared
// memory: one launch of a few microseconds replaces the ~30 small torch
// launches of the plain version and the host's read of its norm.
//
// IF nodes: torch 2.11 exposes no conditional node, so pytdscf_if_begin
// builds one in the graph that the caller's stream is capturing
// (cudaGraphConditionalHandleCreate, a one-thread kernel that sets the
// handle from a device bool at each replay, cudaGraphAddNode of an IF node)
// and starts capturing the IF node's body graph on a second stream
// (cudaStreamBeginCaptureToGraph); pytdscf_if_end ends the body's capture.
// Work queued on the second stream in between runs only when the bool was
// true when the replay reached the node.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 64;
constexpr int kOrder = 12;
constexpr float kEps = 1.0e-14f;

__device__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// out = a b for m x m row-major matrices in shared memory
__device__ void matmul(const float2* a, const float2* b, float2* out, int m) {
  for (int e = threadIdx.x; e < m * m; e += kThreads) {
    const int i = e / m, j = e - i * m;
    float re = 0.f, im = 0.f;
    for (int l = 0; l < m; ++l) {
      const float2 x = a[i * m + l], y = b[l * m + j];
      re += x.x * y.x - x.y * y.y;
      im += x.x * y.y + x.y * y.x;
    }
    out[e] = make_float2(re, im);
  }
  __syncthreads();
}

// Sum of v over the block (every thread gets it); red holds kThreads floats.
__device__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  const float s = red[0];
  __syncthreads();
  return s;
}

// T (kmax+1, kmax+1) and G (the same, or null) row-major complex64; c
// (kmax) complex64, the previous coefficients in, the new ones out; flags
// (kmax + 1) bool; status (3) int32; count (or null) an int32 that the
// launch adds one to.
__global__ void krylov_ctl_kernel(const float2* __restrict__ T,
                                  const float2* __restrict__ G,
                                  float2* __restrict__ c,
                                  unsigned char* __restrict__ flags,
                                  int* __restrict__ status,
                                  int* __restrict__ count, int k,
                                  int kmax, float sre, float sim,
                                  double thresh, int exact,
                                  int relax_after) {
  extern __shared__ float2 smem[];
  const int m = k + 1, ld = kmax + 1, tid = threadIdx.x;
  float2* A = smem;
  float2* P = A + m * m;
  float2* Q = P + m * m;
  float2* d = Q + m * m;  // kmax: c_new - c_prev
  float* red = reinterpret_cast<float*>(d + kmax);
  __shared__ int s_shift;

  // A = scale T[:m, :m]
  const float2 scale = make_float2(sre, sim);
  for (int e = tid; e < m * m; e += kThreads) {
    const int i = e / m, j = e - i * m;
    A[e] = cmul(scale, T[i * ld + j]);
  }
  __syncthreads();
  // ||A||_1: the largest column sum of |A_ij|
  float col = 0.f;
  if (tid < m)
    for (int i = 0; i < m; ++i) col += hypotf(A[i * m + tid].x, A[i * m + tid].y);
  red[tid] = tid < m ? col : 0.f;
  __syncthreads();
  if (tid == 0) {
    float norm1 = red[0];
    for (int j = 1; j < m; ++j) norm1 = fmaxf(norm1, red[j]);
    const double n1 = (double)norm1;
    int s = 0;
    if (isfinite(n1)) {
      const double raw = ceil(log2(fmax(n1, 1e-30))) + 3.0;
      s = (int)fmin(fmax(raw, 0.0), 64.0);
    }
    s_shift = s;
  }
  __syncthreads();
  const int s = s_shift;
  const float inv = ldexpf(1.f, -s);
  for (int e = tid; e < m * m; e += kThreads) {
    A[e].x *= inv;
    A[e].y *= inv;
    const int i = e / m, j = e - i * m;
    P[e] = make_float2(i == j ? 1.f : 0.f, 0.f);
  }
  __syncthreads();
  // reverse Horner: P <- I + A P / c for c = 12, 11, ..., 1
  for (int o = kOrder; o >= 1; --o) {
    matmul(A, P, Q, m);
    const float fo = (float)o;
    for (int e = tid; e < m * m; e += kThreads) {
      const int i = e / m, j = e - i * m;
      P[e] = make_float2((i == j ? 1.f : 0.f) + Q[e].x / fo, Q[e].y / fo);
    }
    __syncthreads();
  }
  for (int q = 0; q < s; ++q) {
    matmul(P, P, Q, m);
    for (int e = tid; e < m * m; e += kThreads) P[e] = Q[e];
    __syncthreads();
  }
  // d = c_new - c_prev over the whole buffer (c_new is zero past m)
  for (int i = tid; i < kmax; i += kThreads) {
    const float2 cn = i < m ? P[i * m] : make_float2(0.f, 0.f);
    d[i] = make_float2(cn.x - c[i].x, cn.y - c[i].y);
  }
  __syncthreads();
  float part = 0.f;
  if (G == nullptr) {
    for (int i = tid; i < kmax; i += kThreads) part += d[i].x * d[i].x + d[i].y * d[i].y;
  } else {
    // Re sum_ij conj(d_i) G_ij d_j
    for (int e = tid; e < m * m; e += kThreads) {
      const int i = e / m, j = e - i * m;
      const float2 gd = cmul(G[i * ld + j], d[j]);
      part += d[i].x * gd.x + d[i].y * gd.y;
    }
  }
  const float err = sqrtf(fmaxf(block_sum(part, red), 0.f));
  for (int i = tid; i < kmax; i += kThreads)
    c[i] = i < m ? P[i * m] : make_float2(0.f, 0.f);
  if (tid == 0) {
    const bool conv = k > 0 && (double)err < thresh;
    const bool breakdown = T[(k + 1) * ld + k].x < kEps;
    const bool capped = m >= kmax;
    const bool done = conv || breakdown || capped;
    flags[0] = done ? 0 : 1;
    flags[1 + k] = done ? 1 : 0;
    status[0] = m;
    status[1] = (capped && !conv && !breakdown && !exact) ? 1 : 0;
    status[2] = relax_after >= 0 ? max(m - relax_after, 0) : 0;
    if (count != nullptr) *count += 1;
  }
}

__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle,
                                       const unsigned char* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

size_t ctl_smem(int kmax) {
  return sizeof(float2) * (3 * (size_t)kmax * kmax + kmax) +
         sizeof(float) * kThreads;
}

}  // namespace

// One control step at iteration k (0 <= k < kmax <= 64), layouts above.
// cudaErrorInvalidValue for a k or kmax out of range.
extern "C" int pytdscf_krylov_ctl_c64(int device, const void* T, const void* G,
                                      void* c, void* flags, void* status,
                                      void* count, int k, int kmax,
                                      float sre, float sim, double thresh,
                                      int exact, int relax_after,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (kmax < 1 || kmax > kMaxK || k < 0 || k >= kmax)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ctl_smem(kmax);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(krylov_ctl_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)ctl_smem(kMaxK));
    if (err != cudaSuccess) return (int)err;
  }
  krylov_ctl_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(T), static_cast<const float2*>(G),
      static_cast<float2*>(c), static_cast<unsigned char*>(flags),
      static_cast<int*>(status), static_cast<int*>(count), k, kmax, sre, sim,
      thresh, exact, relax_after);
  return (int)cudaGetLastError();
}

// Adds an IF node, guarded by the device bool *pred as the replay finds it,
// to the graph that `parent` is capturing, and starts capturing its body on
// `child` (relaxed: cudaStreamCaptureModeRelaxed, else Global).  The
// parent's later work depends on the node.  cudaErrorIllegalState if
// `parent` is not capturing.
extern "C" int pytdscf_if_begin(int device, void* parent, const void* pred,
                                void* child, int relaxed) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t ps = static_cast<cudaStream_t>(parent);
  cudaStreamCaptureStatus st;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  err = cudaStreamGetCaptureInfo(ps, &st, nullptr, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return (int)err;
  if (st != cudaStreamCaptureStatusActive) return (int)cudaErrorIllegalState;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  set_conditional_kernel<<<1, 1, 0, ps>>>(
      handle, static_cast<const unsigned char*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamGetCaptureInfo(ps, &st, nullptr, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(ps, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(child), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0,
      relaxed ? cudaStreamCaptureModeRelaxed : cudaStreamCaptureModeGlobal);
}

// Ends the capture of an IF node's body that pytdscf_if_begin started.
extern "C" int pytdscf_if_end(int device, void* child) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaGraph_t body;
  return (int)cudaStreamEndCapture(static_cast<cudaStream_t>(child), &body);
}
