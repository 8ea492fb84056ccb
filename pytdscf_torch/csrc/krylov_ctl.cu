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
//   flags[0] = !done (whether the next iteration runs, read by a host-driven
//   program), flags[1 + k] = done (which gather forms psi = c V),
//   status = [m, capped & !conv & !breakdown & !exact, relaxed matvecs]
//
// Inside a captured step the same decision sets the conditions of the step
// graph's IF nodes directly (cudaGraphSetConditional): the handle of
// iteration k + 1's IF node (!done) and of the gather k's (done), which the
// program created before the capture of iteration 0
// (pytdscf_cond_handles, with cudaGraphCondAssignDefault: each replay
// starts them at 0, so the IF node of an iteration, or a gather, whose
// control step never ran stays shut).
//
// The exponential is integrator._expm_taylor_small's: s = ceil(log2 ||A||_1)
// + 3 squarings clamped to 0..64 (0 on a non-finite norm), A / 2^s, the
// reverse Horner p = I + A p / c for c = 12..1, then s squarings.  Only the
// order of the float32 sums and the division by c (a multiplication by 1 /
// c here) differ from the plain version (torch's), and log2 near a power
// of two may take one squaring more or fewer: the result agrees at
// round-off, not bit for bit.
//
// What bounds it: latency.  A call is 12 + s dense m x m products in
// sequence (m = 5-8 on the paths; at m = 8 ~2 k complex multiply-adds each)
// and a reduction: a chain of dependent steps, each a few shared-memory
// loads deep, far from any rate of the card, between the device-memory
// reads of T at its start and the writes at its end.  So the kernel is as
// short a chain as it can be: what the tail reads (c, G, T's breakdown
// entry) is loaded at the start, beside T; for m <= 8 (kWarpM) ONE warp
// runs it on the blocks padded to 8 x 8 (each lane two entries of every
// product in one column, its rows of A in registers, the loop fully
// unrolled, __syncwarp between products, the error summed by a butterfly:
// no block barrier at all); above, one block of 256 threads (kmax up to
// 64: A, P and the next P are 3 * 64 * 64 complex64, 96 KB).  Each Horner
// step writes I + A p / c straight into the other of two P buffers and
// each squaring p p into it, so a product costs one barrier.
//
// IF nodes: torch 2.11 exposes no conditional node, so pytdscf_if_begin
// adds one, on a handle made by pytdscf_cond_handles, to the graph that the
// caller's stream is capturing, and starts capturing the IF node's body
// graph on a second stream (cudaStreamBeginCaptureToGraph); pytdscf_if_end
// ends the body's capture.  Work queued on the second stream in between
// runs only when the handle holds 1 when the replay reaches the node.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kMaxK = 64;
constexpr int kWarpM = 8;  // the largest m of the one-warp kernel
constexpr int kOrder = 12;
constexpr float kEps = 1.0e-14f;

__device__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// A barrier of the kernel's threads: the warp's own where one warp runs it
template <int kThreads>
__device__ __forceinline__ void ctl_sync() {
  if (kThreads == 32)
    __syncwarp();
  else
    __syncthreads();
}

__device__ __forceinline__ float ctl_warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of one float a thread over the kernel's threads, the same bits in
// every thread; red holds kThreads / 32 floats.  Called once a launch.
template <int kThreads>
__device__ float ctl_sum(float v, float* red) {
  constexpr int kWarps = kThreads / 32;
  v = ctl_warp_sum(v);
  if (kWarps == 1) return v;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  return ctl_warp_sum(lane < kWarps ? red[lane] : 0.f);
}

// out = a b (diag: I + a b * inv) for m x m row-major matrices in shared
// memory (out is neither a nor b); the block kernel's product, unrolled 8
// deep along l.  (inv = 1 / c, one rounding more than the plain version's
// division; a float32 division of a zero or tiny sum, which the Horner
// steps make many of, takes the division's slow path.)
template <int kThreads>
__device__ void product(const float2* a, const float2* b, float2* out, int m,
                        bool diag, float inv) {
  for (int e = threadIdx.x; e < m * m; e += kThreads) {
    const int i = e / m, j = e - i * m;
    float re = 0.f, im = 0.f;
#pragma unroll 8
    for (int l = 0; l < m; ++l) {
      const float2 x = a[i * m + l], y = b[l * m + j];
      re += x.x * y.x - x.y * y.y;
      im += x.x * y.y + x.y * y.x;
    }
    out[e] = diag ? make_float2((i == j ? 1.f : 0.f) + re * inv, im * inv)
                  : make_float2(re, im);
  }
  __syncthreads();
}

// The one-warp kernel's product: 8 x 8 matrices (the m x m blocks padded,
// A with zeros, P with the identity: the padding adds exact zeros to the
// block's sums, so the block's bits are those of the m x m product), lane
// l the entries (l / 8, l % 8) and (l / 8 + 4, l % 8): one load of its
// column of b feeds both, the loop fully unrolled with no predicate, a
// row of a from registers (ra: the Horner steps' A, read once) or shared
// memory (the squarings' P).
__device__ __forceinline__ void product8(const float2 (&ra0)[kWarpM],
                                         const float2 (&ra1)[kWarpM],
                                         const float2* b, float2* out,
                                         bool diag, float inv) {
  const int lane = threadIdx.x & 31, i0 = lane >> 3, j = lane & 7;
  float2 col[kWarpM];
#pragma unroll
  for (int l = 0; l < kWarpM; ++l) col[l] = b[l * kWarpM + j];
  float r0 = 0.f, m0 = 0.f, r1 = 0.f, m1 = 0.f;
#pragma unroll
  for (int l = 0; l < kWarpM; ++l) {
    r0 += ra0[l].x * col[l].x - ra0[l].y * col[l].y;
    m0 += ra0[l].x * col[l].y + ra0[l].y * col[l].x;
    r1 += ra1[l].x * col[l].x - ra1[l].y * col[l].y;
    m1 += ra1[l].x * col[l].y + ra1[l].y * col[l].x;
  }
  if (diag) {
    out[i0 * kWarpM + j] =
        make_float2((i0 == j ? 1.f : 0.f) + r0 * inv, m0 * inv);
    out[(i0 + 4) * kWarpM + j] =
        make_float2((i0 + 4 == j ? 1.f : 0.f) + r1 * inv, m1 * inv);
  } else {
    out[i0 * kWarpM + j] = make_float2(r0, m0);
    out[(i0 + 4) * kWarpM + j] = make_float2(r1, m1);
  }
  __syncwarp();
}

// T (kmax+1, kmax+1) and G (the same, or null) row-major complex64; c
// (kmax) complex64, the previous coefficients in, the new ones out; flags
// (kmax + 1) bool; status (3) int32; count (or null) an int32 that the
// launch adds one to; conds: bit 0, set next_h to !done; bit 1, set
// gather_h to done.  kThreads = 32: one warp, m <= kWarpM, the matrices
// padded to kWarpM x kWarpM; else one block, the matrices m x m.
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
krylov_ctl_kernel(const float2* __restrict__ T, const float2* __restrict__ G,
                  float2* __restrict__ c, unsigned char* __restrict__ flags,
                  int* __restrict__ status, int* __restrict__ count, int k,
                  int kmax, float sre, float sim, double thresh, int exact,
                  int relax_after, cudaGraphConditionalHandle next_h,
                  cudaGraphConditionalHandle gather_h, int conds) {
  constexpr bool kWarp = kThreads == 32;
  extern __shared__ float2 smem[];
  const int m = k + 1, ld = kmax + 1, tid = threadIdx.x;
  const int pm = kWarp ? kWarpM : m;  // the matrices' side
  float2* A = smem;
  float2* P = A + pm * pm;
  float2* Q = P + pm * pm;
  float2* d = Q + pm * pm;  // kmax: c_new - c_prev
  float* red = reinterpret_cast<float*>(d + kmax);
  __shared__ int s_shift;

  // what the tail reads from device memory, loaded first so that its
  // latency hides behind the products: this thread's previous
  // coefficients, its entries of G, T's breakdown entry
  constexpr int kC = (kMaxK + kThreads - 1) / kThreads;
  constexpr int kG = kWarp ? 2 : (kMaxK * kMaxK + kThreads - 1) / kThreads;
  float2 cprev[kC], gv[kG];
#pragma unroll
  for (int t = 0; t < kC; ++t) {
    const int i = tid + t * kThreads;
    cprev[t] = i < kmax ? c[i] : make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int t = 0; t < kG; ++t) {
    const int e = tid + t * kThreads, i = e / m, j = e - i * m;
    gv[t] = G != nullptr && e < m * m ? G[i * ld + j] : make_float2(0.f, 0.f);
  }
  const float tbreak = T[(k + 1) * ld + k].x;
  // A = scale T[:m, :m] (padded with zeros); |A_ij| into Q
  const float2 scale = make_float2(sre, sim);
  for (int e = tid; e < pm * pm; e += kThreads) {
    const int i = e / pm, j = e - i * pm;
    const float2 a = i < m && j < m ? cmul(scale, T[i * ld + j])
                                    : make_float2(0.f, 0.f);
    A[e] = a;
    Q[e].x = hypotf(a.x, a.y);
  }
  ctl_sync<kThreads>();
  // ||A||_1, the largest column sum of |A_ij|, on warp 0 (the padding adds
  // exact zeros)
  if (tid < 32) {
    float norm1 = 0.f;
    for (int j = tid; j < m; j += 32) {
      float col = 0.f;
      for (int i = 0; i < m; ++i) col += Q[i * pm + j].x;
      norm1 = fmaxf(norm1, col);
    }
    for (int o = 16; o > 0; o >>= 1)
      norm1 = fmaxf(norm1, __shfl_xor_sync(0xffffffffu, norm1, o));
    if (tid == 0) {
      const double n1 = (double)norm1;
      int s = 0;
      if (isfinite(n1)) {
        const double raw = ceil(log2(fmax(n1, 1e-30))) + 3.0;
        s = (int)fmin(fmax(raw, 0.0), 64.0);
      }
      s_shift = s;
    }
  }
  ctl_sync<kThreads>();
  const int s = s_shift;
  const float inv = ldexpf(1.f, -s);
  for (int e = tid; e < pm * pm; e += kThreads) {
    A[e].x *= inv;
    A[e].y *= inv;
    const int i = e / pm, j = e - i * pm;
    P[e] = make_float2(i == j ? 1.f : 0.f, 0.f);
  }
  ctl_sync<kThreads>();
  // reverse Horner: P <- I + A P / c for c = 12, 11, ..., 1, then s
  // squarings, each into the other buffer
  if constexpr (kWarp) {
    const int i0 = tid >> 3;
    float2 ra0[kWarpM], ra1[kWarpM];
#pragma unroll
    for (int l = 0; l < kWarpM; ++l) {
      ra0[l] = A[i0 * kWarpM + l];
      ra1[l] = A[(i0 + 4) * kWarpM + l];
    }
    for (int o = kOrder; o >= 1; --o) {
      product8(ra0, ra1, P, Q, true, 1.f / (float)o);
      float2* t = P;
      P = Q;
      Q = t;
    }
    for (int q = 0; q < s; ++q) {
#pragma unroll
      for (int l = 0; l < kWarpM; ++l) {
        ra0[l] = P[i0 * kWarpM + l];
        ra1[l] = P[(i0 + 4) * kWarpM + l];
      }
      product8(ra0, ra1, P, Q, false, 1.f);
      float2* t = P;
      P = Q;
      Q = t;
    }
  } else {
    for (int o = kOrder; o >= 1; --o) {
      product<kThreads>(A, P, Q, m, true, 1.f / (float)o);
      float2* t = P;
      P = Q;
      Q = t;
    }
    for (int q = 0; q < s; ++q) {
      product<kThreads>(P, P, Q, m, false, 1.f);
      float2* t = P;
      P = Q;
      Q = t;
    }
  }
  // d = c_new - c_prev over the whole buffer (c_new is zero past m)
#pragma unroll
  for (int t = 0; t < kC; ++t) {
    const int i = tid + t * kThreads;
    if (i < kmax) {
      const float2 cn = i < m ? P[i * pm] : make_float2(0.f, 0.f);
      d[i] = make_float2(cn.x - cprev[t].x, cn.y - cprev[t].y);
    }
  }
  ctl_sync<kThreads>();
  float part = 0.f;
  if (G == nullptr) {
    for (int i = tid; i < kmax; i += kThreads) part += d[i].x * d[i].x + d[i].y * d[i].y;
  } else {
    // Re sum_ij conj(d_i) G_ij d_j
#pragma unroll
    for (int t = 0; t < kG; ++t) {
      const int e = tid + t * kThreads, i = e / m, j = e - i * m;
      if (e < m * m) {
        const float2 gd = cmul(gv[t], d[j]);
        part += d[i].x * gd.x + d[i].y * gd.y;
      }
    }
  }
  const float err = sqrtf(fmaxf(ctl_sum<kThreads>(part, red), 0.f));
  for (int i = tid; i < kmax; i += kThreads)
    c[i] = i < m ? P[i * pm] : make_float2(0.f, 0.f);
  if (tid == 0) {
    const bool conv = k > 0 && (double)err < thresh;
    const bool breakdown = tbreak < kEps;
    const bool capped = m >= kmax;
    const bool done = conv || breakdown || capped;
    flags[0] = done ? 0 : 1;
    flags[1 + k] = done ? 1 : 0;
    status[0] = m;
    status[1] = (capped && !conv && !breakdown && !exact) ? 1 : 0;
    status[2] = relax_after >= 0 ? max(m - relax_after, 0) : 0;
    if (count != nullptr) *count += 1;
    if (conds & 1) cudaGraphSetConditional(next_h, done ? 0u : 1u);
    if (conds & 2) cudaGraphSetConditional(gather_h, done ? 1u : 0u);
  }
}

size_t ctl_smem(int m, int kmax, int threads) {
  const size_t pm = threads == 32 ? kWarpM : m;
  return sizeof(float2) * (3 * pm * pm + kmax) +
         sizeof(float) * (threads / 32);
}

}  // namespace

// One control step at iteration k (0 <= k < kmax <= 64), layouts above: one
// warp for k + 1 <= kWarpM, else one block of 256 threads.  next_h and
// gather_h are the IF-node handles the step sets (conds: bit 0 next_h, bit
// 1 gather_h; 0 outside a captured step).  cudaErrorInvalidValue for a k
// or kmax out of range.
extern "C" int pytdscf_krylov_ctl_c64(int device, const void* T, const void* G,
                                      void* c, void* flags, void* status,
                                      void* count, int k, int kmax,
                                      float sre, float sim, double thresh,
                                      int exact, int relax_after,
                                      unsigned long long next_h,
                                      unsigned long long gather_h, int conds,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (kmax < 1 || kmax > kMaxK || k < 0 || k >= kmax)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m = k + 1;
  const auto* Tp = static_cast<const float2*>(T);
  const auto* Gp = static_cast<const float2*>(G);
  auto* cp = static_cast<float2*>(c);
  auto* fp = static_cast<unsigned char*>(flags);
  auto* sp = static_cast<int*>(status);
  auto* np = static_cast<int*>(count);
  if (m <= kWarpM) {
    krylov_ctl_kernel<32><<<1, 32, ctl_smem(m, kmax, 32), st>>>(
        Tp, Gp, cp, fp, sp, np, k, kmax, sre, sim, thresh, exact,
        relax_after, next_h, gather_h, conds);
  } else {
    const size_t smem = ctl_smem(m, kmax, 256);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(krylov_ctl_kernel<256>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)ctl_smem(kMaxK, kMaxK, 256));
      if (err != cudaSuccess) return (int)err;
    }
    krylov_ctl_kernel<256><<<1, 256, smem, st>>>(
        Tp, Gp, cp, fp, sp, np, k, kmax, sre, sim, thresh, exact,
        relax_after, next_h, gather_h, conds);
  }
  return (int)cudaGetLastError();
}

// n conditional handles, each read 0 at the start of every launch of the
// graph that `parent` is capturing (cudaGraphCondAssignDefault), into out.
// cudaErrorIllegalState if `parent` is not capturing.
extern "C" int pytdscf_cond_handles(int device, void* parent, int n,
                                    unsigned long long* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStreamCaptureStatus st;
  cudaGraph_t graph;
  err = cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(parent), &st,
                                 nullptr, &graph, nullptr, nullptr);
  if (err != cudaSuccess) return (int)err;
  if (st != cudaStreamCaptureStatusActive) return (int)cudaErrorIllegalState;
  for (int i = 0; i < n; ++i) {
    cudaGraphConditionalHandle h;
    err = cudaGraphConditionalHandleCreate(&h, graph, 0,
                                           cudaGraphCondAssignDefault);
    if (err != cudaSuccess) return (int)err;
    out[i] = static_cast<unsigned long long>(h);
  }
  return (int)cudaSuccess;
}

// Adds an IF node on `handle` (made by pytdscf_cond_handles for this graph)
// to the graph that `parent` is capturing, and starts capturing its body on
// `child` (relaxed: cudaStreamCaptureModeRelaxed, else Global).  The
// parent's later work depends on the node.  cudaErrorIllegalState if
// `parent` is not capturing.
extern "C" int pytdscf_if_begin(int device, void* parent,
                                unsigned long long handle, void* child,
                                int relaxed) {
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
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = static_cast<cudaGraphConditionalHandle>(handle);
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
