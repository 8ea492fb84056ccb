// Measurement kernels for scripts/mgs_blocks.py: the one-block MGS factor
// of pytdscf_torch/csrc/tdvp_device.cuh at several block sizes and with
// two ways of staging m, and its dot-product and update loops against the
// alternatives it was chosen over, in cycles per phase (clock64 around
// repeated phases).

#include <cuda_runtime.h>

#include "../pytdscf_torch/csrc/tdvp_device.cuh"

namespace {

__device__ __forceinline__ long long clk() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}

// m into the shared-memory Q in mgs_stage's order, one 8-byte cp.async an
// entry, every one in flight before the block waits for them (the
// alternative to mgs_stage's plain loads)
__device__ void stage_async(const float2* m, float2* Q, int ld, int N,
                            int r) {
  const int step = blockDim.x, span = 2 * N;
  int p = 0, i = threadIdx.x;  // entry i of column pair p
  while (i >= span) {
    i -= span;
    p += 2;
  }
  for (; p < r;) {
    const int j = p + (i & 1), n = i >> 1;
    if (j < r) {
      const unsigned dst = static_cast<unsigned>(
          __cvta_generic_to_shared(Q + (size_t)j * ld + n));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
                   "l"(m + (size_t)n * r + j)
                   : "memory");
    }
    i += step;
    while (i >= span) {
      i -= span;
      p += 2;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the whole factor as mgs_qr.cu's one-block kernel runs it, kThreads
// threads, m staged by plain loads (mgs_stage) or by cp.async
template <int kThreads, bool kAsync>
__global__ void __launch_bounds__(kThreads)
factor_kernel(const float2* m, float2* q_out, float2* r_out, int N, int r) {
  extern __shared__ float2 smem[];
  __shared__ float red[2 * kThreads / 32];
  float2* Q = smem;
  float2* c1 = Q + (size_t)N * r;
  if (kAsync)
    stage_async(m, Q, N, N, r);
  else
    mgs_stage(m, Q, N, N, r);
  __syncthreads();
  mgs_factor<kThreads>(Q, N, r_out, N, r, c1, c1 + r, c1 + 2 * r, red);
  for (int p = 0; p < r; p += 2)
    for (int i = threadIdx.x; i < 2 * N; i += kThreads) {
      const int j = p + (i & 1), n = i >> 1;
      if (j < r) q_out[(size_t)n * r + j] = Q[(size_t)j * N + n];
    }
}

// dot products, J columns a warp, the row loop unrolled four deep
template <int kThreads, int J>
__device__ void dots_j(const float2* Q, int ld, int N, int k, const float2* x,
                       float2* c) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  for (int j0 = J * (threadIdx.x >> 5); j0 < k; j0 += J * kWarps) {
    float v[2 * J];
#pragma unroll
    for (int i = 0; i < 2 * J; ++i) v[i] = 0.f;
#pragma unroll 4
    for (int n = lane; n < N; n += 32) {
      const float2 b = x[n];
#pragma unroll
      for (int t = 0; t < J; ++t) {
        const float2 a = j0 + t < k ? Q[(size_t)(j0 + t) * ld + n]
                                    : make_float2(0.f, 0.f);
        v[2 * t] = fmaf(a.x, b.x, fmaf(a.y, b.y, v[2 * t]));
        v[2 * t + 1] = fmaf(a.x, b.y, fmaf(-a.y, b.x, v[2 * t + 1]));
      }
    }
#pragma unroll
    for (int t = 0; t < J; ++t) {
      const float re = warp_sum(v[2 * t]), im = warp_sum(v[2 * t + 1]);
      if (lane == 0 && j0 + t < k) c[j0 + t] = make_float2(re, im);
    }
  }
}

// update, one row a thread, the terms not unrolled
template <int kThreads>
__device__ void update_plain(const float2* Q, int ld, int N, int k, float2* x,
                             const float2* c) {
  for (int n = threadIdx.x; n < N; n += kThreads) {
    float sr = 0.f, si = 0.f;
#pragma unroll 1
    for (int j = 0; j < k; ++j) {
      const float2 a = Q[(size_t)j * ld + n], b = c[j];
      sr = fmaf(a.x, b.x, fmaf(-a.y, b.y, sr));
      si = fmaf(a.x, b.y, fmaf(a.y, b.x, si));
    }
    x[n] = make_float2(x[n].x - sr, x[n].y - si);
  }
}

// update, S consecutive lanes a row: lane t of a row's group takes the
// terms j = t, t + S, ..., the group's partial sums combined by shuffles
// (log2 S rounds); the rows in rounds of kThreads / S, every lane in each
// round for the shuffles.  Conflict-free for ld = 4 (mod 16): a half-warp's
// S columns then fall on distinct bank octets.
template <int kThreads, int S>
__device__ float update_split(const float2* Q, int ld, int N, int k,
                              float2* x, const float2* c) {
  const unsigned full = 0xffffffffu;
  const int t = threadIdx.x % S;
  float ss = 0.f;
  for (int n0 = 0; n0 < N; n0 += kThreads / S) {
    const int n = n0 + static_cast<int>(threadIdx.x) / S;
    float s[4] = {0.f, 0.f, 0.f, 0.f};  // two chains, (re, im) each
    if (n < N) {
      const float2* q = Q + n;
#pragma unroll 4
      for (int j = t; j < k; j += S) {
        const float2 a = q[(size_t)j * ld], b = c[j];
        const int h = 2 * ((j / S) & 1);
        s[h] = fmaf(a.x, b.x, fmaf(-a.y, b.y, s[h]));
        s[h + 1] = fmaf(a.x, b.y, fmaf(a.y, b.x, s[h + 1]));
      }
    }
    float sr = s[0] + s[2], si = s[1] + s[3];
#pragma unroll
    for (int o = S / 2; o > 0; o >>= 1) {
      sr += __shfl_xor_sync(full, sr, o);
      si += __shfl_xor_sync(full, si, o);
    }
    if (n < N && t == 0) {
      const float2 y = make_float2(x[n].x - sr, x[n].y - si);
      x[n] = y;
      ss += y.x * y.x + y.y * y.y;
    }
  }
  return ss;
}

// cycles of each phase at column k, averaged over reps, into out[0..9]:
// mgs_dots, dots with 1 and 4 columns a warp, mgs_update, the update not
// unrolled, the update with 2, 4 and 8 lanes a row, a block barrier,
// mgs_block_sum; Q's column stride ld
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
phase_kernel(const float2* m, int N, int r, int ld, int k, int reps,
             long long* out) {
  extern __shared__ float2 smem[];
  __shared__ float red[2 * kThreads / 32];
  float2* Q = smem;
  float2* c1 = Q + (size_t)ld * r;
  float2* c2 = c1 + r;
  mgs_stage(m, Q, ld, N, r);
  for (int j = threadIdx.x; j < r; j += kThreads)
    c2[j] = make_float2(1e-3f * j, 0.f);
  __syncthreads();
  float2* x = Q + (size_t)k * ld;
  float acc = 0.f;
  int slot = 0;
  auto time = [&](auto&& phase) {
    __syncthreads();
    const long long t0 = clk();
    for (int i = 0; i < reps; ++i) {
      phase();
      __syncthreads();
    }
    const long long t1 = clk();
    if (threadIdx.x == 0) out[slot] = (t1 - t0) / reps;
    ++slot;
  };
  time([&] {
    mgs_dots<kThreads>(Q, ld, N, k, x, c1, -1, 1.f, nullptr, nullptr, r);
  });
  time([&] { dots_j<kThreads, 1>(Q, ld, N, k, x, c1); });
  time([&] { dots_j<kThreads, 4>(Q, ld, N, k, x, c1); });
  time([&] { acc += mgs_update<kThreads>(Q, ld, N, k, x, c2, -1); });
  time([&] { update_plain<kThreads>(Q, ld, N, k, x, c2); });
  time([&] { acc += update_split<kThreads, 2>(Q, ld, N, k, x, c2); });
  time([&] { acc += update_split<kThreads, 4>(Q, ld, N, k, x, c2); });
  time([&] { acc += update_split<kThreads, 8>(Q, ld, N, k, x, c2); });
  time([] {});
  time([&] { acc += mgs_block_sum<kThreads>(1.f, red); });
  if (acc == -1.f) out[10] = 0;  // keeps the sums live
}

template <int kThreads, bool kAsync>
int run_factor(const void* m, void* q, void* r_out, int N, int r) {
  const size_t smem = sizeof(float2) * ((size_t)N * r + 3 * (size_t)r);
  cudaFuncSetAttribute(factor_kernel<kThreads, kAsync>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  factor_kernel<kThreads, kAsync><<<1, kThreads, smem>>>(
      static_cast<const float2*>(m), static_cast<float2*>(q),
      static_cast<float2*>(r_out), N, r);
  return (int)cudaGetLastError();
}

template <int kThreads>
int run_phases(const void* m, int N, int r, int ld, int k, int reps,
               void* out) {
  const size_t smem = sizeof(float2) * ((size_t)ld * r + 3 * (size_t)r);
  cudaFuncSetAttribute(phase_kernel<kThreads>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  phase_kernel<kThreads><<<1, kThreads, smem>>>(
      static_cast<const float2*>(m), N, r, ld, k, reps,
      static_cast<long long*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// the factor with m staged by plain loads, on 256, 512 or 1024 threads
extern "C" int mgs_blocks_factor(const void* m, void* q, void* r_out, int N,
                                 int r, int threads) {
  switch (threads) {
    case 256: return run_factor<256, false>(m, q, r_out, N, r);
    case 512: return run_factor<512, false>(m, q, r_out, N, r);
    default: return run_factor<1024, false>(m, q, r_out, N, r);
  }
}

// the factor on 1024 threads, m staged by cp.async (async != 0) or not
extern "C" int mgs_blocks_stage(const void* m, void* q, void* r_out, int N,
                                int r, int async) {
  return async ? run_factor<1024, true>(m, q, r_out, N, r)
               : run_factor<1024, false>(m, q, r_out, N, r);
}

extern "C" int mgs_blocks_phases(const void* m, int N, int r, int ld, int k,
                                 int reps, int threads, void* out) {
  return threads == 256 ? run_phases<256>(m, N, r, ld, k, reps, out)
                        : run_phases<1024>(m, N, r, ld, k, reps, out);
}
