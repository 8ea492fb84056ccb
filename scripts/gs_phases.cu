// Measurement kernels for scripts/gs_phases.py: improved relaxation's
// ground state (pytdscf_torch/csrc/lanczos_gs.cu) with the cycles of each
// phase counted inside the launch.
//
// Thread 0 of every CTA reads clock64 at the end of each phase, after a
// block barrier that the counting adds (so every thread of the CTA has
// finished the phase), and adds the cycles since the previous mark to
// that phase's sum; every CTA writes its sums and counts at the end.
//
// reference_gs_kernel is the ground-state kernel as it stood before its
// redesign (one pass loop over the cluster layer of tdvp_device.cuh,
// which the Lanczos exponential still runs: three cluster barriers an
// iteration, the peers' rows of x gathered one peer after another, the
// second product on nh r threads, the Krylov vectors in device memory),
// kept here as the "before" of the redesign; the kernel of the tree is
// counted through its own probe hook (lanczos_gs.cu: GsProbe).

#include <cuda_runtime.h>

#include "../pytdscf_torch/csrc/lanczos_gs.cu"

namespace {

__device__ __forceinline__ long long clk() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}

// The phases of reference_gs_kernel, in its order
enum RefPhase {
  kRefBarrier,   // the matvec's cluster barrier
  kRefGather,    // the peers' rows of x, one peer after another
  kRefHx,        // rows_times_x
  kRefXRt,       // rows_times_rt
  kRefAlpha,     // alpha's dot, block sum and cluster sum
  kRefBeta,      // the update, beta's block sum and cluster sum
  kRefWrite,     // v_{k+1} into the Krylov scratch and x
  kRefStart,     // a pass's normalisation of its start
  kRefSolve,     // T's lowest eigenpair (tridiag_ground)
  kRefRitz,      // the Ritz vector and its norm
  kRefEnergy,    // the energy's matvec and sum
  kRefPhases
};

// Phase cycles of one CTA, kept in shared memory by thread 0 (registers
// would take from the kernels' own under __launch_bounds__(1024)): the
// cycles and count of each of P phases, the time of the last mark and the
// multisection rounds.
template <int P>
struct PhaseClock {
  long long* a;  // [P] cycles, [P] counts, t0, rounds
  __device__ PhaseClock() {
    __shared__ long long box[2 * P + 2];
    a = box;
  }
  __device__ void start() {
    if (threadIdx.x == 0)
      for (int p = 0; p < 2 * P + 2; ++p) a[p] = 0;
    __syncthreads();
    if (threadIdx.x == 0) a[2 * P] = clk();
  }
  __device__ void mark(int p) {
    __syncthreads();
    if (threadIdx.x == 0) {
      const long long t1 = clk();
      a[p] += t1 - a[2 * P];
      a[P + p] += 1;
      a[2 * P] = t1;
    }
  }
  __device__ void rounds(int n) {
    if (threadIdx.x == 0) a[2 * P + 1] += n;
  }
  // [rank][P cycles, P counts, rounds]
  __device__ void store(long long* out) const {
    if (threadIdx.x != 0) return;
    const int q = (int)cg::this_cluster().block_rank();
    for (int p = 0; p < 2 * P; ++p) out[(size_t)q * (2 * P + 1) + p] = a[p];
    out[(size_t)q * (2 * P + 1) + 2 * P] = a[2 * P + 1];
  }
};

using RefClock = PhaseClock<kRefPhases>;
// the tree's kernel, through its hook
using GsProbe = PhaseClock<kGsPhases>;

// (the reference's own eigensolve, as it stood)
// Eigenvalues of the k-square symmetric tridiagonal T (diagonal a,
// off-diagonal b) below x.
__device__ int ref_sturm_count(const double* a, const double* b, int k, double x) {
  double q = pivot(a[0] - x);
  int n = q < 0.0;
  for (int i = 1; i < k; ++i) {
    q = pivot((a[i] - x) - b[i - 1] * b[i - 1] / q);
    n += q < 0.0;
  }
  return n;
}

// Warp 0: y[0..k) = the unit eigenvector of T's lowest eigenvalue, T the
// k-square symmetric tridiagonal with diagonal a and off-diagonal b (1 <=
// k <= kGsMaxK), in float64.  Returns the multisection rounds taken.
__device__ int ref_tridiag_ground(const double* a, const double* b, int k,
                               double* y) {
  const int lane = threadIdx.x & 31;
  double lo = INFINITY, hi = -INFINITY;
  if (lane < k) {
    const double rad = (lane > 0 ? fabs(b[lane - 1]) : 0.0) +
                       (lane + 1 < k ? fabs(b[lane]) : 0.0);
    lo = a[lane] - rad;
    hi = a[lane] + rad;
  }
  lo = warp_min_d(lo);
  hi = warp_max_d(hi);
  // multisection: every lane computes the same lo and hi, so the loop is
  // uniform over the warp
  int round = 0;
  for (; round < kBisectRounds; ++round) {
    const double w = hi - lo;
    if (!(w > 4.0 * 2.220446049250313e-16 * fmax(fabs(lo), fabs(hi)) +
                  kPivMin))
      break;
    const double x = lo + (double)(lane + 1) * (w / 33.0);
    const unsigned below = __ballot_sync(0xffffffffu, ref_sturm_count(a, b, k, x) >= 1);
    if (below == 0u) {
      lo = lo + 32.0 * (w / 33.0);
    } else {
      const int j0 = __ffs(below) - 1;
      const double xj = lo + (double)(j0 + 1) * (w / 33.0);
      if (j0 > 0) lo = lo + (double)j0 * (w / 33.0);
      hi = xj;
    }
  }
  if (lane == 0) {
    const double lam = 0.5 * (lo + hi);
    double dp[kGsMaxK], dm[kGsMaxK];
    dp[0] = a[0] - lam;
    for (int i = 0; i + 1 < k; ++i)
      dp[i + 1] = (a[i + 1] - lam) - b[i] * b[i] / pivot(dp[i]);
    dm[k - 1] = a[k - 1] - lam;
    for (int i = k - 2; i >= 0; --i)
      dm[i] = (a[i] - lam) - b[i] * b[i] / pivot(dm[i + 1]);
    int tw = 0;
    double best = INFINITY;
    for (int i = 0; i < k; ++i) {
      const double g = fabs(dp[i] + dm[i] - (a[i] - lam));
      if (g < best) {
        best = g;
        tw = i;
      }
    }
    y[tw] = 1.0;
    for (int i = tw - 1; i >= 0; --i) y[i] = -b[i] * y[i + 1] / pivot(dp[i]);
    for (int i = tw + 1; i < k; ++i) y[i] = -b[i - 1] * y[i - 1] / pivot(dm[i]);
    double s = 0.0;
    for (int i = 0; i < k; ++i) s += y[i] * y[i];
    const double inv = 1.0 / sqrt(s);
    for (int i = 0; i < k; ++i) y[i] *= inv;
  }
  return round;
}

constexpr int kRefThreads = kTileThreads;  // 1024
constexpr int kRefMaxK = 24;

__global__ void __launch_bounds__(kRefThreads)
reference_gs_kernel(const float2* __restrict__ H, const float2* __restrict__ Rt,
                    const float2* __restrict__ v_in, float2* __restrict__ out,
                    int* __restrict__ status, float2* scratch, int nc, int M,
                    int r, int kmax, int Mc, int resident, long long* cyc) {
  extern __shared__ float2 smem[];
  __shared__ float2 red[kRefThreads / 32];
  __shared__ double alpha[kRefMaxK];
  __shared__ double beta[kRefMaxK];
  __shared__ double y[kRefMaxK];
  float2* xs = smem;
  float2* T = xs + (size_t)M * r;
  float2* w = T + (size_t)nc * Mc * r;
  float2* g = w + (size_t)Mc * r;
  float2* stage = g + (size_t)Mc * r;
  ClusterRows c = cluster_rows(
      M, Mc, 1, nullptr,
      stage + (size_t)nc * Mc * ((resident ? M : kChunk) + 1));
  const size_t slot = (size_t)Mc * r;
  float2* V = scratch + (size_t)c.rank * (kmax + 1) * slot;
  const ClusterOp op{H, Rt, stage, nc, M, r, Mc, 1.f, resident != 0};
  const int tid = threadIdx.x, n = c.nh * r;
  const size_t row0 = (size_t)c.row0 * r;
  float2* xo = xs + row0;
  RefClock probe;
  cg::this_cluster().sync();
  if (op.resident)
    stage_rows<kRefThreads>(H, stage, nc, M, c.row0, c.nh, 0, M, M, M + 1);
  float s = 0.f;
  for (int i = tid; i < n; i += kRefThreads) {
    const float2 a = v_in[row0 + i];
    s += a.x * a.x + a.y * a.y;
  }
  float nrm = sqrtf(cluster_sum(c, block_sum2<kRefThreads>(s, 0.f, red).x));
  for (int i = tid; i < n; i += kRefThreads) {
    const float2 a = v_in[row0 + i];
    g[i] = make_float2(a.x / nrm, a.y / nrm);
  }
  probe.start();
  int passes = 0, iters = 0, breaks = 0;
  double e_prev = INFINITY;
  for (;;) {
    s = 0.f;
    for (int i = tid; i < n; i += kRefThreads) {
      const float2 a = g[i];
      s += a.x * a.x + a.y * a.y;
    }
    nrm = sqrtf(cluster_sum(c, block_sum2<kRefThreads>(s, 0.f, red).x));
    for (int i = tid; i < n; i += kRefThreads) {
      const float2 a = g[i];
      const float2 v0 = make_float2(a.x / nrm, a.y / nrm);
      V[i] = v0;
      xo[i] = v0;
    }
    probe.mark(kRefStart);
    int k_fin = 0;
    bool broke = false;
    for (int k = 0; k < kmax; ++k) {
      const float2* vk = V + k * slot;
      // cluster_matvec, phase by phase
      cg::this_cluster().sync();
      probe.mark(kRefBarrier);
      cluster_gather<kRefThreads>(c, xs, M, Mc, r);
      probe.mark(kRefGather);
      rows_times_x<kRefThreads>(H, xs, T, stage, nc, M, c.row0, c.nh, r,
                                op.resident);
      probe.mark(kRefHx);
      rows_times_rt<kRefThreads>(T, Rt, w, nc, c.nh, r, 1.f);
      probe.mark(kRefXRt);
      float ar = 0.f;
      for (int i = tid; i < n; i += kRefThreads) {
        const float2 a = vk[i], b = w[i];
        ar += a.x * b.x + a.y * b.y;
      }
      const float al =
          cluster_sum(c, block_sum2<kRefThreads>(ar, 0.f, red).x);
      probe.mark(kRefAlpha);
      const float bprev = k > 0 ? (float)beta[k - 1] : 0.f;
      float s2 = 0.f;
      for (int i = tid; i < n; i += kRefThreads) {
        const float2 a = vk[i];
        float2 x = w[i];
        x.x -= al * a.x;
        x.y -= al * a.y;
        if (k > 0) {
          const float2 b = V[(k - 1) * slot + i];
          x.x -= bprev * b.x;
          x.y -= bprev * b.y;
        }
        w[i] = x;
        s2 += x.x * x.x + x.y * x.y;
      }
      const float bk =
          sqrtf(cluster_sum(c, block_sum2<kRefThreads>(s2, 0.f, red).x));
      probe.mark(kRefBeta);
      const bool live = bk > kEpsBreakdown;
      float2* vn = V + (k + 1) * slot;
      for (int i = tid; i < n; i += kRefThreads) {
        const float2 x = w[i];
        const float2 v =
            live ? make_float2(x.x / bk, x.y / bk) : make_float2(0.f, 0.f);
        vn[i] = v;
        xo[i] = v;
      }
      if (tid == 0) {
        alpha[k] = (double)al;
        beta[k] = (double)bk;
      }
      probe.mark(kRefWrite);
      k_fin = k + 1;
      broke = bk < kEpsBreakdown;
      if (broke) break;
    }
    __syncthreads();
    if (tid < 32) probe.rounds(ref_tridiag_ground(alpha, beta, k_fin, y));
    probe.mark(kRefSolve);
    s = 0.f;
    for (int i = tid; i < n; i += kRefThreads) {
      float pr = 0.f, pi = 0.f;
      for (int j = 0; j < k_fin; ++j) {
        const float yj = (float)y[j];
        const float2 a = V[j * slot + i];
        pr += yj * a.x;
        pi += yj * a.y;
      }
      g[i] = make_float2(pr, pi);
      s += pr * pr + pi * pi;
    }
    nrm = sqrtf(cluster_sum(c, block_sum2<kRefThreads>(s, 0.f, red).x));
    for (int i = tid; i < n; i += kRefThreads) {
      const float2 a = g[i];
      const float2 v = make_float2(a.x / nrm, a.y / nrm);
      g[i] = v;
      xo[i] = v;
    }
    probe.mark(kRefRitz);
    cluster_matvec<kRefThreads>(c, op, xs, T, w);
    float er = 0.f;
    for (int i = tid; i < n; i += kRefThreads) {
      const float2 a = g[i], b = w[i];
      er += a.x * b.x + a.y * b.y;
    }
    const double e =
        (double)cluster_sum(c, block_sum2<kRefThreads>(er, 0.f, red).x);
    probe.mark(kRefEnergy);
    ++passes;
    iters += k_fin;
    breaks += broke ? 1 : 0;
    if (!(fabs(e - e_prev) > 1.0e-12) || passes >= 100) break;
    e_prev = e;
  }
  for (int i = tid; i < n; i += kRefThreads) out[row0 + i] = g[i];
  if (c.rank == 0 && tid == 0) {
    status[0] = passes;
    status[1] = iters;
    status[2] = breaks;
  }
  probe.store(cyc);
  cg::this_cluster().sync();
}

// The first product alone on one CTA of kHxThreads threads (the block
// size of the ground state's clusters): the CTA's nh rows of
// the nc channels staged resident, x whole, `reps` products; the mean
// cycles of one product (and its barrier) into *cyc.  RI = 0:
// tdvp_device.cuh's rows_times_x (2 x 2 tiles, T laid out (nc, nh, r));
// else gs_rows_times_x with RI x CJ tiles.
constexpr int kHxThreads = 512;

template <int RI, int CJ>
__global__ void __launch_bounds__(kHxThreads)
hx_kernel(const float2* __restrict__ H, const float2* __restrict__ x, int nc,
          int M, int r, int nh, int reps, long long* cyc) {
  extern __shared__ float2 smem[];
  float2* xs = smem;
  float2* T = xs + (size_t)M * r;
  float2* stage = T + (size_t)nc * nh * r;
  stage_rows<kHxThreads>(H, stage, nc, M, 0, nh, 0, M, M, M + 1);
  for (int i = threadIdx.x; i < M * r; i += kHxThreads) xs[i] = x[i];
  __syncthreads();
  const long long t0 = clk();
  for (int rep = 0; rep < reps; ++rep) {
    if (RI == 0)
      rows_times_x<kHxThreads>(H, xs, T, stage, nc, M, 0, nh, r, true);
    else
      gs_rows_times_x<kHxThreads, (RI > 0 ? RI : 1), CJ>(
          H, xs, T, stage, nc, M, 0, nh, r, true);
    __syncthreads();
  }
  if (threadIdx.x == 0) *cyc = (clk() - t0) / reps;
}

template <int RI, int CJ>
int hx_launch(const float2* H, const float2* x, int nc, int M, int r, int nh,
              int reps, long long* cyc) {
  const size_t smem =
      sizeof(float2) * ((size_t)M * r + (size_t)nc * nh * r +
                        (size_t)nc * nh * (M + 1));
  cudaError_t err = cudaFuncSetAttribute(
      hx_kernel<RI, CJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  hx_kernel<RI, CJ><<<1, kHxThreads, smem>>>(H, x, nc, M, r, nh, reps, cyc);
  return (int)cudaGetLastError();
}

}  // namespace

// The first product's variants (gs_phases.py: HX_VARIANTS, in this order)
extern "C" int gs_phases_hx(int variant, const void* H, const void* x, int nc,
                            int M, int r, int nh, int reps, void* cyc) {
  const auto* h = static_cast<const float2*>(H);
  const auto* xx = static_cast<const float2*>(x);
  auto* c = static_cast<long long*>(cyc);
  switch (variant) {
    case 0: return hx_launch<0, 2>(h, xx, nc, M, r, nh, reps, c);
    case 1: return hx_launch<2, 2>(h, xx, nc, M, r, nh, reps, c);
    case 2: return hx_launch<2, 4>(h, xx, nc, M, r, nh, reps, c);
    case 3: return hx_launch<4, 2>(h, xx, nc, M, r, nh, reps, c);
    case 4: return hx_launch<4, 4>(h, xx, nc, M, r, nh, reps, c);
    case 5: return hx_launch<1, 4>(h, xx, nc, M, r, nh, reps, c);
    case 6: return hx_launch<2, 3>(h, xx, nc, M, r, nh, reps, c);
    case 7: return hx_launch<2, 6>(h, xx, nc, M, r, nh, reps, c);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The reference kernel on one cluster of C CTAs, its phase cycles into cyc
// (C x (2 kRefPhases + 1), int64).
extern "C" int gs_phases_reference(const void* H, const void* Rt,
                                   const void* v, void* out, void* status,
                                   void* scratch, int nc, int M, int r,
                                   int kmax, int C, int resident, void* cyc) {
  const int Mc = (M + C - 1) / C;
  const size_t smem =
      sizeof(float2) * ((size_t)M * r + (size_t)(nc + 2) * Mc * r +
                        (size_t)nc * Mc * ((resident ? M : kChunk) + 1) +
                        2 * C);
  int device = 0;
  cudaGetDevice(&device);
  return (int)launch_cluster(
      device, reference_gs_kernel, C, kRefThreads, smem, nullptr,
      static_cast<const float2*>(H), static_cast<const float2*>(Rt),
      static_cast<const float2*>(v), static_cast<float2*>(out),
      static_cast<int*>(status), static_cast<float2*>(scratch), nc, M, r,
      kmax, Mc, resident, static_cast<long long*>(cyc));
}

// The tree's kernel (lanczos_gs.cu) on one cluster of C CTAs of `threads`
// threads, its phase cycles into cyc (C x (2 kGsPhases + 1), int64).
extern "C" int gs_phases_tree(const void* H, const void* Rt, const void* v,
                              void* out, void* status, void* scratch, int nc,
                              int M, int r, int kmax, int C, int threads,
                              int wide, int resident, int v_shared,
                              void* cyc) {
  int device = 0;
  cudaGetDevice(&device);
  return (int)gs_dispatch<GsProbe>(
      device, threads, static_cast<const float2*>(H),
      static_cast<const float2*>(Rt), static_cast<const float2*>(v),
      static_cast<float2*>(out), static_cast<int*>(status),
      static_cast<float2*>(scratch), nc, M, r, kmax, C, wide, resident,
      v_shared, nullptr, static_cast<long long*>(cyc));
}
