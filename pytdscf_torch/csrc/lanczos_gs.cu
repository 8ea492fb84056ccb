// Improved relaxation's restarted-Lanczos ground state, every pass of one
// site in one launch.
//
// Replaces the JAX package's mps/tdvp.py:_ground_state_multi over
// mps/integrator.py:lanczos_ground_state: XLA's while_loop and eigh, no
// pl.pallas_call.  Launched from the host, the same work as torch
// operations would be ~25 launches a Krylov iteration and a host read a
// pass, up to 100 passes a site.  The effective operator comes as the
// Lanczos exponential's channels (cuda_lanczos.heff_channels):
//
//     H v = sum_c H_c (v Rt_c),   H_c (M, M),  Rt_c (r, r),  v (M, r).
//
// Semantics (the JAX package's, and the plain version's,
// cuda_lanczos.ground_state_plain):
//   * a pass from v: v_0 = v / ||v||; k_max = min(24, M r) iterations of
//     beta_k v_{k+1} = H v_k - alpha_k v_k - beta_{k-1} v_{k-1},
//     alpha_k = Re <v_k|H v_k>, no re-orthogonalisation; a breakdown
//     (beta_k < 1e-14) ends the pass, v_{k+1} = 0;
//   * T's lowest eigenpair in float64 (alpha and beta are the float32
//     sums, widened), over the k iterations that ran (the JAX package
//     solves the k_max-square T with its tail masked at 1e10: the tail is
//     decoupled and far above, so the lowest eigenpair is the same);
//   * the Ritz vector g = sum_j y_j v_j (y rounded to float32), normalised;
//   * the energy e = Re <g|H g> (one more matvec);
//   * passes run while |e - e_prev| > 1e-12 (e_prev = inf before the
//     first) and fewer than 100 ran: at least two run.
// status = (passes, Lanczos iterations, breakdowns), int32.
//
// What bounds it on the H100: latency.  A Krylov iteration is a chain of
// short dependent steps (the matvec, a reduction, the next vector), and
// the pass count is set by the 1e-12 restart test at the rounding of a
// float32 energy, up to 100 passes of up to 25 matvecs.  At the butadiene
// bulk site (nc = 30, M = 72, r = 12) one matvec is 2.2 M complex
// multiply-adds (17.4 MFLOP), 0.26 us at the card's fp32 peak but ~2.5 us
// on the 16 SMs of one cluster; everything else is a few passes over
// 864-entry vectors.  The kernel before this design spent ~70 k cycles an
// iteration there, most of it a second product on 60 threads and three
// cluster barriers (scripts/gs_phases.py: reference_gs_kernel).  This one
// keeps one cluster barrier an iteration and every vector in shared
// memory:
//
//  * One thread-block cluster of C CTAs (cuda_lanczos.gs_plan: 16 CTAs of
//    512 threads for every site with a matvec of 50 k complex
//    multiply-adds or more, one CTA of 128 below; 1024 threads spill
//    registers).  Rank q owns rows [q Mc, min(M, (q+1) Mc)), Mc = ceil(M
//    / C), of every H_c, and computes those rows of each matvec: its rows
//    of H_c sit in its shared memory for the whole launch (or stream
//    through a slice of kChunk columns where they do not fit), Rt and its
//    rows of the Krylov vectors too (the latter in device scratch where
//    they do not fit).
//  * A site whose three whole vectors, T and Rt do not fit a CTA's shared
//    memory beside its rows of H (M r past ~8 k entries, a large nc r^2,
//    or H's rows resident only without them) takes the wide layout: each
//    CTA's three whole-vector buffers live in device scratch, read and
//    written at L2 (ld/st.cg, ordered between CTAs by the cluster
//    barrier's release and acquire); an exchange's rows are stored once,
//    into one of two vectors the cluster shares, and every CTA reads them
//    whole from there after the barrier (not pushed into C buffers); v_k
//    is copied into shared memory for each first product, and the second
//    product reads Rt from device memory.  The same operations in the same
//    order: the same bits as the shared layout on the same inputs.
//  * Every CTA holds the current Krylov vector WHOLE, and does the
//    vector work of an iteration on all n = M r entries itself, in the
//    same order as every other CTA: the same bits everywhere, so all take
//    the same breakdown and restart branch and none leaves a loop alone.
//  * The one exchange of an iteration: each CTA pushes its rows of
//    u = H v_k - beta_{k-1} v_{k-1} into every CTA's shared memory
//    (distributed shared memory stores, issued as each row is finished)
//    with its partial of alpha_k = Re <v_k|H v_k> over its rows; one
//    cluster barrier; then every CTA sums the C partials in rank order
//    and forms w = u - alpha_k v_k, beta_k = ||w|| and v_{k+1} = w /
//    beta_k over the whole vector.  (beta_k comes from w itself, never
//    from ||H v_k||^2 less alpha^2 and beta^2: near convergence beta_k
//    << ||H v_k|| and float32 would cancel.)  Three whole-vector buffers
//    rotate over the exchanges: pushes of exchange e land in box[e % 3],
//    which then holds v_{k+1} in place; v_k is box[(e + 2) % 3] and
//    v_{k-1} box[(e + 1) % 3].  A CTA pushes into box[e % 3] only after
//    the barrier of exchange e - 1, which every CTA reaches after its
//    last read of that buffer (as v_{k-1} there, before its barrier).
//  * The first product H_c x writes T laid out (rows, channels, r), so
//    that the second, sum_c T_c Rt_c over a CTA's rows, is a dot product
//    of a row of T with a row of Rt transposed (staged once a launch):
//    S lanes of one warp a group of J = 4, 3 or 2 outputs of one row,
//    each lane summing every S-th entry in order (lanes on neighbouring
//    entries of both rows), a butterfly combining the lanes (the same
//    bits in every lane of the group), the pushes of an output spread
//    over its lanes.
//  * Per pass, two more exchanges: the Ritz vector's rows with their
//    partial norms, and the energy matvec's partial Re <g|H g> (no rows).
//    T's eigenpair on the whole block (tridiag_ground).
//
// Arithmetic: fp32 FMA (no TF32) outside T's solve; float64 inside it.
//
// Layout: complex64 as float2, row-major, contiguous.  Dynamic shared
// memory per CTA (cuda_lanczos.gs_smem_bytes): box (3 n; wide: v_k's copy,
// n), T (Mc nc r), Rt transposed (r, nc r; wide: none), the CTA's rows of
// v_0 .. v_{kmax-1} (kmax Mc r, or none when they live in scratch), the
// CTA's rows of H (nc Mc rows of M + 1 entries when `resident`, else
// kChunk + 1).  Device scratch: the Krylov vectors' rows (C kmax Mc r)
// where they do not fit, then the wide layout's boxes (C 3 n) and its two
// shared vectors (2 n).

#include <cuda_runtime.h>

#include <cmath>

#include "tdvp_device.cuh"

namespace {

constexpr int kGsMaxK = 24;             // integrator.GS_BLOCK_DIM
constexpr int kGsMaxPasses = 100;       // integrator.GS_MAX_RESTARTS
constexpr double kGsTol = 1.0e-12;      // integrator.GS_TOL
constexpr int kGsMaxC = 16;             // the largest cluster
constexpr double kPivMin = 1.0e-290;    // smallest pivot of a factorisation
constexpr int kBisectRounds = 40;

__device__ __forceinline__ double warp_min_d(double v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmin(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ double warp_max_d(double v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ double pivot(double q) {
  return fabs(q) < kPivMin ? -kPivMin : q;
}

// 1 / q in float64 with no branch (so that independent chains of them
// overlap): the hardware's approximate reciprocal refined by two Newton
// steps, to about an ulp
__device__ __forceinline__ double rcp64(double q) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(q));
  double e = fma(-q, r, 1.0);
  r = fma(r, e, r);
  e = fma(-q, r, 1.0);
  return fma(r, e, r);
}

constexpr double kHuge = 1.0e150;   // the leading minors' rescaling bound
constexpr double kTiny = 1.0e-100;  // a zero minor's stand-in, relative

// The whole block: y[0..k) = the unit eigenvector of T's lowest eigenvalue,
// T the k-square symmetric tridiagonal with diagonal a and off-diagonal b
// (1 <= k <= kGsMaxK), in float64; dp and dm hold k doubles each (the
// pivots), hit 2 kThreads / 32 ints.  Every thread gets the same
// eigenvalue bits.  Returns the multisection rounds taken.
//
// The eigenvalue: multisection of the Gershgorin interval on the Sturm
// count, every thread counting at one of kThreads points (a float64 chain
// is latency-bound: one warp counting at four points each was issue-bound
// and took twice as long), the first point with an eigenvalue below it
// found by a ballot in each warp and the warps' answers in shared memory,
// until the interval is a few ulps wide (6 rounds at 512 points, 8 at 128,
// from a width of order one, against 11 for 32 points on one warp).  The
// count is the sign changes of the leading minors p_i = det(T_i - x) =
// (a_i - x) p_{i-1} - b_{i-1}^2 p_{i-2} (a negative pivot p_i / p_{i-1}
// of T - x for each): one fused multiply-add deep a step, where the pivot
// recurrence waits on a float64 division.  The pair is rescaled by
// kHuge^{+-1} every fourth step once it has left [1 / kHuge, kHuge] (four
// steps grow it by at most (|a - x| + b^2)^4), and a zero minor counts as
// a negative pivot, as the pivot form's -pivmin does.
//
// The eigenvector, on warp 0: the twisted factorisation of T - lambda, its
// forward pivots on lane 0 and backward pivots on lane 1 together, the
// twist where they meet with the smallest pivot, then y from the twist
// upward on lane 0 and downward on lane 1, normalised over the warp.
template <int kThreads>
__device__ __noinline__ int tridiag_ground(const double* a, const double* b,
                                           int k, double* y, double* dp,
                                           double* dm, int* hit) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double lo = INFINITY, hi = -INFINITY;
  if (lane < k) {
    const double rad = (lane > 0 ? fabs(b[lane - 1]) : 0.0) +
                       (lane + 1 < k ? fabs(b[lane]) : 0.0);
    lo = a[lane] - rad;
    hi = a[lane] + rad;
  }
  lo = warp_min_d(lo);
  hi = warp_max_d(hi);
  // every thread computes the same lo and hi, so the loop is uniform
  int round = 0;
  for (; round < kBisectRounds; ++round) {
    const double w = hi - lo;
    if (!(w > 4.0 * 2.220446049250313e-16 * fmax(fabs(lo), fabs(hi)) +
                  kPivMin))
      break;
    const double h = w / (kThreads + 1.0);
    const double x = lo + (double)(threadIdx.x + 1) * h;
    double p = a[0] - x, pp = 1.0;
    p = p == 0.0 ? -kTiny : p;
    int cnt = p < 0.0;
    for (int i = 1; i < k; ++i) {
      double pn = fma(a[i] - x, p, -(b[i - 1] * b[i - 1]) * pp);
      pn = pn == 0.0 ? -kTiny * p : pn;
      cnt += (pn < 0.0) != (p < 0.0);
      pp = p;
      p = pn;
      if ((i & 3) == 0) {
        const double big = fmax(fabs(p), fabs(pp));
        const double sc = big > kHuge       ? 1.0 / kHuge
                          : big < 1.0 / kHuge ? kHuge
                                              : 1.0;
        p *= sc;
        pp *= sc;
      }
    }
    // the first point with an eigenvalue below it (kThreads: none)
    const unsigned below = __ballot_sync(0xffffffffu, cnt >= 1);
    int pt = below != 0u ? 32 * warp + __ffs(below) - 1 : kThreads;
    int* box = hit + (round & 1) * kWarps;
    if (lane == 0) box[warp] = pt;
    __syncthreads();
    pt = kThreads;
    for (int q = 0; q < kWarps; ++q) pt = min(pt, box[q]);
    if (pt == kThreads) {
      lo = lo + (double)kThreads * h;
    } else {
      hi = lo + (double)(pt + 1) * h;
      if (pt > 0) lo = lo + (double)pt * h;
    }
  }
  if (warp != 0) return round;
  const double lam = 0.5 * (lo + hi);
  if (lane == 0) {
    dp[0] = a[0] - lam;
    for (int i = 0; i + 1 < k; ++i)
      dp[i + 1] = (a[i + 1] - lam) - b[i] * b[i] * rcp64(pivot(dp[i]));
  } else if (lane == 1) {
    dm[k - 1] = a[k - 1] - lam;
    for (int i = k - 2; i >= 0; --i)
      dm[i] = (a[i] - lam) - b[i] * b[i] * rcp64(pivot(dm[i + 1]));
  }
  __syncwarp();
  // the twist: the smallest |dp + dm - (a - lam)|, the lowest index on a tie
  double g = INFINITY;
  int tw = lane;
  if (lane < k) g = fabs(dp[lane] + dm[lane] - (a[lane] - lam));
  for (int o = 16; o > 0; o >>= 1) {
    const double g2 = __shfl_xor_sync(0xffffffffu, g, o);
    const int t2 = __shfl_xor_sync(0xffffffffu, tw, o);
    if (g2 < g || (g2 == g && t2 < tw)) {
      g = g2;
      tw = t2;
    }
  }
  if (lane == 0) {
    double yi = 1.0;
    y[tw] = yi;
    for (int i = tw - 1; i >= 0; --i) {
      yi = -b[i] * yi * rcp64(pivot(dp[i]));
      y[i] = yi;
    }
  } else if (lane == 1) {
    double yi = 1.0;
    for (int i = tw + 1; i < k; ++i) {
      yi = -b[i - 1] * yi * rcp64(pivot(dm[i]));
      y[i] = yi;
    }
  }
  __syncwarp();
  double sy = lane < k ? y[lane] * y[lane] : 0.0;
  for (int o = 16; o > 0; o >>= 1) sy += __shfl_xor_sync(0xffffffffu, sy, o);
  const double inv = 1.0 / sqrt(sy);
  __syncwarp();
  if (lane < k) y[lane] *= inv;
  return round;
}

// The phases of lanczos_gs_kernel, for a counting hook (scripts/gs_phases.cu)
enum GsPhase {
  kGsHx,        // the first product, H_c x on the CTA's rows
  kGsXRt,       // the second product and its pushes
  kGsPartial,   // alpha's partial over the CTA's rows, pushed
  kGsExchange,  // the cluster barrier of an iteration
  kGsUpdate,    // alpha, w = u - alpha v_k and beta over the whole vector
  kGsNext,      // v_{k+1} = w / beta in place, its rows kept
  kGsStart,     // a pass's v_0 = g / ||g||
  kGsSolve,     // T's lowest eigenpair (tridiag_ground)
  kGsRitz,      // the Ritz vector's rows, their exchange, its norm
  kGsEnergy,    // the energy's matvec and exchange
  kGsPhases
};

// The hook of the production kernel: counts nothing
struct GsNoProbe {
  __device__ void start() {}
  __device__ void mark(int) {}
  __device__ void rounds(int) {}
  __device__ void store(long long*) const {}
};

// The block's sum of one float per thread, the same bits in every thread
// (tdvp_device.cuh: mgs_block_sum).
// part alternates between two halves, so a call's partials never meet the
// reads of the call before it (a barrier lies between).
template <int kThreads>
__device__ __forceinline__ float gs_block_sum(float v, float* part, int& half) {
  constexpr int kWarps = kThreads / 32;
  float* p = part + half * kWarps;
  half ^= 1;
  return mgs_block_sum<kThreads>(v, p);
}

// An entry of a whole-vector buffer: in shared memory, or (kWide) in
// device scratch at L2, where the pushes of other CTAs land
template <bool kWide>
__device__ __forceinline__ float2 bld(const float2* p) {
  if constexpr (kWide)
    return __ldcg(p);
  else
    return *p;
}

template <bool kWide>
__device__ __forceinline__ void bst(float2* p, float2 v) {
  if constexpr (kWide)
    __stcg(p, v);
  else
    *p = v;
}

// v into slot idx of buf in CTA q of the cluster (C = 1: this CTA)
__device__ __forceinline__ void push(float2* buf, int q, int idx, float2 v,
                                     int C) {
  if (C == 1)
    buf[idx] = v;
  else
    cg::this_cluster().map_shared_rank(buf, q)[idx] = v;
}

__device__ __forceinline__ void push1(float* buf, int q, int idx, float v,
                                      int C) {
  if (C == 1)
    buf[idx] = v;
  else
    cg::this_cluster().map_shared_rank(buf, q)[idx] = v;
}

// The cluster barrier of an exchange: every CTA's pushes before it are
// visible to every CTA after it (arrive.release, wait.acquire)
__device__ __forceinline__ void exchange(int C) {
  if (C == 1)
    __syncthreads();
  else
    cg::this_cluster().sync();
}

// stage_rows for the streamed first product: each thread issues its
// loads of a slice kStageBatch at a time before it stores them (the copy
// waits on device memory once a batch, not once an entry)
constexpr int kStageBatch = 8;

template <int kThreads>
__device__ void gs_stage_rows(const float2* __restrict__ H, float2* stage,
                              int nc, int M, int row0, int nh, int k0,
                              int kn, int kc, int ks) {
  const int total = nc * nh * kc;
  for (int e0 = threadIdx.x; e0 < total; e0 += kStageBatch * kThreads) {
    float2 v[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int e = e0 + u * kThreads, row = e / kc, kk = e - row * kc;
      const int c = row / nh, i = row - c * nh;
      v[u] = e < total && kk < kn
                 ? H[((size_t)c * M + row0 + i) * M + k0 + kk]
                 : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int e = e0 + u * kThreads, row = e / kc, kk = e - row * kc;
      if (e < total) stage[row * ks + kk] = v[u];
    }
  }
}

// T[i][c][j] = sum_k H_c[row0 + i][k] x[k][j] for this CTA's nh rows: H's
// rows from stage (row c nh + i of the CTA's nc nh rows; all M columns,
// loaded once by the caller, row stride M + 1, when resident; else slices
// of kChunk columns loaded here, each once: the sums carried in T from one
// slice to the next, the same operations in the same order), x (M, r)
// whole in shared memory, T laid out (nh, nc, r), so that row i of T is
// one contiguous nc r vector (the second product's dot products).  Each
// thread a tile of RI rows by CJ columns: per depth step RI + CJ loads
// feed 4 RI CJ multiply-adds.
template <int kThreads, int RI, int CJ>
__device__ void gs_rows_times_x(const float2* __restrict__ H, const float2* xs,
                                float2* T, float2* stage, int nc, int M,
                                int row0, int nh, int r, bool resident) {
  const int rows = nc * nh, rp = (rows + RI - 1) / RI, cp = (r + CJ - 1) / CJ;
  const int items = rp * cp, kc = resident ? M : kChunk, ks = kc + 1;
  for (int k0 = 0; k0 < M; k0 += kc) {
    const int kn = min(kc, M - k0);
    if (!resident) {
      __syncthreads();  // the previous slice and its sums are done
      gs_stage_rows<kThreads>(H, stage, nc, M, row0, nh, k0, kn, kc, ks);
      __syncthreads();
    }
    for (int base = 0; base < items; base += kThreads) {
      const int idx = base + threadIdx.x;
      if (idx >= items) break;
      const int ci = RI * (idx / cp), j = CJ * (idx - (idx / cp) * cp);
      const float2* h[RI];
#pragma unroll
      for (int a = 0; a < RI; ++a)
        h[a] = stage + (size_t)min(ci + a, rows - 1) * ks;
      int col[CJ];  // the columns read (the last one again past r)
#pragma unroll
      for (int b = 0; b < CJ; ++b) col[b] = min(j + b, r - 1);
      float2* out[RI];  // row ci + a of T (the last one again past rows)
#pragma unroll
      for (int a = 0; a < RI; ++a) {
        const int row = min(ci + a, rows - 1), c = row / nh;
        out[a] = T + ((size_t)(row - c * nh) * nc + c) * r;
      }
      float2 acc[RI][CJ];
#pragma unroll
      for (int a = 0; a < RI; ++a)
#pragma unroll
        for (int b = 0; b < CJ; ++b)
          acc[a][b] = k0 > 0 && ci + a < rows && j + b < r
                          ? out[a][j + b] : make_float2(0.f, 0.f);
#pragma unroll 2
      for (int kk = 0; kk < kn; ++kk) {
        const float2* xr = xs + (size_t)(k0 + kk) * r;
        float2 xv[CJ], hv[RI];
#pragma unroll
        for (int b = 0; b < CJ; ++b) xv[b] = xr[col[b]];
#pragma unroll
        for (int a = 0; a < RI; ++a) hv[a] = h[a][kk];
#pragma unroll
        for (int a = 0; a < RI; ++a)
#pragma unroll
          for (int b = 0; b < CJ; ++b) {
            acc[a][b].x += hv[a].x * xv[b].x - hv[a].y * xv[b].y;
            acc[a][b].y += hv[a].x * xv[b].y + hv[a].y * xv[b].x;
          }
      }
#pragma unroll
      for (int a = 0; a < RI; ++a) {
        if (ci + a >= rows) break;
#pragma unroll
        for (int b = 0; b < CJ; ++b)
          if (j + b < r) out[a][j + b] = acc[a][b];
      }
    }
  }
}

// The tiles of the first product (gs_rows_times_x): 2 x 2 where its
// tiles fit one round of the block's threads (measured fastest of eight
// at the relax stages' shapes, scripts/gs_phases.py), else the larger
// tile, fewer loads a multiply-add (scripts/relax_step.py --site).  Which
// thread computes an output changes no sum: the same bits either way.
constexpr int kTileRows = 2;
constexpr int kTileCols = 2;
constexpr int kBigTileRows = 4;
constexpr int kBigTileCols = 2;

// gs_rows_times_x on the tile that suits the CTA's rows
template <int kThreads>
__device__ __forceinline__ void gs_first_product(
    const float2* __restrict__ H, const float2* xs, float2* T, float2* stage,
    int nc, int M, int row0, int nh, int r, bool resident) {
  const int small_items = ((nc * nh + kTileRows - 1) / kTileRows) *
                          ((r + kTileCols - 1) / kTileCols);
  if (small_items <= kThreads)
    gs_rows_times_x<kThreads, kTileRows, kTileCols>(H, xs, T, stage, nc, M,
                                                    row0, nh, r, resident);
  else
    gs_rows_times_x<kThreads, kBigTileRows, kBigTileCols>(
        H, xs, T, stage, nc, M, row0, nh, r, resident);
}

// y (the CTA's nrow = nh r outputs) = sum_c T_c Rt_c on its rows: output
// (i, j) is the dot product of T's row i (nc r entries, laid out (nh, nc,
// r)) with row j of rtT (Rt transposed: rtT[j][c r + m] = Rt_c[m][j]; or,
// kRtDevice, with column j of Rt itself in device memory, entry c r + m at
// (c r + m) r + j).
// A group of S lanes of one warp (a power of two <= 32 with S groups <=
// kThreads) takes row i and J neighbouring columns: lane s reads the
// entries s, s + S, ... of T's row once for the J dot products (1 + J
// loads for J multiply-adds; lanes on neighbouring entries: no bank
// conflicts), a butterfly leaves each sum, the same bits, in every lane
// of the group, and f(o, y, s, S) runs on each of them for each of the
// group's outputs o = i r + j.  Every thread runs the same number of
// rounds (the shuffles need the full warp).
template <int kThreads, int J, bool kRtDevice, class F>
__device__ void rows_rt_spread(const float2* T, const float2* rtT, int nc,
                               int nh, int r, F& f) {
  const int L = nc * r, jb = (r + J - 1) / J, groups = nh * jb;
  int S = 32;
  while (S > 1 && S * groups > kThreads) S >>= 1;
  const int G = kThreads / S;
  const int s = threadIdx.x & (S - 1), grp = threadIdx.x / S;
  for (int g0 = 0; g0 < groups; g0 += G) {
    const int g = g0 + grp;
    const int i = g < groups ? g / jb : 0, j0 = J * (g - i * jb);
    float2 acc[J];
    const float2* rp[J];
#pragma unroll
    for (int b = 0; b < J; ++b) {
      acc[b] = make_float2(0.f, 0.f);
      rp[b] = rtT + (size_t)min(j0 + b, r - 1) * (kRtDevice ? 1 : L);
    }
    if (g < groups) {
      const float2* tp = T + (size_t)i * L;
#pragma unroll 2
      for (int idx = s; idx < L; idx += S) {
        const float2 a = tp[idx];
#pragma unroll
        for (int b = 0; b < J; ++b) {
          const float2 x =
              kRtDevice ? __ldg(rp[b] + (size_t)idx * r) : rp[b][idx];
          acc[b].x += a.x * x.x - a.y * x.y;
          acc[b].y += a.x * x.y + a.y * x.x;
        }
      }
    }
    for (int off = S >> 1; off > 0; off >>= 1)
#pragma unroll
      for (int b = 0; b < J; ++b) {
        acc[b].x += __shfl_xor_sync(0xffffffffu, acc[b].x, off);
        acc[b].y += __shfl_xor_sync(0xffffffffu, acc[b].y, off);
      }
    if (g < groups)
#pragma unroll
      for (int b = 0; b < J; ++b)
        if (j0 + b < r) f(i * r + j0 + b, acc[b], s, S);
  }
}

// rows_rt_spread with J = 4, 3, 2 or 1 columns a group: the largest that
// divides r
template <int kThreads, bool kRtDevice, class F>
__device__ void rows_times_rt_spread(const float2* T, const float2* rtT,
                                     int nc, int nh, int r, F f) {
  if (r % 4 == 0)
    rows_rt_spread<kThreads, 4, kRtDevice>(T, rtT, nc, nh, r, f);
  else if (r % 3 == 0)
    rows_rt_spread<kThreads, 3, kRtDevice>(T, rtT, nc, nh, r, f);
  else if (r % 2 == 0)
    rows_rt_spread<kThreads, 2, kRtDevice>(T, rtT, nc, nh, r, f);
  else
    rows_rt_spread<kThreads, 1, kRtDevice>(T, rtT, nc, nh, r, f);
}

template <int kThreads, bool kWide, class Probe>
__global__ void __launch_bounds__(kThreads)
lanczos_gs_kernel(const float2* __restrict__ H, const float2* __restrict__ Rt,
                  const float2* __restrict__ v_in, float2* __restrict__ out,
                  int* __restrict__ status, float2* scratch, int nc, int M,
                  int r, int kmax, int Mc, int resident, int v_shared,
                  long long* cyc) {
  constexpr int kWarps = kThreads / 32;
  extern __shared__ float2 smem[];
  __shared__ float part[2 * kWarps];
  __shared__ float abox[3][kGsMaxC];  // the partials of each exchange
  __shared__ double alpha[kGsMaxK];
  __shared__ double beta[kGsMaxK];
  __shared__ double y[kGsMaxK];
  __shared__ double piv[2][kGsMaxK];  // tridiag_ground's pivots
  __shared__ int hit[2 * kWarps];     // and its multisection's answers
  const int tid = threadIdx.x, n = M * r;
  const int C = (int)cg::this_cluster().num_blocks();
  const int rank = (int)cg::this_cluster().block_rank();
  const int row0 = rank * Mc, nh = max(0, min(Mc, M - row0));
  const int nrow = nh * r, e0 = row0 * r;  // this CTA's entries
  const size_t slot = (size_t)Mc * r, n3 = 3 * (size_t)n;
  // wide: v_k's copy for the first product; else the three buffers
  float2* xcopy = smem;
  float2* T = smem + (kWide ? (size_t)n : n3);  // (Mc, nc, r)
  float2* rtT = T + (size_t)nc * slot;    // (r, nc r): Rt transposed
  float2* vs = rtT + (kWide ? 0 : (size_t)nc * r * r);  // (kmax, Mc, r)
  float2* stage = vs + (v_shared ? (size_t)kmax * slot : 0);
  // this CTA's rows of v_0 .. v_{kmax-1}, and its three buffers: written
  // and read back inside the launch, so no __restrict__ const view of
  // them may exist
  float2* V = v_shared ? vs : scratch + (size_t)rank * kmax * slot;
  float2* wide = scratch + (v_shared ? 0 : (size_t)C * kmax * slot);
  float2* box = kWide ? wide + (size_t)rank * n3 : smem;
  // wide: the exchanges' rows land once, in one of two vectors shared by
  // the cluster (by parity: a CTA writes one only after the barrier that
  // follows every read of its last contents), not in every CTA's buffer
  float2* inbox = wide + (size_t)C * n3;
  const float2* rt = kWide ? Rt : rtT;
  Probe probe;
  int half = 0;
  // every CTA of the cluster runs before any addresses another's memory
  cg::this_cluster().sync();
  if (resident)
    stage_rows<kThreads>(H, stage, nc, M, row0, nh, 0, M, M, M + 1);
  if (!kWide)
    for (int e = tid; e < nc * r * r; e += kThreads) {
      const int c = e / (r * r), m = (e / r) % r, j = e % r;
      rtT[(size_t)j * nc * r + c * r + m] = Rt[e];
    }
  // v_k for the first product: box itself, or its copy (wide)
  auto operand = [&](const float2* x) -> const float2* {
    if constexpr (kWide) {
      for (int i = tid; i < n; i += kThreads) xcopy[i] = bld<true>(x + i);
      __syncthreads();
      return xcopy;
    } else {
      return x;
    }
  };

  // g = the start vector, normalised, whole in box[1]; each pass
  // normalises its start again
  float s = 0.f;
  for (int i = tid; i < n; i += kThreads) {
    const float2 a = v_in[i];
    s += a.x * a.x + a.y * a.y;
  }
  float nrm = sqrtf(gs_block_sum<kThreads>(s, part, half));
  for (int i = tid; i < n; i += kThreads) {
    const float2 a = v_in[i];
    bst<kWide>(box + n + i, make_float2(a.x / nrm, a.y / nrm));
  }
  probe.start();

  int ex = 0;  // exchanges so far
  int passes = 0, iters = 0, breaks = 0;
  double e_prev = INFINITY;
  for (;;) {
    // ---- one pass (lanczos_ground_state) from g = box[(ex + 1) % 3]
    {
      const float2* g = box + (size_t)((ex + 1) % 3) * n;
      float2* x0 = box + (size_t)((ex + 2) % 3) * n;
      s = 0.f;
      for (int i = tid; i < n; i += kThreads) {
        const float2 a = bld<kWide>(g + i);
        s += a.x * a.x + a.y * a.y;
      }
      nrm = sqrtf(gs_block_sum<kThreads>(s, part, half));
      for (int i = tid; i < n; i += kThreads) {
        const float2 a = bld<kWide>(g + i);
        bst<kWide>(x0 + i, make_float2(a.x / nrm, a.y / nrm));
      }
      for (int i = tid; i < nrow; i += kThreads) {
        const float2 a = bld<kWide>(g + e0 + i);
        V[i] = make_float2(a.x / nrm, a.y / nrm);
      }
      __syncthreads();
      probe.mark(kGsStart);
    }
    int k_fin = 0;
    bool broke = false;
    for (int k = 0; k < kmax; ++k) {
      float2* w = box + (size_t)(ex % 3) * n;               // the pushes
      const float2* x = box + (size_t)((ex + 2) % 3) * n;   // v_k
      const float2* xp = box + (size_t)((ex + 1) % 3) * n;  // v_{k-1}
      const float bprev = k > 0 ? (float)beta[k - 1] : 0.f;
      float2* in = kWide ? inbox + (size_t)(ex & 1) * n : w;  // the rows
      gs_first_product<kThreads>(H, operand(x), T, stage, nc, M, row0, nh,
                                 r, resident != 0);
      __syncthreads();
      probe.mark(kGsHx);
      // u = H v_k - beta_{k-1} v_{k-1} on this CTA's rows, pushed to every
      // CTA as each output is finished; alpha's partial over the rows
      float ar = 0.f;
      rows_times_rt_spread<kThreads, kWide>(
          T, rt, nc, nh, r, [&](int o, float2 hv, int ls, int S) {
            const float2 v = bld<kWide>(x + e0 + o);
            float2 u = hv;
            if (k > 0) {
              const float2 b = bld<kWide>(xp + e0 + o);
              u.x -= bprev * b.x;
              u.y -= bprev * b.y;
            }
            if constexpr (kWide) {
              if (ls == 0) __stcg(in + e0 + o, u);
            } else {
              for (int q = ls; q < C; q += S) push(w, q, e0 + o, u, C);
            }
            if (ls == 0) ar += v.x * hv.x + v.y * hv.y;  // Re conj(v) Hv
          });
      probe.mark(kGsXRt);
      ar = gs_block_sum<kThreads>(ar, part, half);
      if (tid < C) push1(abox[ex % 3], tid, rank, ar, C);
      probe.mark(kGsPartial);
      exchange(C);
      probe.mark(kGsExchange);
      // alpha: the partials in rank order; then the whole vector, the same
      // operations in every CTA
      float al = 0.f;
      for (int q = 0; q < C; ++q) al += abox[ex % 3][q];
      float s2 = 0.f;
      for (int i = tid; i < n; i += kThreads) {
        const float2 a = bld<kWide>(x + i);
        float2 u = bld<kWide>(in + i);
        u.x -= al * a.x;
        u.y -= al * a.y;
        bst<kWide>(w + i, u);
        s2 += u.x * u.x + u.y * u.y;
      }
      const float bk = sqrtf(gs_block_sum<kThreads>(s2, part, half));
      probe.mark(kGsUpdate);
      const bool live = bk > kEpsBreakdown;
      // v_{k+1} in place, each thread on the entries it updated; the
      // CTA's rows also into V
      const bool keep = k + 1 < kmax;
      for (int i = tid; i < n; i += kThreads) {
        const float2 u = bld<kWide>(w + i);
        const float2 v =
            live ? make_float2(u.x / bk, u.y / bk) : make_float2(0.f, 0.f);
        bst<kWide>(w + i, v);
        if (keep && i >= e0 && i < e0 + nrow) V[(k + 1) * slot + i - e0] = v;
      }
      if (tid == 0) {
        alpha[k] = (double)al;
        beta[k] = (double)bk;
      }
      ++ex;
      __syncthreads();
      probe.mark(kGsNext);
      k_fin = k + 1;
      broke = bk < kEpsBreakdown;
      if (broke) break;
    }
    probe.rounds(
        tridiag_ground<kThreads>(alpha, beta, k_fin, y, piv[0], piv[1], hit));
    __syncthreads();
    probe.mark(kGsSolve);
    // the Ritz vector g = sum_j y_j v_j on this CTA's rows, pushed to
    // every CTA with its partial norm; then g / ||g|| whole
    {
      float2* g = box + (size_t)(ex % 3) * n;
      float2* in = kWide ? inbox + (size_t)(ex & 1) * n : g;  // the rows
      const int fan = kWide ? 1 : C;  // the copies of each row pushed
      float sg = 0.f;
      for (int idx = tid; idx < nrow * fan; idx += kThreads) {
        const int o = idx / fan, q = idx - o * fan;
        float pr = 0.f, pi = 0.f;
        for (int j = 0; j < k_fin; ++j) {
          const float yj = (float)y[j];
          const float2 a = V[j * slot + o];
          pr += yj * a.x;
          pi += yj * a.y;
        }
        if constexpr (kWide)
          __stcg(in + e0 + o, make_float2(pr, pi));
        else
          push(g, q, e0 + o, make_float2(pr, pi), C);
        if (q == 0) sg += pr * pr + pi * pi;
      }
      sg = gs_block_sum<kThreads>(sg, part, half);
      if (tid < C) push1(abox[ex % 3], tid, rank, sg, C);
      exchange(C);
      float s2 = 0.f;
      for (int q = 0; q < C; ++q) s2 += abox[ex % 3][q];
      nrm = sqrtf(s2);
      for (int i = tid; i < n; i += kThreads) {
        const float2 a = bld<kWide>(in + i);
        bst<kWide>(g + i, make_float2(a.x / nrm, a.y / nrm));
      }
      ++ex;
      __syncthreads();
      probe.mark(kGsRitz);
    }
    // ---- the energy Re <g|H g>: g = box[(ex + 2) % 3]
    {
      const float2* g = box + (size_t)((ex + 2) % 3) * n;
      gs_first_product<kThreads>(H, operand(g), T, stage, nc, M, row0, nh,
                                 r, resident != 0);
      __syncthreads();
      float er = 0.f;
      rows_times_rt_spread<kThreads, kWide>(
          T, rt, nc, nh, r, [&](int o, float2 hv, int ls, int) {
            const float2 v = bld<kWide>(g + e0 + o);
            if (ls == 0) er += v.x * hv.x + v.y * hv.y;
          });
      er = gs_block_sum<kThreads>(er, part, half);
      if (tid < C) push1(abox[ex % 3], tid, rank, er, C);
      exchange(C);
      float es = 0.f;
      for (int q = 0; q < C; ++q) es += abox[ex % 3][q];
      const double e = (double)es;
      ++ex;
      probe.mark(kGsEnergy);
      ++passes;
      iters += k_fin;
      breaks += broke ? 1 : 0;
      // the same bits in every CTA: all leave together
      if (!(fabs(e - e_prev) > kGsTol) || passes >= kGsMaxPasses) break;
      e_prev = e;
    }
  }
  {
    const float2* g = box + (size_t)((ex + 1) % 3) * n;
    for (int i = tid; i < nrow; i += kThreads)
      out[e0 + i] = bld<kWide>(g + e0 + i);
  }
  if (rank == 0 && tid == 0) {
    status[0] = passes;
    status[1] = iters;
    status[2] = breaks;
  }
  probe.store(cyc);
  // no CTA leaves while another may still address its shared memory
  cg::this_cluster().sync();
}

// Dynamic shared memory of one CTA, in bytes (cuda_lanczos.gs_smem_bytes)
size_t gs_smem(int nc, int M, int r, int kmax, int C, int wide, int resident,
               int v_shared) {
  const size_t Mc = (M + C - 1) / C, n = (size_t)M * r;
  return sizeof(float2) *
         ((wide ? n : 3 * n) + nc * Mc * r + (wide ? 0 : (size_t)nc * r * r) +
          (v_shared ? kmax * Mc * r : 0) +
          nc * Mc * ((resident ? M : kChunk) + 1));
}

// One launch of lanczos_gs_kernel<kThreads, kWide, Probe> as one cluster of
// C CTAs
template <int kThreads, bool kWide, class Probe>
cudaError_t gs_launch(int device, const float2* H, const float2* Rt,
                      const float2* v, float2* out, int* status,
                      float2* scratch, int nc, int M, int r, int kmax, int C,
                      int resident, int v_shared, cudaStream_t stream,
                      long long* cyc) {
  const int Mc = (M + C - 1) / C;
  return launch_cluster(
      device, lanczos_gs_kernel<kThreads, kWide, Probe>, C, kThreads,
      gs_smem(nc, M, r, kmax, C, kWide, resident, v_shared), stream, H, Rt,
      v, out, status, scratch, nc, M, r, kmax, Mc, resident, v_shared, cyc);
}

// The block sizes the kernel is built for (cuda_lanczos.GS_THREADS), each
// with both layouts
template <class Probe>
cudaError_t gs_dispatch(int device, int threads, const float2* H,
                        const float2* Rt, const float2* v, float2* out,
                        int* status, float2* scratch, int nc, int M, int r,
                        int kmax, int C, int wide, int resident, int v_shared,
                        cudaStream_t stream, long long* cyc) {
#define PYTDSCF_GS_LAUNCH(kThreads, kWide)                                  \
  gs_launch<kThreads, kWide, Probe>(device, H, Rt, v, out, status, scratch, \
                                    nc, M, r, kmax, C, resident, v_shared,  \
                                    stream, cyc)
  switch (threads) {
    case 128:
      return wide ? PYTDSCF_GS_LAUNCH(128, true) : PYTDSCF_GS_LAUNCH(128, false);
    case 512:
      return wide ? PYTDSCF_GS_LAUNCH(512, true) : PYTDSCF_GS_LAUNCH(512, false);
    default:
      return cudaErrorInvalidValue;
  }
#undef PYTDSCF_GS_LAUNCH
}

}  // namespace

// One cluster of C CTAs of `threads` threads (C = 1: one CTA), ceil(M / C)
// rows each (cuda_lanczos.gs_plan); scratch: C kmax ceil(M / C) r
// complex64 where the Krylov vectors' rows do not live in shared memory
// (v_shared = 0), then (C 3 + 2) M r for the wide layout's whole vectors
// (wide = 1), else unused.  cudaErrorInvalidClusterSize if the card cannot
// schedule such a cluster.
extern "C" int pytdscf_lanczos_gs_c64(int device, const void* H,
                                      const void* Rt, const void* v,
                                      void* out, void* status, void* scratch,
                                      int nc, int M, int r, int kmax, int C,
                                      int threads, int wide, int resident,
                                      int v_shared, void* stream) {
  if (kmax < 1 || kmax > kGsMaxK || C < 1 || C > kGsMaxC)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)gs_dispatch<GsNoProbe>(
      device, threads, static_cast<const float2*>(H),
      static_cast<const float2*>(Rt), static_cast<const float2*>(v),
      static_cast<float2*>(out), static_cast<int*>(status),
      static_cast<float2*>(scratch), nc, M, r, kmax, C, wide, resident,
      v_shared, static_cast<cudaStream_t>(stream), nullptr);
}
