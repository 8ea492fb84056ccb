// Thin QR by modified Gram–Schmidt with two passes per column (MGS×2).
//
// Replaces the JAX package's mps/pallas_qr.py:mgs_qr_fused (its
// pl.pallas_call at :153).  Semantics are those of its mps/kernels.py:
// _mgs_qr, line by line:
//   scale = ||m||_F + 1e-30; for each column k: two Gram–Schmidt passes
//   against Q[:, :k] (coefficients c1, c2), R[:k, k] = c1 + c2,
//   nv = ||v||; a column with nv < 1e-7 * scale is dead: Q[:, k] is the
//   canonical vector e_{k mod N} orthogonalised twice, R[k, k] = 0;
//   otherwise Q[:, k] = v / nv and R[k, k] = nv.
//
// Bound on the H100: neither bytes nor FLOPs (a (240, 30) factor is 58 KB
// and 0.35 MFLOP, a (1024, 64) one 0.5 MB and 67 MFLOP: about a microsecond
// at the card's rates) but the serial chain of r columns, each a handful of
// reductions over all N rows.  Three routes, chosen by the wrapper
// (cuda_qr.route):
//
//  * one block (mgs_qr_kernel, Q in shared memory): one block of 256
//    threads keeps Q in dynamic shared memory, column-major (Q[j * N + n]),
//    so that the dot products <Q_j|v> (one warp per column j, lanes over n)
//    and the update v -= Q c (threads over n) read consecutive banks.  Every
//    chain shape takes it, (240, 30) included.
//
//  * one thread-block cluster (mgs_qr_cluster_kernel), for a Q that does
//    not fit one block but fits kCluster = 8 (the portable cluster size):
//    the radical pair's (1024, 64) edge gauge, 512 KB of Q, 64 KB per CTA.
//    Each CTA holds Nc = ceil(N / 8) consecutive rows of m, which become its
//    rows of Q column by column, in its own shared memory (row-major with
//    an odd row stride: conflict-free for the dot products, threads over
//    columns, and for the update, threads over rows).  Per reduction
//    (a Gram–Schmidt pass's k coefficients, ||m||, ||v||, ||e||) each CTA
//    computes its partial over its rows and stores it into slot [rank] of
//    every CTA's inbox (distributed shared memory); after one cluster
//    barrier each CTA adds the 8 slots in rank order 0..7.  The same float32
//    operations in the same order run in every CTA, so all of them get the
//    same coefficients and the same dead/live decision bit for bit: they
//    cannot diverge at a barrier or build inconsistent columns.  A column
//    costs three cluster barriers (two passes and ||v||), six if it is dead.
//    The completion's row k mod N lives in one CTA, R is written by rank 0,
//    and each CTA writes its own rows of the row-major Q.  This replaces one
//    block streaming the whole Q from L2 twice per pass, about 66 MB
//    through one SM's L2 port at (1024, 64) (2.14 ms on an H100).
//
//  * one block with Q in a device-memory scratch (the first kernel with
//    qwork given), for a Q beyond a cluster's shared memory (N * r above
//    about 8 * 27k).  No shape of the chain or the radical pair takes it.
//
// The one-block factorisation is tdvp_device.cuh's mgs_factor (site_step.cu
// runs the same one inside its fused site update); the cluster route has its
// own device functions below.
//
// Layout: m (N, r) complex64 row-major (torch's contiguous layout, float2
// interleaved), Q (N, r) row-major, R (r, r) row-major.  N >= r >= 1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tdvp_device.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;  // CTAs of the cluster route (portable size)

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

// ------------------------------------------------------- the cluster route

constexpr int kStrips = 4;                  // row strips of the dot products
constexpr int kStripCols = kThreads / kStrips;  // columns per strip round

// One CTA's view of the cluster: its rank, its rows and its inboxes.  A
// cluster-wide sum fills the inbox of the current parity and flips it; two
// alternate, so a CTA writes the next sum's partials only after passing the
// barrier of the previous one, which every CTA reaches only after it has
// read the inbox that is about to be reused.
struct ClusterRows {
  int rank;
  int row0;       // first row of m held here
  int nh;         // rows held here (Nc, fewer in the last CTA)
  int r;
  int rp;         // row stride of Q here: r rounded up to an odd number
  float2* part;   // [kStrips][r] strip partials of the dot products
  float2* inbox;  // [2][kCluster][r]
  int parity;

  // [kCluster][r] inbox of the current sum
  __device__ float2* box() const { return inbox + parity * kCluster * r; }
};

// Cluster-wide sum of one float per CTA (`part`, the same in every thread
// of the CTA), returned to every thread of every CTA with the same bits.
__device__ float cluster_sum(ClusterRows& c, float part) {
  float2* box = c.box();
  if (threadIdx.x < kCluster)
    cg::this_cluster().map_shared_rank(box, threadIdx.x)[c.rank * c.r] =
        make_float2(part, 0.f);
  cg::this_cluster().sync();
  float t = box[0].x;
  for (int q = 1; q < kCluster; ++q) t += box[q * c.r].x;
  c.parity ^= 1;
  return t;
}

// ||x||^2 over the cluster's rows of x (this CTA's nh entries).
__device__ float cluster_norm2(ClusterRows& c, const float2* x, float* red) {
  float s = 0.f;
  for (int n = threadIdx.x; n < c.nh; n += kThreads) {
    const float2 a = x[n];
    s += a.x * a.x + a.y * a.y;
  }
  return cluster_sum(c, block_sum<kThreads>(s, red));
}

// One Gram–Schmidt pass of x (this CTA's rows) against Q[:, :k] over all N
// rows: the coefficients cf[j] = <Q_j|x> (partials over each CTA's rows,
// summed in rank order), then x -= sum_j Q_j cf[j] on this CTA's rows.
// Q is row-major with an odd row stride, so that both the dot products
// (threads over j, one row strip per warp) and the update (threads over n)
// read distinct banks.
__device__ void cluster_gs_pass(ClusterRows& c, const float2* Q, float2* x,
                                float2* cf, int k) {
  const int strip = threadIdx.x / kStripCols, jt = threadIdx.x % kStripCols;
  const int len = (c.nh + kStrips - 1) / kStrips;
  const int n0 = strip * len, n1 = min(c.nh, n0 + len);
  for (int j = jt; j < k; j += kStripCols) {
    float re = 0.f, im = 0.f;
    for (int n = n0; n < n1; ++n) {
      const float2 a = Q[n * c.rp + j], b = x[n];
      re += a.x * b.x + a.y * b.y;  // conj(a) * b
      im += a.x * b.y - a.y * b.x;
    }
    c.part[strip * c.r + j] = make_float2(re, im);
  }
  __syncthreads();
  float2* box = c.box();
  for (int j = threadIdx.x; j < k; j += kThreads) {
    float2 t = c.part[j];
    for (int s = 1; s < kStrips; ++s) {
      t.x += c.part[s * c.r + j].x;
      t.y += c.part[s * c.r + j].y;
    }
    for (int q = 0; q < kCluster; ++q)
      cg::this_cluster().map_shared_rank(box, q)[c.rank * c.r + j] = t;
  }
  cg::this_cluster().sync();
  for (int j = threadIdx.x; j < k; j += kThreads) {
    float2 t = box[j];
    for (int q = 1; q < kCluster; ++q) {
      t.x += box[q * c.r + j].x;
      t.y += box[q * c.r + j].y;
    }
    cf[j] = t;
  }
  c.parity ^= 1;
  __syncthreads();
  for (int n = threadIdx.x; n < c.nh; n += kThreads) {
    float sr = 0.f, si = 0.f;
    for (int j = 0; j < k; ++j) {
      const float2 a = Q[n * c.rp + j], b = cf[j];
      sr += a.x * b.x - a.y * b.y;
      si += a.x * b.y + a.y * b.x;
    }
    const float2 xv = x[n];
    x[n] = make_float2(xv.x - sr, xv.y - si);
  }
  __syncthreads();
}

// Launched as one cluster of kCluster CTAs.  Shared memory per CTA
// (cuda_qr.smem_bytes(N, r, "cluster")): Q's Nc rows (Nc, rp), holding m's
// columns until each becomes Q's; v and e (Nc each); c1, c2, c3 (r each);
// the strip partials (kStrips r); the two inboxes (2 kCluster r).
__global__ void __launch_bounds__(kThreads)
mgs_qr_cluster_kernel(const float2* __restrict__ m, float2* __restrict__ q_out,
                      float2* __restrict__ r_out, int N, int r, int Nc) {
  extern __shared__ float2 smem[];
  __shared__ float red[kWarps];
  ClusterRows c;
  c.rank = (int)cg::this_cluster().block_rank();
  c.row0 = c.rank * Nc;
  c.nh = max(0, min(Nc, N - c.row0));
  c.r = r;
  c.rp = r | 1;
  float2* Q = smem;
  float2* v = Q + (size_t)Nc * c.rp;
  float2* e = v + Nc;
  float2* c1 = e + Nc;
  float2* c2 = c1 + r;
  float2* c3 = c2 + r;
  c.part = c3 + r;
  c.inbox = c.part + kStrips * r;
  c.parity = 0;
  const int tid = threadIdx.x;

  float s = 0.f;
  for (int i = tid; i < c.nh * r; i += kThreads) {
    const int n = i / r, j = i - n * r;
    const float2 a = m[(size_t)(c.row0 + n) * r + j];
    Q[n * c.rp + j] = a;
    s += a.x * a.x + a.y * a.y;
  }
  // every CTA of the cluster runs before any addresses another's memory
  cg::this_cluster().sync();
  const float scale =
      sqrtf(cluster_sum(c, block_sum<kThreads>(s, red))) + 1e-30f;

  for (int k = 0; k < r; ++k) {
    // column k of Q, which still holds column k of m
    for (int n = tid; n < c.nh; n += kThreads) v[n] = Q[n * c.rp + k];
    __syncthreads();
    if (k > 0) {  // (against no columns a pass leaves v as it is)
      cluster_gs_pass(c, Q, v, c1, k);
      cluster_gs_pass(c, Q, v, c2, k);
    }
    const float nv = sqrtf(cluster_norm2(c, v, red));
    const bool bad = nv < kRankTol * scale;  // the same in every CTA
    if (bad) {
      const int hot = k % N - c.row0;  // row of e_{k mod N} here, if any
      for (int n = tid; n < c.nh; n += kThreads)
        e[n] = make_float2(n == hot ? 1.f : 0.f, 0.f);
      __syncthreads();
      if (k > 0) {
        cluster_gs_pass(c, Q, e, c3, k);
        cluster_gs_pass(c, Q, e, c3, k);
      }
      const float ne = sqrtf(cluster_norm2(c, e, red)) + 1e-30f;
      for (int n = tid; n < c.nh; n += kThreads)
        Q[n * c.rp + k] = make_float2(e[n].x / ne, e[n].y / ne);
    } else {
      for (int n = tid; n < c.nh; n += kThreads)
        Q[n * c.rp + k] = make_float2(v[n].x / nv, v[n].y / nv);
    }
    if (c.rank == 0) {  // column k of R, whole
      for (int j = tid; j < r; j += kThreads) {
        float2 rv = make_float2(0.f, 0.f);
        if (j < k) rv = make_float2(c1[j].x + c2[j].x, c1[j].y + c2[j].y);
        if (j == k && !bad) rv = make_float2(nv, 0.f);
        r_out[(size_t)j * r + k] = rv;
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < c.nh * r; i += kThreads) {
    const int n = i / r, j = i - n * r;
    q_out[(size_t)(c.row0 + n) * r + j] = Q[n * c.rp + j];
  }
  // no CTA leaves while another may still address its shared memory
  cg::this_cluster().sync();
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

// The cluster route: one cluster of 8 CTAs, ceil(N / 8) rows each
// (cuda_qr.smem_bytes(N, r, "cluster") bytes of shared memory per CTA).
extern "C" int pytdscf_mgs_qr_cluster_c64(int device, const void* m, void* q,
                                          void* r_out, int N, int r,
                                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int Nc = (N + kCluster - 1) / kCluster;
  const size_t smem =
      sizeof(float2) * ((size_t)Nc * (r | 1) + 2 * (size_t)Nc +
                        (3 + kStrips + 2 * kCluster) * (size_t)r);
  err = cudaFuncSetAttribute(mgs_qr_cluster_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mgs_qr_cluster_kernel,
                           static_cast<const float2*>(m),
                           static_cast<float2*>(q),
                           static_cast<float2*>(r_out), N, r, Nc);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Message of a CUDA error code returned by any entry point of this library.
extern "C" const char* pytdscf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
