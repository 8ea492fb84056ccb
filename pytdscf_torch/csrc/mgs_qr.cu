// Thin QR by modified Gram–Schmidt with two passes per column (MGS×2).
//
// Replaces the JAX package's mps/pallas_qr.py:mgs_qr_fused (its
// pl.pallas_call at :153).  Semantics are those of its mps/kernels.py:
// _mgs_qr, line by line:
//   scale = ||m||_F + 1e-30; for each column k: two Gram–Schmidt passes
//   against Q[:, :k] (coefficients c1, c2), R[:k, k] = c1 + c2,
//   nv = ||v||; a column with nv < 1e-7 * scale is dead: Q[:, k] is the
//   canonical vector e_{k mod N} orthogonalised twice, R[k, k] = 0 (where
//   that lies in the span of the earlier columns, its residual below the
//   float32 noise floor 16 eps sqrt N, the next e_j that does not:
//   tdvp_device.cuh, cuda_qr.completion_tol);
//   otherwise Q[:, k] = v / nv and R[k, k] = nv.
//
// Bound on the H100: neither bytes nor FLOPs (a (240, 30) factor is 58 KB
// and 0.35 MFLOP, a (1024, 64) one 0.5 MB and 67 MFLOP: about a microsecond
// at the card's rates) but the serial chain of r columns, each a handful of
// reductions over all N rows.  Three routes, chosen by the wrapper
// (cuda_qr.route):
//
//  * one block (mgs_qr_kernel, Q in shared memory): one block of 1024
//    threads (as site_step.cu runs the factor) stages m into Q once,
//    before the column loop (tdvp_device.cuh's mgs_stage: lane pairs read
//    16 contiguous bytes of a row and store them into two columns, Q typed
//    as shared memory: see mgs_qr_kernel), and runs mgs_factor on it in
//    place, four block barriers per live column (see the note there).
//    Every shape of the chain, pyrazine and the donor-acceptor models
//    takes it.
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
//    The completion's row lives in one CTA, R is written by rank 0,
//    and each CTA writes its own rows of the row-major Q.  This replaces one
//    block streaming the whole Q from L2 twice per pass, about 66 MB
//    through one SM's L2 port at (1024, 64) (2.14 ms on an H100).
//
//  * one block with Q in a device-memory scratch (the first kernel with
//    qwork given, the same factor over device memory at stride N), for a Q
//    beyond a cluster's shared memory (N * r above about 8 * 27k).  No
//    shape of today's paths takes it.
//
// Both factorisations are tdvp_device.cuh's: the one-block mgs_factor and
// the cluster layer's cluster_mgs_factor (site_step.cu runs mgs_factor
// inside its fused site update, on both of its routes).
//
// Layout: m (N, r) complex64 row-major (torch's contiguous layout, float2
// interleaved), Q (N, r) row-major, R (r, r) row-major.  N >= r >= 1.

#include <cuda_runtime.h>

#include "tdvp_device.cuh"

namespace {

constexpr int kThreads = 256;  // the cluster route's CTAs
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;  // CTAs of the cluster route (portable size)
constexpr int kBlock = 1024;  // threads of the one-block route

// The one-block factor of m into Q (column stride N) and its copy out:
// c1 (r) the first pass's coefficients, then c2 and c3 (r each).
__device__ __forceinline__ void mgs_qr_block(const float2* __restrict__ m,
                                             float2* __restrict__ q_out,
                                             float2* __restrict__ r_out,
                                             float2* Q, float2* c1, int N,
                                             int r, float* red) {
  mgs_stage(m, Q, N, N, r);
  __syncthreads();
  mgs_factor<kBlock>(Q, N, r_out, N, r, c1, c1 + r, c1 + 2 * r, red);
  // Q out row-major, in the staging order (two columns of a row to a lane
  // pair)
  for (int p = 0; p < r; p += 2)
    for (int i = threadIdx.x; i < 2 * N; i += kBlock) {
      const int j = p + (i & 1), n = i >> 1;
      if (j < r) q_out[(size_t)n * r + j] = Q[(size_t)j * N + n];
    }
}

// The one-block route: qwork nullptr (Q in shared memory) or an (r, N)
// device scratch (the device route).  One inlined copy of the factor per
// route, so that in the shared-memory copy every access of Q compiles to
// a shared-memory instruction: with one copy for both routes (Q a pointer
// to either) a (240, 30) launch took 8 % longer, and staging m by one
// 8-byte cp.async an entry beat these plain loads (scripts/chain_step.py).
__global__ void __launch_bounds__(kBlock)
mgs_qr_kernel(const float2* __restrict__ m, float2* __restrict__ q_out,
              float2* __restrict__ r_out, float2* qwork, int N, int r) {
  extern __shared__ float2 smem[];
  __shared__ float red[2 * kBlock / 32];
  if (qwork != nullptr)
    mgs_qr_block(m, q_out, r_out, qwork, smem, N, r, red);
  else
    mgs_qr_block(m, q_out, r_out, smem, smem + (size_t)N * r, N, r, red);
}

// ------------------------------------------------------- the cluster route

// Launched as one cluster of kCluster CTAs.  Shared memory per CTA
// (cuda_qr.smem_bytes(N, r, "cluster")): Q's Nc rows (Nc, rp), holding m's
// columns until each becomes Q's; v and e (Nc each); c1, c2, c3 (r each);
// the strip partials (kStrips r); the two inboxes (2 kCluster r).
__global__ void __launch_bounds__(kThreads)
mgs_qr_cluster_kernel(const float2* __restrict__ m, float2* __restrict__ q_out,
                      float2* __restrict__ r_out, int N, int r, int Nc) {
  extern __shared__ float2 smem[];
  __shared__ float red[kWarps];
  float2* Q = smem;
  float2* v = Q + (size_t)Nc * (r | 1);
  float2* e = v + Nc;
  float2* c1 = e + Nc;
  float2* c2 = c1 + r;
  float2* c3 = c2 + r;
  float2* part = c3 + r;
  ClusterRows c = cluster_rows(N, Nc, r, part, part + kStrips * r);
  const int tid = threadIdx.x;

  for (int i = tid; i < c.nh * r; i += kThreads) {
    const int n = i / r, j = i - n * r;
    Q[n * c.rp + j] = m[(size_t)(c.row0 + n) * r + j];
  }
  cluster_mgs_factor<kThreads, kCluster>(c, Q, c.rank == 0 ? r_out : nullptr,
                                         N, v, e, c1, c2, c3, red);
  for (int i = tid; i < c.nh * r; i += kThreads) {
    const int n = i / r, j = i - n * r;
    q_out[(size_t)(c.row0 + n) * r + j] = Q[n * c.rp + j];
  }
  // no CTA leaves while another may still address its shared memory
  cg::this_cluster().sync();
}

}  // namespace

// qwork: nullptr (Q in shared memory) or an (r, N) complex64 scratch.
// Dynamic shared memory (cuda_qr.smem_bytes(N, r, "block" or "device")):
// Q unless qwork is given, and three coefficient columns.
extern "C" int pytdscf_mgs_qr_c64(int device, const void* m, void* q,
                                  void* r_out, void* qwork, int N, int r,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t q_smem = qwork != nullptr ? 0 : (size_t)N * r;
  const size_t smem = sizeof(float2) * (q_smem + 3 * (size_t)r);
  err = cudaFuncSetAttribute(mgs_qr_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  mgs_qr_kernel<<<1, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
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
