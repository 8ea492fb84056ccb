// bf16x3 four-tensor chain: the environment transfer at env_precision
// "high" and the exact-prefix Krylov matvec at matvec_precision "high".
//
// Replaces the JAX package's mps/pallas_renorm.py:_renorm3_pallas (its
// pl.pallas_call at :223, Pallas body _renorm3_kernel).  In H_eff roles:
//
//   T1[k,j,x,c] = sum_r   psi[k,j,r] * R[x,c,r]          j < din
//   T2[k,i,a,x] = sum_j,c W[a,i,j,c] * T1[k,j,x,c]       i < dout
//   out[b,i,x]  = sum_a,k L[b,a,k] * T2[k,i,a,x]
//
// The environment transfers are the same chain with the roles permuted
// (cuda_renorm.py): L'[o,c,p] takes psi = L (b,a,k), R = A_ket (p,j,k),
// L = conj(A_bra) (o,i,b) and W (i,c,a,j), so there din and dout are the
// MPO widths and wl = wr the physical dimension.  K_eff is the chain with
// din = dout = 1 and W the identity over the MPO bond, which leaves T2 =
// T1 (HAS_W = false below: the copy is exactly what the identity gives,
// since T1's hi + lo is already a 16-bit value).
//
// Rounding points (those of _renorm3_kernel; the plain version is
// kernels.chain3_plain):
//   * every operand arrives split, each complex entry as four bf16 values
//     (re_hi, im_hi, re_lo, im_lo) with hi = bf16(x) and lo = bf16(x - hi),
//     both rounded to nearest even (the wrapper builds them once per call);
//   * T1 and T2 are accumulated in float32 and split on chip by truncation:
//     hi = the float32 value with its low 16 bits cleared, lo = bf16(x - hi);
//   * every real product x*y is the three bf16 products xh*yh + xh*yl +
//     xl*yh with float32 accumulation (lo*lo is dropped);
//   * the output is complex64.
// Only the order of the float32 sums differs from the plain version.
//
// What bounds it on the H100: arithmetic.  At the chi=1024 bulk (the
// environment transfer: B=K=X=Rd=1024, w=8, d=4) the chain is two 274.9
// GFLOP stages and an 8.6 GFLOP W mix; bf16x3 triples that to 1.675 TFLOP
// of bf16 products, at least 1.69 ms at the card's 989 TFLOP/s dense bf16
// tensor-core rate; its 0.2 GB of operands and output take under 0.1 ms
// at 3.35 TB/s.  What the design does about it: the two large stages (T1
// over r, the output over (a,k)) run on the tensor cores, as warp-level
// mma.sync m16n8k16 bf16 products with float32 accumulators, twelve per
// complex product of a 16x8 tile and a k16 step (four real products, three
// passes each); the small W mix runs as float32 FMAs (two per real product:
// xh*(yh + yl) + xl*yh, where yh + yl is exact in float32 and an FMA rounds
// only its sum, so the three products enter exactly).  The chain
// intermediates T1 and T2 (256 MB each at the bulk, as complex64) never
// leave the SM.  A block owns one x tile and a fixed group of consecutive
// k tiles; per k tile it computes its T1 tile (at most 128 rows (k,j) x
// 64 columns (x,c)) from staged psi and R chunks, then its T2 tile from T1
// and W held in shared memory, stored as four bf16 planes (hi and lo of
// re and im), then streams L through shared memory and adds its partial
// out[:, :, x tile] into its group's scratch slot.  The slot is touched by
// this block alone, so the k tiles of a group are summed in a fixed order;
// a second kernel sums the G group slots in order, so a launch repeats its
// result bit for bit.  G is about 264 / (x tiles), so the scratch stays a
// few copies of the output (335 MB at the bulk) at any chi.  Not done
// yet: wgmma, TMA and a pipelined operand ring (this version stages each
// 32-wide k chunk between two barriers, its loads issued before the first).
//
// Layouts (row-major; an operand entry is an hl: two bf16 (re, im) pairs):
//   psi (K, din, Rd) | L (B, wl, K) | W (wl, dout, din, wr) | R (X, wr, Rd)
//   part (G, B, dout, X) complex64 scratch | out (B, dout, X) complex64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;             // 16 warps: 8 row x 2 column groups
constexpr int kRows1 = 128;               // T1 rows (k, j) of a tile
constexpr int kCols1 = 64;                // T1 columns (x, c) of a tile
constexpr int kT1 = kRows1 * kCols1;      // entries of a T1 tile
constexpr int kCols3 = 128;               // most T2 columns (i, x)
constexpr int kT2 = 10240;                // entries of a padded T2 plane
constexpr int kK = 16;                    // k of one mma step
constexpr int kC = 32;                    // k of one staged chunk
constexpr int kS = kC + 8;                // padded row of a staged chunk
constexpr int kBRows = 128;               // output rows b per phase-3 pass
constexpr int kMaxW = 1024;               // entries of W in shared memory
constexpr uint32_t kNeg = 0x80008000u;    // flips the sign of both bf16

static_assert(kThreads == 32 * 16, "16 warps");

// one complex operand entry, split: h = (re, im) hi, l = (re, im) lo
struct __align__(8) hl {
  __nv_bfloat162 h, l;
};

// the y side of an FMA product: (hi + lo, hi), the sum exact in float32
__device__ __forceinline__ float4 as_y(hl v) {
  const float2 h = __bfloat1622float2(v.h), l = __bfloat1622float2(v.l);
  return make_float4(h.x + l.x, h.y + l.y, h.x, h.y);
}

// the x side of an FMA product: (hi.re, hi.im, lo.re, lo.im)
__device__ __forceinline__ float4 as_x(hl v) {
  const float2 h = __bfloat1622float2(v.h), l = __bfloat1622float2(v.l);
  return make_float4(h.x, h.y, l.x, l.y);
}

// float32 -> (hi, lo) by truncation of the low 16 bits (_split_hilo)
__device__ __forceinline__ hl split_trunc(float2 v) {
  const float hx = __uint_as_float(__float_as_uint(v.x) & 0xffff0000u);
  const float hy = __uint_as_float(__float_as_uint(v.y) & 0xffff0000u);
  hl o;
  o.h = __floats2bfloat162_rn(hx, hy);  // exact: hx, hy are bf16 values
  o.l = __floats2bfloat162_rn(v.x - hx, v.y - hy);
  return o;
}

// acc += x * y (complex) at bf16x3 by FMA: per real product xh*(yh+yl) +
// xl*yh
__device__ __forceinline__ void cmac3(float2& acc, float4 x, float4 y) {
  acc.x = fmaf(x.x, y.x, acc.x);
  acc.x = fmaf(-x.y, y.y, acc.x);
  acc.x = fmaf(x.z, y.z, acc.x);
  acc.x = fmaf(-x.w, y.w, acc.x);
  acc.y = fmaf(x.x, y.y, acc.y);
  acc.y = fmaf(x.y, y.x, acc.y);
  acc.y = fmaf(x.z, y.w, acc.y);
  acc.y = fmaf(x.w, y.z, acc.y);
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a * b: one m16n8k16 bf16 product with float32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (16 rows from m0, k16 from k0) of one bf16 plane with rows of
// `stride` elements (k contiguous)
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* plane, int stride,
                                       int m0, int k0, int g, int t) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(plane);
  const int w = stride / 2, c = (k0 >> 1) + t;
  a[0] = p[(m0 + g) * w + c];
  a[1] = p[(m0 + g + 8) * w + c];
  a[2] = p[(m0 + g) * w + c + 4];
  a[3] = p[(m0 + g + 8) * w + c + 4];
}

// B fragment (k16 from k0 x 8 columns from n0) of a plane stored by column
// (rows n, k contiguous)
__device__ __forceinline__ void load_b(uint32_t (&b)[2],
                                       const __nv_bfloat16* plane, int stride,
                                       int n0, int k0, int g, int t) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(plane);
  const int w = stride / 2, c = (k0 >> 1) + t;
  b[0] = p[(n0 + g) * w + c];
  b[1] = p[(n0 + g) * w + c + 4];
}

// re, im (16x8 tiles) += A * B, complex at bf16x3.  a: planes (re_h, im_h,
// re_l, im_l) of A; b: the same of B.
__device__ __forceinline__ void cmma3(float (&re)[4], float (&im)[4],
                                      const uint32_t (&a)[4][4],
                                      const uint32_t (&b)[4][2]) {
  // re: Are*Bre - Aim*Bim
  mma(re, a[0], b[0][0], b[0][1]);
  mma(re, a[0], b[2][0], b[2][1]);
  mma(re, a[2], b[0][0], b[0][1]);
  mma(re, a[1], b[1][0] ^ kNeg, b[1][1] ^ kNeg);
  mma(re, a[1], b[3][0] ^ kNeg, b[3][1] ^ kNeg);
  mma(re, a[3], b[1][0] ^ kNeg, b[1][1] ^ kNeg);
  // im: Are*Bim + Aim*Bre
  mma(im, a[0], b[1][0], b[1][1]);
  mma(im, a[0], b[3][0], b[3][1]);
  mma(im, a[2], b[1][0], b[1][1]);
  mma(im, a[1], b[0][0], b[0][1]);
  mma(im, a[1], b[2][0], b[2][1]);
  mma(im, a[3], b[0][0], b[0][1]);
}

// stores two consecutive k entries (x0, x1) of one row into the four
// planes of a staged chunk (plane stride `ps` elements)
__device__ __forceinline__ void stage_pair(__nv_bfloat16* planes, int ps,
                                           int off, hl x0, hl x1) {
  uint32_t* p = reinterpret_cast<uint32_t*>(planes + off);
  const int w = ps / 2;
  p[0] = pack(x0.h.x, x1.h.x);
  p[w] = pack(x0.h.y, x1.h.y);
  p[2 * w] = pack(x0.l.x, x1.l.x);
  p[3 * w] = pack(x0.l.y, x1.l.y);
}

__device__ __forceinline__ hl hl_zero() {
  hl z;
  z.h = __floats2bfloat162_rn(0.f, 0.f);
  z.l = z.h;
  return z;
}

constexpr int kStage1 = 4 * (kRows1 + kCols1) * kS;  // psi and R chunks
constexpr int kStage3 = 4 * kBRows * kS;             // an L chunk
constexpr int kStage = kStage1 > kStage3 ? kStage1 : kStage3;
// (k, k+1) pairs each thread stages per chunk in phase 1 and in phase 3
constexpr int kItems1 = (kRows1 + kCols1) * (kC / 2) / kThreads;
constexpr int kItems3 = kBRows * (kC / 2) / kThreads;
static_assert(kItems1 * kThreads == (kRows1 + kCols1) * (kC / 2), "");
static_assert(kItems3 * kThreads == kBRows * (kC / 2), "");

size_t smem_bytes(int nW) {
  return sizeof(float4) * (size_t)nW + sizeof(hl) * kT1 +
         sizeof(__nv_bfloat16) * (size_t)(kStage + 4 * kT2);
}

template <bool HAS_W>
__global__ void __launch_bounds__(kThreads, 1)
chain3_kernel(const hl* __restrict__ psi, const hl* __restrict__ L,
              const hl* __restrict__ W, const hl* __restrict__ R,
              float2* __restrict__ part, int B, int K, int X, int Rd,
              int din, int dout, int wl, int wr, int Tk, int Tx, int nkt,
              int G) {
  extern __shared__ float4 smem_raw[];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;      // mma fragment coordinates
  const int wm = warp / 2, wn = warp % 2;    // warp tile: 16 rows x 32 cols
  const int x0 = blockIdx.x * Tx;
  const int grp = blockIdx.y;
  // this block's k tiles: a fixed, contiguous group
  const int kt0 = (int)((long)grp * nkt / G);
  const int kt1 = (int)((long)(grp + 1) * nkt / G);
  const int M1 = Tk * din;                   // T1 rows (k, j)
  const int N1 = Tx * wr;                    // T1 columns (x, c)
  const int K3 = wl * Tk;                    // T2 rows (a, k)
  const int K3p = (K3 + kC - 1) / kC * kC;   // ... padded to the chunk
  const int N3 = dout * Tx;                  // T2 columns (i, x)
  const int N3p = (N3 + 7) / 8 * 8;          // ... padded to the mma n
  const int S2 = K3p + 8;                    // padded T2 plane row
  const int nW = HAS_W ? wl * dout * din * wr : 0;

  float4* Ws = smem_raw;                                  // W (y side)
  hl* T1s = reinterpret_cast<hl*>(Ws + nW);               // [M1][N1]
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(T1s + kT1);
  __nv_bfloat16* Pp = stage;                              // [4][128][kS]
  __nv_bfloat16* Rp = stage + 4 * kRows1 * kS;            // [4][64][kS]
  __nv_bfloat16* Lp = stage;                              // [4][128][kS]
  __nv_bfloat16* T2p = stage + kStage;                    // [4][N3p][S2]
  float2* slot = part + (size_t)grp * B * dout * X;

  if (HAS_W) {
    for (int e = tid; e < nW; e += kThreads) Ws[e] = as_y(W[e]);
  }
  const long rows_psi = (long)K * din;
  const long rows_R = (long)X * wr;
  const hl zero = hl_zero();

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * Tk;

    // ---- phase 1: T1 = psi . R over r on the tensor cores.  Rows and
    // columns out of range, and r past Rd, are staged as zeros, so their
    // T1 entries come out exactly zero.
    float re1[4][4], im1[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) re1[j][q] = im1[j][q] = 0.f;
    for (int r0 = 0; r0 < Rd; r0 += kC) {
      // the chunk's loads are all issued before the barrier, so they
      // overlap the other warps' work on the previous chunk
      hl v[kItems1][2];
#pragma unroll
      for (int q = 0; q < kItems1; ++q) {
        const int e = tid + q * kThreads;
        const int m = e / (kC / 2), r = r0 + 2 * (e % (kC / 2));
        v[q][0] = v[q][1] = zero;
        if (m < kRows1) {
          const long gp = (long)k0 * din + m;
          if (m < M1 && gp < rows_psi) {
            if (r < Rd) v[q][0] = psi[gp * Rd + r];
            if (r + 1 < Rd) v[q][1] = psi[gp * Rd + r + 1];
          }
        } else {
          const int n = m - kRows1;
          const long gr = (long)x0 * wr + n;
          if (n < N1 && gr < rows_R) {
            if (r < Rd) v[q][0] = R[gr * Rd + r];
            if (r + 1 < Rd) v[q][1] = R[gr * Rd + r + 1];
          }
        }
      }
      __syncthreads();  // the previous chunk (or phase 3's L) is consumed
#pragma unroll
      for (int q = 0; q < kItems1; ++q) {
        const int e = tid + q * kThreads;
        const int m = e / (kC / 2), rr = 2 * (e % (kC / 2));
        if (m < kRows1)
          stage_pair(Pp, kRows1 * kS, m * kS + rr, v[q][0], v[q][1]);
        else
          stage_pair(Rp, kCols1 * kS, (m - kRows1) * kS + rr, v[q][0],
                     v[q][1]);
      }
      __syncthreads();
      if (wm * 16 < M1) {
#pragma unroll
        for (int kk = 0; kk < kC; kk += kK) {
          uint32_t a[4][4];
#pragma unroll
          for (int pl = 0; pl < 4; ++pl)
            load_a(a[pl], Pp + pl * kRows1 * kS, kS, wm * 16, kk, g, t);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n0 = wn * 32 + j * 8;
            if (n0 >= N1) continue;
            uint32_t b[4][2];
#pragma unroll
            for (int pl = 0; pl < 4; ++pl)
              load_b(b[pl], Rp + pl * kCols1 * kS, kS, n0, kk, g, t);
            cmma3(re1[j], im1[j], a, b);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = wm * 16 + g + (q >= 2 ? 8 : 0);
        const int n = wn * 32 + j * 8 + 2 * t + (q & 1);
        if (m < M1 && n < N1)
          T1s[m * N1 + n] = split_trunc(make_float2(re1[j][q], im1[j][q]));
      }
    }
    __syncthreads();

    // ---- phase 2: T2[(a,k)][(i,x)] from T1[(k,j)][(x,c)], split again
    // into the four planes, stored by column (i,x) for phase 3's B side;
    // the padding past K3 and N3 is zero
    __nv_bfloat16* T2re_h = T2p;
    const int ps2 = N3p * S2;
    if (HAS_W) {
      const int dw = din * wr;
      const int n2 = wl * dout * Tk * Tx;
      for (int e = tid; e < n2; e += kThreads) {
        const int x = e % Tx, rest = e / Tx;
        const int k = rest % Tk, ai = rest / Tk;  // ai = a * dout + i
        const float4* wrow = Ws + ai * dw;
        float2 acc = make_float2(0.f, 0.f);
        for (int j = 0; j < din; ++j) {
          const hl* t1 = T1s + (k * din + j) * N1 + x * wr;
          for (int c = 0; c < wr; ++c) cmac3(acc, as_x(t1[c]), wrow[j * wr + c]);
        }
        const int a = ai / dout, i = ai % dout;
        const hl v = split_trunc(acc);
        const int off = (i * Tx + x) * S2 + a * Tk + k;
        T2re_h[off] = v.h.x;
        T2re_h[ps2 + off] = v.h.y;
        T2re_h[2 * ps2 + off] = v.l.x;
        T2re_h[3 * ps2 + off] = v.l.y;
      }
    } else {
      // K_eff: d = 1 and W the identity, T2[(a,k)][x] = T1[k][(x,a)]
      for (int e = tid; e < Tk * Tx * wr; e += kThreads) {
        const int k = e / (Tx * wr), rem = e % (Tx * wr);
        const int x = rem / wr, a = rem % wr;
        const hl v = T1s[k * N1 + x * wr + a];
        const int off = x * S2 + a * Tk + k;
        T2re_h[off] = v.h.x;
        T2re_h[ps2 + off] = v.h.y;
        T2re_h[2 * ps2 + off] = v.l.x;
        T2re_h[3 * ps2 + off] = v.l.y;
      }
    }
    {
      const __nv_bfloat16 z = __float2bfloat16_rn(0.f);
      for (int e = tid; e < N3p * S2; e += kThreads) {
        const int n = e / S2, kk = e % S2;
        if (n >= N3 || kk >= K3) {
#pragma unroll
          for (int pl = 0; pl < 4; ++pl) T2re_h[pl * ps2 + e] = z;
        }
      }
    }

    // ---- phase 3: slot[b, (i,x)] (+)= sum_(a,k) L[b,a,k] T2[(a,k)][(i,x)]
    // on the tensor cores, kBRows rows of b by 64 columns at a time
    for (int n0 = 0; n0 < N3; n0 += 64) {
      for (int b0 = 0; b0 < B; b0 += kBRows) {
        float re3[4][4], im3[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) re3[j][q] = im3[j][q] = 0.f;
        for (int kk0 = 0; kk0 < K3p; kk0 += kC) {
          hl v[kItems3][2];
#pragma unroll
          for (int q = 0; q < kItems3; ++q) {
            const int e = tid + q * kThreads;
            const int b = b0 + e / (kC / 2);
            const int kidx = kk0 + 2 * (e % (kC / 2));
            v[q][0] = v[q][1] = zero;
            if (b < B) {
              if (kidx < K3 && k0 + kidx % Tk < K)
                v[q][0] = L[((long)b * wl + kidx / Tk) * K + k0 + kidx % Tk];
              if (kidx + 1 < K3 && k0 + (kidx + 1) % Tk < K)
                v[q][1] = L[((long)b * wl + (kidx + 1) / Tk) * K + k0 +
                            (kidx + 1) % Tk];
            }
          }
          __syncthreads();  // T2 is complete / the previous L chunk consumed
#pragma unroll
          for (int q = 0; q < kItems3; ++q) {
            const int e = tid + q * kThreads;
            stage_pair(Lp, kBRows * kS,
                       (e / (kC / 2)) * kS + 2 * (e % (kC / 2)), v[q][0],
                       v[q][1]);
          }
          __syncthreads();
          if (b0 + wm * 16 < B) {
#pragma unroll
            for (int kk = 0; kk < kC; kk += kK) {
              uint32_t a[4][4];
#pragma unroll
              for (int pl = 0; pl < 4; ++pl)
                load_a(a[pl], Lp + pl * kBRows * kS, kS, wm * 16, kk, g, t);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int nt = n0 + wn * 32 + j * 8;
                if (nt >= N3) continue;
                uint32_t b[4][2];
#pragma unroll
                for (int pl = 0; pl < 4; ++pl)
                  load_b(b[pl], T2p + pl * ps2, S2, nt, kk0 + kk, g, t);
                cmma3(re3[j], im3[j], a, b);
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int b = b0 + wm * 16 + g + (q >= 2 ? 8 : 0);
            const int n = n0 + wn * 32 + j * 8 + 2 * t + (q & 1);
            if (b >= B || n >= N3) continue;
            const int ii = n / Tx, xg = x0 + n % Tx;
            if (xg >= X) continue;
            // this thread alone writes this entry of the slot, at every k
            // tile of the group: the group's sum runs in k-tile order
            float2* p = slot + ((size_t)b * dout + ii) * X + xg;
            float2 v = make_float2(re3[j][q], im3[j][q]);
            if (kt != kt0) {
              const float2 s = *p;
              v.x += s.x;
              v.y += s.y;
            }
            *p = v;
          }
        }
      }
    }
  }
}

// out[e] = sum over the group slots of part[g][e], always in slot order
__global__ void sum_groups_kernel(const float2* __restrict__ part,
                                  float2* __restrict__ out, size_t n, int G) {
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    float2 acc = part[e];
    for (int g = 1; g < G; ++g) {
      const float2 v = part[(size_t)g * n + e];
      acc.x += v.x;
      acc.y += v.y;
    }
    out[e] = acc;
  }
}

template <bool HAS_W>
int launch(const void* psi, const void* L, const void* W, const void* R,
           void* part, void* out, int B, int K, int X, int Rd, int din,
           int dout, int wl, int wr, int Tk, int Tx, int G, void* stream) {
  const int nkt = (K + Tk - 1) / Tk;
  const int nW = HAS_W ? wl * dout * din * wr : 0;
  const long K3p = ((long)wl * Tk + kC - 1) / kC * kC;
  const long N3p = ((long)dout * Tx + 7) / 8 * 8;
  if (Tk < 1 || Tx < 1 || Tk * din > kRows1 || Tx * wr > kCols1 ||
      (long)dout * Tx > kCols3 || N3p * (K3p + 8) > kT2 || G < 1 ||
      G > nkt || nW > kMaxW ||
      (!HAS_W && (din != 1 || dout != 1 || wl != wr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(nW);
  cudaError_t err = cudaFuncSetAttribute(
      chain3_kernel<HAS_W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((X + Tx - 1) / Tx, G);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  chain3_kernel<HAS_W><<<grid, kThreads, smem, st>>>(
      static_cast<const hl*>(psi), static_cast<const hl*>(L),
      static_cast<const hl*>(W), static_cast<const hl*>(R),
      static_cast<float2*>(part), B, K, X, Rd, din, dout, wl, wr, Tk, Tx, nkt,
      G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)B * dout * X;
  const int threads = 256;
  const size_t blocks = (n + threads - 1) / threads;
  sum_groups_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), threads, 0,
                      st>>>(static_cast<const float2*>(part),
                            static_cast<float2*>(out), n, G);
  return (int)cudaGetLastError();
}

}  // namespace

// out (B, dout, X) = chain(psi (K, din, Rd)) at bf16x3; part holds G slots
// of (B, dout, X).  W == NULL runs the K_eff form (din = dout = 1, wl =
// wr, W the identity).  Requires Tk * din <= 128, Tx * wr <= 64,
// dout * Tx <= 128, ceil8(dout * Tx) * (ceil32(wl * Tk) + 8) <= 10240,
// 1 <= G <= ceil(K / Tk) and at most 1024 entries of W
// (cudaErrorInvalidValue otherwise).
extern "C" int pytdscf_chain3_c64(int device, const void* psi, const void* L,
                                  const void* W, const void* R, void* part,
                                  void* out, int B, int K, int X, int Rd,
                                  int din, int dout, int wl, int wr, int Tk,
                                  int Tx, int G, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (W == nullptr)
    return launch<false>(psi, L, W, R, part, out, B, K, X, Rd, din, dout, wl,
                         wr, Tk, Tx, G, stream);
  return launch<true>(psi, L, W, R, part, out, B, K, X, Rd, din, dout, wl, wr,
                      Tk, Tx, G, stream);
}
