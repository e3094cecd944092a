// Fused LSTM cell: gates = x.Wx + h.Wh + b, then the gate math, one launch.
//
// Replaces the Pallas kernel of k8s_device_plugin_tpu/workloads/pallas_ops.py
// (_lstm_cell_kernel, lines 25-40, called by lstm_cell at line 66): both
// gate products accumulate in fp32, split [i|f|g|o] into H-wide slabs, and
//   c' = sigmoid(f) c + sigmoid(i) tanh(g),  h' = sigmoid(o) tanh(c'),
// cast back to the h/c dtype. The gates never reach device memory.
//
// What bounds it: at the ai-benchmark case 5.1 shape (B=100, F=300,
// H=1024, bf16) a step reads 10.8 MB of weights for 1.1 GFLOP, about
// 100 FLOP per byte, below the H100's ~295 FLOP/byte ridge: it is bound
// by device-memory bytes, and the weights are almost all of them.
//
// Design, every path: one block owns a tile of rows by hidden columns j of
// ALL FOUR gate slabs (columns j, H+j, 2H+j, 3H+j), so the block ends the
// K loop holding i, f, g and o for its (row, j) pairs and finishes h'/c'
// on chip. x.Wx and h.Wh run as one K loop over [x | h] into one fp32
// accumulator. Ragged B, F and H are masked: loads outside the arrays read
// 0, stores outside are skipped, so no shape needs padding (the TPU kernel
// needed H, F % 128 == 0 and B % 8 == 0). Three routes, chosen by the
// wrapper from dtype, shape and alignment (never after a failure):
//
// bf16 ring (case 5.1's): a block holds up to 128 rows (two m64 slabs:
// all of case 5.1's 100), so each weight byte is fetched once. A cluster
// of two blocks owns 16 hidden columns of each gate slab (128 blocks at
// H = 1024) and splits the K loop over [x | h] in halves, so each x/h
// byte is read from L2 by 64 block pairs' one half instead of by all 128
// blocks (17 MB instead of 34 at case 5.1), and each weight row piece is
// a whole 32-byte sector. Tiles of 64 K values (x/h rows of 128 x 64 and
// the 64 x 64 weight columns, 24 KB) stream through a STAGES-deep
// cp.async ring (72 KB in flight per SM), zero-filled past B, F, H by the
// copy itself and written in the 128-byte swizzle that wgmma's
// descriptors read: each warpgroup runs wgmma m64n64k16 on its 64 rows
// with A (x/h) K-major and the weights MN-major straight from their [k][n]
// layout (no transposing stores), fp32 accumulation. Rank 1 of the pair
// hands its partial sums to rank 0 through distributed shared memory;
// rank 0 adds them and, since every thread holds all four gates of its
// (row, column)s, runs the gate math in registers. Needs F % 4 == 0,
// H % 16 == 0, x 8-byte and h and the weights 16-byte aligned.
// bf16 otherwise: 64 rows x 8 hidden columns per block, element-wise
// loads staged through shared memory, mma.sync.
// fp32: plain FMA on the CUDA cores (tensor cores would round to TF32),
// 64 rows x 16 columns per block, each thread 8 rows of one column.
// A fourth entry, vtpu_lstm_sequence, runs a whole bf16 sequence in one
// persistent launch (the note above namespace seq).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cooperative_groups.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

using sm90::bits;

constexpr int BM = 64;   // rows of the batch per block
constexpr int BJ = 16;   // hidden columns per block, in each of 4 slabs
constexpr int BK = 32;   // depth of one shared-memory tile
constexpr int NT = 128;  // threads: 16 columns x 8 row groups of 8 rows
constexpr int RT = BM / (NT / BJ);  // rows per thread (8)
constexpr int AS = BM + 4;  // padded row of the transposed A tile

__device__ __forceinline__ float bf(bits v) {
  return __bfloat162float(__ushort_as_bfloat16(v));
}

// ------------------------------------------------------------ gate math
//
// Every route finishes its (row, j)s with finish(): one gate function, so
// the routes differ only in the order of their fp32 sums. It is branch-free
// and runs on the SFU: 5 ex2.approx and 3 rcp.approx an element, about 45
// other instructions, no IEEE division and no libdevice expf or tanhf
// (tanhf branches on |x|, which diverges inside a warp, and each division
// carries a slow-path check). With E = e^(-2|v|):
//   sigmoid(v) = 1 / (1 + e^-v),   tanh(v) = n / d,
// n = sign(v) (1 - E), d = 1 + E for |v| >= 0.55, and n = v + v^3 P(v^2),
// d = 1 below it (P a minimax fit of degree 3 in v^2: the difference
// 1 - E loses v's relative accuracy near 0). Each e^x is ex2 of x log2 e.
// Where a sigmoid multiplies a tanh (i with g, o with c') the two share
// one reciprocal: sigmoid(u) tanh(v) = n / ((1 + e^-u) d).
//
// Subnormal results are kept, as IEEE division keeps them: a sigmoid's
// denominator is carried times 2^-64, as h^2 + 2^-64 with h = 2^(-v log2 e
// / 2) 2^-32, so that the reciprocal stays normal and the last multiply
// (by 2^-64, then by n or c) rounds into the subnormal range without a
// flush. Nothing needs clamping: an exponent past fp32's range makes h
// +inf, which meets only d >= 1 and the reciprocal (1/inf = +0); one of
// -inf makes it 0. So every finite input saturates to 0 or 1, nothing
// meets inf * 0, and a NaN stays NaN.
//
// Accuracy, against float64 (ex2 within 2 ulp, rcp within 1): sigmoid and
// tanh within 4 fp32 ulp or 2^-22 absolute over all of fp32, on the card
// too (tests/test_torch_cuda.py). The absolute bound holds where v << 0:
// there the rounding of v log2 e, which grows with |v|, takes sigmoid's
// relative error past 4 ulp, and sigmoid is small enough that the error
// stays below 2^-22. Not tanh.approx.f32: its 2^-11 relative error would
// be a lower precision, not the same work done faster.

// (1 + e^-v) 2^-64
__device__ __forceinline__ float sigmoid_den(float v) {
  const float h = sm90::ex2(v * -0.7213475204f) * 0x1p-32f;  // log2(e) / 2
  return fmaf(h, h, 0x1p-64f);
}

// tanh(v) = n / d
__device__ __forceinline__ void tanh_frac(float v, float& n, float& d) {
  const float a = fabsf(v);
  const float e = sm90::ex2(a * -2.8853900818f);  // 2 log2(e)
  const float s = v * v;
  float p = 1.6378708e-2f;
  p = fmaf(p, s, -5.2640017e-2f);
  p = fmaf(p, s, 1.3320218e-1f);
  p = fmaf(p, s, -3.3332923e-1f);
  const bool near0 = a < 0.55f;
  n = near0 ? fmaf(p * s, v, v) : copysignf(1.f - e, v);
  d = near0 ? 1.f : 1.f + e;
}

// sigmoid(u) tanh(v), one reciprocal
__device__ __forceinline__ float sigmoid_tanh(float u, float v) {
  float n, d;
  tanh_frac(v, n, d);
  return n * (sm90::rcp(sigmoid_den(u) * d) * 0x1p-64f);
}

// the gate math for one (row, j): gates i, f, g, o with their biases added
__device__ __forceinline__ void finish(float i, float f, float g, float o,
                                       float c, float& h_new, float& c_new) {
  c_new = fmaf(sm90::rcp(sigmoid_den(f)) * 0x1p-64f, c, sigmoid_tanh(i, g));
  h_new = sigmoid_tanh(o, c_new);
}

// ---------------------------------------------------------------- fp32, FMA

// acc[r][g] += sum_k A[m0 + tr*RT + r][k] * W[k][g*H + j0 + tj]
__device__ void accumulate(const float* __restrict__ a,
                           const float* __restrict__ w,
                           int rows, int depth, int hidden, int m0, int j0,
                           float (*as)[AS], float (*wt)[4 * BJ],
                           float (&acc)[RT][4]) {
  const int t = threadIdx.x;
  const int tj = t % BJ, tr = t / BJ;
  for (int k0 = 0; k0 < depth; k0 += BK) {
    for (int e = t; e < BM * BK; e += NT) {
      const int m = e / BK, kk = e % BK;
      const int gm = m0 + m, gk = k0 + kk;
      as[kk][m] = (gm < rows && gk < depth)
                      ? a[static_cast<size_t>(gm) * depth + gk]
                      : 0.f;
    }
    for (int e = t; e < BK * 4 * BJ; e += NT) {
      const int kk = e / (4 * BJ), col = e % (4 * BJ);
      const int g = col / BJ, j = j0 + col % BJ, gk = k0 + kk;
      wt[kk][col] =
          (gk < depth && j < hidden)
              ? w[static_cast<size_t>(gk) * 4 * hidden
                  + static_cast<size_t>(g) * hidden + j]
              : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float av[RT];
#pragma unroll
      for (int q = 0; q < RT; q += 4) {
        const float4 v =
            *reinterpret_cast<const float4*>(&as[kk][tr * RT + q]);
        av[q] = v.x; av[q + 1] = v.y; av[q + 2] = v.z; av[q + 3] = v.w;
      }
      float wv[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) wv[g] = wt[kk][g * BJ + tj];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = fmaf(av[r], wv[g], acc[r][g]);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT)
lstm_cell_fp32_kernel(const float* __restrict__ x, const float* __restrict__ h,
                      const float* __restrict__ c, const float* __restrict__ wx,
                      const float* __restrict__ wh, const float* __restrict__ b,
                      float* __restrict__ h_out, float* __restrict__ c_out,
                      int rows, int features, int hidden) {
  __shared__ __align__(16) float as[BK][AS];
  __shared__ __align__(16) float wt[BK][4 * BJ];
  const int j0 = blockIdx.x * BJ, m0 = blockIdx.y * BM;
  float acc[RT][4] = {};
  accumulate(x, wx, rows, features, hidden, m0, j0, as, wt, acc);
  accumulate(h, wh, rows, hidden, hidden, m0, j0, as, wt, acc);

  const int tj = threadIdx.x % BJ, tr = threadIdx.x / BJ;
  const int j = j0 + tj;
  if (j >= hidden) return;
  const float bi = b[j], bf_ = b[hidden + j];
  const float bg = b[2 * hidden + j], bo = b[3 * hidden + j];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int m = m0 + tr * RT + r;
    if (m >= rows) break;
    const size_t idx = static_cast<size_t>(m) * hidden + j;
    float h_new, c_new;
    finish(acc[r][0] + bi, acc[r][1] + bf_, acc[r][2] + bg, acc[r][3] + bo,
           c[idx], h_new, c_new);
    h_out[idx] = h_new;
    c_out[idx] = c_new;
  }
}

// -------------------------------------------- bf16, element-wise fallback

namespace tc {

constexpr int BM = 64;      // rows per block: one m16 tile per warp
constexpr int BJ = 8;       // hidden columns per block: one n8 tile per gate
constexpr int BK = 64;      // depth of one tile
constexpr int NT = 128;     // 4 warps
constexpr int CA = BK / 4;  // A chunks of 4 per tile row
// A tile of depth BK = 64 is stored in rows of BK + 8 bf16, 36 words: 4
// times an odd number, so the 8 rows x 4 words of a warp's fragment load
// hit 32 distinct banks.
using sm90::mma;

__device__ __forceinline__ uint32_t ld32(const bits* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// up to 4 (8) bf16 from p, n of them inside the array, 0 for the rest;
// element e lands in bits 16*(e%2) of word e/2
__device__ __forceinline__ uint2 load4(const bits* p, int n) {
  uint32_t v[2] = {0, 0};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < n) v[e / 2] |= uint32_t(p[e]) << (16 * (e % 2));
  return make_uint2(v[0], v[1]);
}

__device__ __forceinline__ uint4 load8(const bits* p, int n) {
  uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e < n) v[e / 2] |= uint32_t(p[e]) << (16 * (e % 2));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// A K tile, BK deep, is staged global -> registers -> shared memory, and
// the next tile's loads start before the current tile's MMAs. Thread t
// always loads A's 4-wide chunk t % CA of rows t / CA + i * NT/CA, and W's
// gate q = t % 4 (columns j0..j0+7) at depths t / 4 + i * NT/4.
struct Tile {
  uint2 a[BM * CA / NT];
  uint4 w[BK * 4 / NT];

  __device__ __forceinline__ void fetch(const bits* __restrict__ ga,
                                        const bits* __restrict__ gw,
                                        int rows, int depth, int hidden,
                                        int m0, int j0, int k0) {
    const int t = threadIdx.x;
    const int am = m0 + t / CA, ak = k0 + (t % CA) * 4;
    const bits* pa = ga + static_cast<size_t>(am) * depth + ak;
#pragma unroll
    for (int i = 0; i < BM * CA / NT; ++i) {
      const bits* p = pa + static_cast<size_t>(i) * (NT / CA) * depth;
      a[i] = am + i * (NT / CA) < rows ? load4(p, depth - ak)
                                       : make_uint2(0, 0);
    }
    const int wk = k0 + t / 4;
    const bits* pw = gw + static_cast<size_t>(wk) * 4 * hidden
                   + static_cast<size_t>(t % 4) * hidden + j0;
#pragma unroll
    for (int i = 0; i < BK * 4 / NT; ++i) {
      const bits* p = pw + static_cast<size_t>(i) * (NT / 4) * 4 * hidden;
      w[i] = wk + i * (NT / 4) < depth ? load8(p, hidden - j0)
                                       : make_uint4(0, 0, 0, 0);
    }
  }

  __device__ __forceinline__ void store(bits (*as)[BK + 8],
                                        bits (*bs)[BK + 8]) const {
    const int t = threadIdx.x;
#pragma unroll
    for (int i = 0; i < BM * CA / NT; ++i)
      *reinterpret_cast<uint2*>(&as[t / CA + i * (NT / CA)][(t % CA) * 4]) =
          a[i];
#pragma unroll
    for (int i = 0; i < BK * 4 / NT; ++i) {
      const uint32_t words[4] = {w[i].x, w[i].y, w[i].z, w[i].w};
      const int k = t / 4 + i * (NT / 4), n0 = (t % 4) * BJ;
#pragma unroll
      for (int jj = 0; jj < BJ; ++jj)  // n-major: k pairs are contiguous
        bs[n0 + jj][k] = static_cast<bits>(words[jj / 2] >> (16 * (jj % 2)));
    }
  }
};

// acc[q] += A[m0 + warp*16 + (0..15)][:] . W[:][q*H + j0 + (0..7)]
__device__ void accumulate(const bits* __restrict__ a,
                           const bits* __restrict__ w, int rows, int depth,
                           int hidden, int m0, int j0, bits (*as)[BK + 8],
                           bits (*bs)[BK + 8], float (&acc)[4][4]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;
  Tile tile;
  tile.fetch(a, w, rows, depth, hidden, m0, j0, 0);
  for (int k0 = 0; k0 < depth; k0 += BK) {
    __syncthreads();  // every warp has read the previous tile
    tile.store(as, bs);
    __syncthreads();
    if (k0 + BK < depth)  // the next tile's loads overlap the MMAs
      tile.fetch(a, w, rows, depth, hidden, m0, j0, k0 + BK);
#pragma unroll
    for (int s = 0; s < BK; s += 16) {
      const int r = warp * 16 + g, k = s + tig * 2;
      const uint32_t af[4] = {ld32(&as[r][k]), ld32(&as[r + 8][k]),
                              ld32(&as[r][k + 8]), ld32(&as[r + 8][k + 8])};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = q * BJ + g;
        mma(acc[q], af, ld32(&bs[n][k]), ld32(&bs[n][k + 8]));
      }
    }
  }
}

__global__ void __launch_bounds__(NT)
lstm_cell_bf16_kernel(const bits* __restrict__ x, const bits* __restrict__ h,
                      const bits* __restrict__ c, const bits* __restrict__ wx,
                      const bits* __restrict__ wh, const bits* __restrict__ b,
                      bits* __restrict__ h_out, bits* __restrict__ c_out,
                      int rows, int features, int hidden) {
  __shared__ __align__(16) bits as[BM][BK + 8];
  __shared__ __align__(16) bits bs[4 * BJ][BK + 8];
  const int j0 = blockIdx.x * BJ, m0 = blockIdx.y * BM;
  float acc[4][4] = {};  // [gate][m16n8 accumulator fragment]
  accumulate(x, wx, rows, features, hidden, m0, j0, as, bs, acc);
  accumulate(h, wh, rows, hidden, hidden, m0, j0, as, bs, acc);

  // fragment element e holds row g + 8*(e/2), column 2*tig + e%2
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int m = m0 + warp * 16 + g + 8 * (e / 2);
    const int j = j0 + 2 * tig + e % 2;
    if (m >= rows || j >= hidden) continue;
    const size_t idx = static_cast<size_t>(m) * hidden + j;
    float h_new, c_new;
    finish(acc[0][e] + bf(b[j]), acc[1][e] + bf(b[hidden + j]),
           acc[2][e] + bf(b[2 * hidden + j]),
           acc[3][e] + bf(b[3 * hidden + j]), bf(c[idx]), h_new, c_new);
    h_out[idx] = __bfloat16_as_ushort(__float2bfloat16(h_new));
    c_out[idx] = __bfloat16_as_ushort(__float2bfloat16(c_new));
  }
}

}  // namespace tc

// ------------------------------------- bf16, cp.async ring + wgmma route

namespace ring {

constexpr int BM = 128;        // rows per block: one m64 slab per warpgroup
constexpr int BJ = 16;         // hidden columns per block pair, per gate
constexpr int BK = 64;         // depth of one tile: 128-byte rows
constexpr int STAGES = 4;
constexpr int NT = 256;        // 2 warpgroups
constexpr int ROW = 128;       // bytes of one swizzled row
constexpr int A_BYTES = BM * ROW;  // 16 KB: x/h rows x 64 k
constexpr int W_BYTES = BK * ROW;  // 8 KB: 64 k x [4 gates x 16 columns]
constexpr int STAGE = A_BYTES + W_BYTES;
constexpr int PART = NT * 32 * 4;  // the partner's partial sums, 32 KB
constexpr int SMEM = 1024 + STAGES * STAGE + PART;

// byte offset of 16-byte chunk `chunk` of row `row` in a tile of 128-byte
// rows, 128-byte swizzled (as TMA's SWIZZLE_128B and the wgmma
// descriptors lay it out): the chunk index XOR the row's low 3 bits
__device__ __forceinline__ uint32_t sw(int row, int chunk) {
  return row * ROW + ((chunk ^ (row & 7)) << 4);
}

// descriptors: A K-major (k contiguous), W MN-major (columns contiguous);
// 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return sm90::sw128_desc(addr, 1, 1024 >> 4);
}

// Copies K tile `k0` of A ([rows][depth], BYTES-wide chunks) and of the
// weights (W [depth][4H]: per gate q, columns q*H + j0 .. +15, which land
// side by side in a 128-byte row) into stage memory at sa / sw_; what lies
// outside the arrays is zero-filled.
template <int BYTES>
__device__ __forceinline__ void load_tile(const bits* __restrict__ a,
                                          const bits* __restrict__ w,
                                          int rows, int depth, int hidden,
                                          int m0, int j0, int k0,
                                          uint32_t sa, uint32_t sw_) {
  constexpr int EL = BYTES / 2;  // bf16 per chunk
  constexpr int PER_ROW = BK / EL;
  for (int e = threadIdx.x; e < BM * PER_ROW; e += NT) {
    const int r = e / PER_ROW, c = e % PER_ROW, k = k0 + c * EL;
    const bool in = m0 + r < rows && k < depth;  // depth % EL == 0
    const bits* src = in ? a + static_cast<size_t>(m0 + r) * depth + k : a;
    sm90::cp_async<BYTES>(sa + sw(r, c * EL / 8) + (c * EL % 8) * 2, src,
                          in ? BYTES : 0);
  }
  for (int e = threadIdx.x; e < BK * 8; e += NT) {
    const int kk = e / 8, c = e % 8, k = k0 + kk;  // chunk c: gate c / 2
    const bool in = k < depth;  // hidden % BJ == 0: every column inside
    const bits* src = in ? w + static_cast<size_t>(k) * 4 * hidden
                             + static_cast<size_t>(c / 2) * hidden + j0
                             + (c % 2) * 8
                         : w;
    sm90::cp_async<16>(sw_ + sw(kk, c), src, in ? 16 : 0);
  }
}

// A block pair (a cluster of 2) owns 16 hidden columns of each gate slab
// and up to 128 rows, and splits the K loop over [x | h] in two halves.
// Rank 1 hands its partial sums to rank 0 through distributed shared
// memory; rank 0 adds them and runs the gate math.
//
// Accumulator layout of m64n64 (warp w of the warpgroup, g = lane / 4,
// tig = lane % 4): element 4J + e at row 16w + g + 8(e/2) and column
// 8J + 2tig + e%2, i.e. gate J / 2, column 8(J%2) + 2tig + e%2 of the
// block's 16: every thread holds all four gates of its (row, column)s.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(NT, 1)
lstm_cell_kernel(const bits* __restrict__ x, const bits* __restrict__ h,
                 const bits* __restrict__ c, const bits* __restrict__ wx,
                 const bits* __restrict__ wh, const bits* __restrict__ b,
                 bits* __restrict__ h_out, bits* __restrict__ c_out,
                 int rows, int features, int hidden) {
  namespace cg = cooperative_groups;
  extern __shared__ uint8_t raw[];
  uint8_t* smem = raw + ((1024 - sm90::smem_u32(raw) % 1024) % 1024);
  const uint32_t base = sm90::smem_u32(smem);
  float4* part = reinterpret_cast<float4*>(smem + STAGES * STAGE);
  cg::cluster_group pair = cg::this_cluster();
  const int rank = static_cast<int>(pair.block_rank());
  const int j0 = (blockIdx.x / 2) * BJ, m0 = blockIdx.y * BM;
  // the K loop runs over [x | h]: tiles 0 .. nx-1 of x.Wx, then h.Wh;
  // rank 0 takes the first half of them, rank 1 the rest
  const int nx = (features + BK - 1) / BK;
  const int n_all = nx + (hidden + BK - 1) / BK;
  const int t0 = rank == 0 ? 0 : (n_all + 1) / 2;
  const int n_tiles = rank == 0 ? (n_all + 1) / 2 : n_all - t0;
  // x rows are 8-byte aligned (F % 4 == 0), h rows 16-byte (H % 8 == 0)
  auto load = [&](int i) {
    const uint32_t sa = base + (i % STAGES) * STAGE;
    const int t = t0 + i;
    if (t < nx)
      load_tile<8>(x, wx, rows, features, hidden, m0, j0, t * BK, sa,
                   sa + A_BYTES);
    else
      load_tile<16>(h, wh, rows, hidden, hidden, m0, j0, (t - nx) * BK, sa,
                    sa + A_BYTES);
  };

  const int group = threadIdx.x / 128;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_tiles) load(i);
    sm90::cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    sm90::cp_async_wait<STAGES - 2>();  // tile i has landed (this thread's)
    sm90::fence_proxy_async();          // ... visible to wgmma
    __syncthreads();  // ... for every thread; and tile i-1 is consumed
    if (i + STAGES - 1 < n_tiles) load(i + STAGES - 1);
    sm90::cp_async_commit();

    const uint32_t sa = base + (i % STAGES) * STAGE + group * 64 * ROW;
    const uint32_t sb = base + (i % STAGES) * STAGE + A_BYTES;
    sm90::wgmma_fence();
#pragma unroll
    for (int s = 0; s < BK / 16; ++s)  // 16 k a step: 32 bytes, 16 rows
      sm90::wgmma_ss<1>(acc, desc(sa + 32 * s), desc(sb + 16 * s * ROW), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
  }
  sm90::cp_async_wait<0>();

  pair.sync();  // both blocks are running and done with their K halves
  if (rank == 1) {
    float4* dst = pair.map_shared_rank(part, 0);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      dst[i * NT + threadIdx.x] = make_float4(acc[4 * i], acc[4 * i + 1],
                                              acc[4 * i + 2], acc[4 * i + 3]);
  }
  pair.sync();  // rank 1's sums have landed
  if (rank == 1) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 p = part[i * NT + threadIdx.x];
    acc[4 * i] += p.x;
    acc[4 * i + 1] += p.y;
    acc[4 * i + 2] += p.z;
    acc[4 * i + 3] += p.w;
  }

  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + 64 * group + 16 * warp + g + 8 * (e / 2);
      const int j = j0 + 8 * half + 2 * tig + e % 2;
      if (m >= rows) continue;
      const size_t idx = static_cast<size_t>(m) * hidden + j;
      float h_new, c_new;
      finish(acc[4 * half + e] + bf(b[j]),
             acc[4 * (2 + half) + e] + bf(b[hidden + j]),
             acc[4 * (4 + half) + e] + bf(b[2 * hidden + j]),
             acc[4 * (6 + half) + e] + bf(b[3 * hidden + j]), bf(c[idx]),
             h_new, c_new);
      h_out[idx] = __bfloat16_as_ushort(__float2bfloat16(h_new));
      c_out[idx] = __bfloat16_as_ushort(__float2bfloat16(c_new));
    }
}

}  // namespace ring

// ------------------------------- bf16 sequence: one persistent launch
//
// Replaces the classifier's loop of T launches of the ring route (the
// Pallas kernel's per-step calls, _lstm_cell_kernel in a loop) with one
// launch that runs all T steps. What bounds the loop: at case 5.1 each
// launch fetches the 10.8 MB of Wx and Wh anew into 128 blocks, fills its
// ring and exits, about 16 us a step against 3.5 by bytes; the step is
// bound by latency, not bandwidth. Here each block loads its slice of the
// weights into shared memory once and keeps it for every step, so a step
// moves only h_t (200 KB, read from L2 by every block pair: 12.8 MB) and
// x_t (60 KB); the call's lower bound is its products, 1.12 ms at case
// 5.1 (T x 1.0846 GFLOP at 989 TFLOP/s). What bounds it instead is a
// step's chain of latencies: the grid barrier, L2's delivery of h_t to
// 128 SMs at once, the partial sums' exchange and the gate math. The gate
// math is pure instruction latency (2 consumer warps a scheduler), so it
// runs finish()'s branch-free SFU form (above: ex2.approx and rcp.approx,
// one reciprocal for each sigmoid times tanh, within 4 fp32 ulp or 2^-22
// of float64; not tanh.approx.f32, whose 2^-11 would lower the
// precision), each thread's four elements in one straight run so that
// their SFU operations overlap.
//
// Layout, as the ring route's: a cluster of two blocks owns 16 hidden
// columns of each gate slab (128 blocks at H = 1024, one an SM) and up to
// 128 rows (two m64 slabs, one a consumer warpgroup), and splits the K
// loop: rank r takes half r of x's 64-wide K tiles and half r of h's. Each
// rank keeps its halves of Wx and Wh for the pair's 64 gate columns (88
// KB at case 5.1, swizzled as wgmma reads them) in shared memory, beside
// one slot a h tile (up to 8: H <= 1024; B rounded up to 8 rows each).
// A producer warp does the waiting and the loads; per step t:
//  - producer: once its consumers have stored their slice of h_t, the
//    grid barrier; then TMA loads of all of this rank's h_t tiles at once
//    (each pair starts at another tile, so that L2 is not asked for the
//    same lines by every SM together), and once the consumers have read
//    them, x_{t+1}'s tiles into the first slots (x_{t+2} goes to L2 ahead);
//  - consumers: the accumulator already holds x_t . Wx; wgmma adds
//    h_t . Wh tile by tile as the tiles land; rank r sends the peer the
//    half of the partial sums that the peer finishes (st.async into its
//    shared memory, counted on its mbarrier) and adds the peer's half for
//    its own 8 columns; the gate math in registers (c stays there,
//    rounded to bf16 each step as the ring route writes it); h_{t+1} to
//    one of two [B, H] buffers in turn (L2-resident); then x_{t+1} . Wx,
//    while the producer waits at the grid barrier: it does not depend on
//    h.
// The grid barrier is one word, the arrival count of cooperative groups'
// grid sync: block 0 adds 2^31 - (blocks - 1), the others 1, so bit 31
// flips when the last block arrives and the low bits return to 0; a
// waiter spins on an acquire load until the bit differs from the word it
// saw at its arrival (a wait of 10 s traps). The word is zeroed once and
// serves every launch on its stream. The blocks wait on each other, so
// all must be resident at once: the wrapper takes this route only where
// the occupancy queries, asked with the launch's attributes, say the
// whole grid fits (vtpu_lstm_sequence_resident), and the launch is
// cooperative. The same
// products and the same bf16 rounding of h and c each step as the ring
// route: the two differ only in the order of the fp32 sums. x's rows are
// read through TMA, so the wrapper lays xs out with rows a multiple of 16
// bytes apart. Rows past B read as zeros (TMA) or as whatever a slot
// holds past them (a warpgroup reads 64 rows); a row's products depend on
// that row alone, and rows past B are never stored. A warpgroup with no
// row inside B skips its products.

namespace seq {

using ring::BK;
using ring::ROW;
using ring::desc;
using ring::sw;

constexpr int BJ = 16;         // hidden columns per block pair, per gate
constexpr int NT = 256;        // consumers: 2 warpgroups, one m64 slab each
constexpr int MAX_ROWS = 128;
constexpr int MAX_TILES = 8;   // h tiles a rank holds at once (H <= 1024)
constexpr int W_BYTES = BK * ROW;  // 8 KB: 64 k x 64 gate columns
// the partner's half of the sums; it also lies after the last slot, where
// a warpgroup's 64-row reads past the batch run on
constexpr int PART = NT * 4 * 16;
// an H100 block's opt-in maximum (232,448 bytes) less room for the static
// barriers
constexpr int SMEM_MAX = 231424;

__host__ __device__ constexpr int tiles(int depth) {
  return (depth + BK - 1) / BK;
}

// K tiles of each rank's half: rank 0 takes the first (n + 1) / 2
__host__ __device__ constexpr int first_half(int depth) {
  return (tiles(depth) + 1) / 2;
}

// rows of a slot: the batch in whole 8-row swizzle atoms
__host__ __device__ constexpr int slot_rows(int rows) {
  return (rows + 7) / 8 * 8;
}

// bytes of dynamic shared memory a block asks for (rank 0's halves, the
// larger): Wh's tiles, Wx's, one slot a h tile (x's tiles use the first
// slots between steps), the partner's sums; 2^30 where a rank would hold
// more h tiles than MAX_TILES or more x tiles than h tiles
__host__ __device__ constexpr int smem_bytes(int rows, int features,
                                             int hidden) {
  return first_half(hidden) > MAX_TILES
                 || first_half(features) > first_half(hidden)
             ? 1 << 30
             : 1024 + (first_half(features) + first_half(hidden)) * W_BYTES
                   + first_half(hidden) * slot_rows(rows) * ROW + PART;
}

// K tile k0 of W [depth][4H], the pair's columns q*H + j0 .. +15 of each
// gate q side by side in a 128-byte row, into a swizzled tile at dst
__device__ __forceinline__ void load_cols(const bits* __restrict__ w,
                                          int depth, int hidden, int j0,
                                          int k0, uint32_t dst) {
  for (int e = threadIdx.x; e < BK * 8; e += blockDim.x) {
    const int kk = e / 8, c = e % 8, k = k0 + kk;
    const bool in = k < depth;
    const bits* src = in ? w + static_cast<size_t>(k) * 4 * hidden
                             + static_cast<size_t>(c / 2) * hidden + j0
                             + (c % 2) * 8
                         : w;
    sm90::cp_async<16>(dst + sw(kk, c), src, in ? 16 : 0);
  }
}

// acc = x_t . Wx over this rank's n tiles (A's `pitch` bytes apart at a,
// this warpgroup's rows; W's at w), once x_t's tiles have landed (phase
// `parity` of mbarrier xbar)
__device__ __forceinline__ void x_product(float (&acc)[32], uint32_t a,
                                          uint32_t pitch, uint32_t w, int n,
                                          uint32_t xbar, uint32_t parity,
                                          bool live) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  if (!live) return;
  sm90::mbar_wait(xbar, parity);
  sm90::wgmma_fence();
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int s = 0; s < BK / 16; ++s)
      sm90::wgmma_ss<1>(acc, desc(a + i * pitch + 32 * s),
                        desc(w + i * W_BYTES + 16 * s * ROW), 1);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::reg_fence(acc);
}

// one arrival of this warp on mbarrier bar, once all its threads are here
// (and their earlier memory accesses ordered before it)
__device__ __forceinline__ void warp_arrive(uint32_t bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) sm90::mbar_arrive(bar);
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}

// a block that waits this long for its peers traps: the launch fails with
// an error instead of holding the card
constexpr uint64_t WAIT_NS = 10000000000ull;

// (one thread a block) arrives at the grid barrier after everything this
// block stored that the thread has observed, and returns once every block
// has arrived: bit 31 of the word has flipped
__device__ __forceinline__ void grid_sync(uint32_t* bar) {
  const uint32_t add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
  const uint32_t old = sm90::atom_add_release_gpu(bar, add);
  const uint64_t since = global_ns();
  while (((sm90::ld_acquire_gpu(bar) ^ old) & 0x80000000u) == 0)
    if (global_ns() - since > WAIT_NS) __trap();
}

__global__ void __launch_bounds__(NT + 32, 1)
lstm_cell_seq_kernel(const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap h0_map,
                     const __grid_constant__ CUtensorMap h_map,
                     const bits* __restrict__ xs, int ld,
                     const bits* __restrict__ c0,
                     const bits* __restrict__ wx, const bits* __restrict__ wh,
                     const bits* __restrict__ b, bits* __restrict__ hbuf,
                     bits* __restrict__ c_out, uint32_t* __restrict__ bar,
                     int steps, int rows, int features, int hidden) {
  namespace cg = cooperative_groups;
  extern __shared__ uint8_t raw[];
  // mbarriers, each completing once a step: h tile i's (full + 8 i), the
  // peer's sums, x's tiles; and the consumer warps' "x's product has read
  // the slots", "h's products have", "h_{t+1} is stored"
  __shared__ __align__(8) uint64_t bars[MAX_TILES + 5];
  uint8_t* smem = raw + ((1024 - sm90::smem_u32(raw) % 1024) % 1024);
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int pair = blockIdx.x / 2, j0 = pair * BJ;
  // this rank's K tiles: x's from x_first, h's from h_first
  const int x0 = first_half(features), h0n = first_half(hidden);
  const int x_first = rank ? x0 : 0, h_first = rank ? h0n : 0;
  const int nx = rank ? tiles(features) - x0 : x0;
  const int nh = rank ? tiles(hidden) - h0n : h0n;
  // the pairs take their h tiles in turns from different starts, so that
  // they do not all ask L2 for the same lines at once
  const int rot = nh ? pair % nh : 0;
  // shared memory: Wh's tiles, Wx's, the slots (h_t's tiles during a
  // step, x_{t+1}'s in the first between steps), the partner's sums
  const uint32_t slot = slot_rows(rows) * ROW;
  const uint32_t base = sm90::smem_u32(smem);
  const uint32_t whs = base, wxs = whs + h0n * W_BYTES;
  const uint32_t slots = wxs + x0 * W_BYTES;
  float4* part =
      reinterpret_cast<float4*>(smem + (slots - base) + h0n * slot);
  const uint32_t full = sm90::smem_u32(bars);
  const uint32_t sums = full + 8 * MAX_TILES, xbar = sums + 8;
  const uint32_t xdone = xbar + 8, freed = xdone + 8, stored = freed + 8;

  if (threadIdx.x == 0) {
    for (int i = 0; i < MAX_TILES + 2; ++i) sm90::mbar_init(full + 8 * i, 1);
    for (int i = 0; i < 3; ++i) sm90::mbar_init(xdone + 8 * i, NT / 32);
    sm90::mbar_fence_init();
  }
  for (int i = 0; i < nh; ++i)
    load_cols(wh, hidden, hidden, j0, (h_first + i) * BK, whs + i * W_BYTES);
  for (int i = 0; i < nx; ++i)
    load_cols(wx, features, hidden, j0, (x_first + i) * BK, wxs + i * W_BYTES);
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();  // the weights
  sm90::fence_proxy_async();
  // both blocks' barriers are set up before either writes to the other's
  sm90::cluster_arrive();
  sm90::cluster_wait();

  if (threadIdx.x >= NT) {
    // the producer warp (one thread): the grid barrier and every TMA load,
    // so that the consumers' x product runs while it waits
    if (threadIdx.x == NT) {
      auto load_x = [&](int t) {  // x_t's tiles of this rank, first slots
        sm90::mbar_expect_tx(xbar, nx * slot);
        for (int i = 0; i < nx; ++i)
          sm90::tma_load_3d(slots + i * slot, &x_map, xbar,
                            (x_first + i) * BK, 0, t);
      };
      auto prefetch_x = [&](int t) {  // x_t into L2, two steps ahead
        if (blockIdx.x == 0 && t < steps)
          sm90::prefetch_l2(xs + static_cast<size_t>(t) * rows * ld,
                            2u * rows * ld);
      };
      load_x(0);
      prefetch_x(1);
      for (int t = 0; t < steps; ++t) {
        if (t > 0) {
          sm90::mbar_wait(stored, (t - 1) & 1);  // this block's h_t
          grid_sync(bar);  // every block's
          sm90::fence_proxy_async_global();
        }
        prefetch_x(t + 2);
        sm90::mbar_wait(xdone, t & 1);  // the slots are free
        sm90::mbar_expect_tx(sums, PART);
        for (int i = 0; i < nh; ++i) {
          sm90::mbar_expect_tx(full + 8 * i, slot);
          sm90::tma_load_3d(slots + i * slot, t ? &h_map : &h0_map,
                            full + 8 * i, (h_first + (i + rot) % nh) * BK,
                            0, t ? t & 1 : 0);
        }
        if (t + 1 < steps) {
          sm90::mbar_wait(freed, t & 1);
          load_x(t + 1);
        }
      }
    }
    __syncwarp();
  } else {
    // the consumers: two warpgroups, this thread's (row, column)s rows
    // 64 group + 16 warp + g (+ 8) and columns j0 + 8 rank + 2 tig (+ 1);
    // e indexes them as the accumulator
    const int group = threadIdx.x / 128, lane = threadIdx.x % 32;
    const int warp = (threadIdx.x % 128) / 32, g = lane / 4, tig = lane % 4;
    const int m_base = 64 * group + 16 * warp + g;
    const int j = j0 + 8 * rank + 2 * tig;
    const bool live = 64 * group < rows;  // any of this warpgroup's rows
    const uint32_t rows_at = 64 * group * ROW;
    const uint32_t peer_part = sm90::mapa(sm90::smem_u32(part), rank ^ 1);
    const uint32_t peer_sums = sm90::mapa(sums, rank ^ 1);
    float bias[4][2], c[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) bias[q][e] = bf(b[q * hidden + j + e]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m_base + 8 * (e / 2);
      c[e] = m < rows ? bf(c0[static_cast<size_t>(m) * hidden + j + e % 2])
                      : 0.f;
    }

    float acc[32];
    x_product(acc, slots + rows_at, slot, wxs, nx, xbar, 0, live);
    warp_arrive(xdone);
    const size_t plane = static_cast<size_t>(rows) * hidden;
    for (int t = 0; t < steps; ++t) {
      const uint32_t parity = t & 1;
      // acc (= x_t . Wx) += h_t . Wh over this rank's K half
      if (live) {
        sm90::wgmma_fence();
        for (int i = 0; i < nh; ++i) {
          const uint32_t w = whs + ((i + rot) % nh) * W_BYTES;
          const uint32_t a = slots + i * slot + rows_at;
          sm90::mbar_wait(full + 8 * i, parity);
#pragma unroll
          for (int s = 0; s < BK / 16; ++s)
            sm90::wgmma_ss<1>(acc, desc(a + 32 * s), desc(w + 16 * s * ROW),
                              1);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::reg_fence(acc);
      }
      warp_arrive(freed);

      // rank r finishes half r of the columns (accumulator elements
      // 8q + 4r + e): it sends the other half to the peer, adds the peer's
      float gate[4][4], give[4][4];  // (selects: no register is indexed)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lo = acc[8 * q + e], hi = acc[8 * q + 4 + e];
          gate[q][e] = rank ? hi : lo;
          give[q][e] = rank ? lo : hi;
        }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        sm90::st_async(peer_part + 16 * (q * NT + threadIdx.x),
                       make_float4(give[q][0], give[q][1], give[q][2],
                                   give[q][3]),
                       peer_sums);
      sm90::mbar_wait(sums, parity);  // the peer's half has landed here
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 p = part[q * NT + threadIdx.x];
        gate[q][0] += p.x;
        gate[q][1] += p.y;
        gate[q][2] += p.z;
        gate[q][3] += p.w;
      }

      const bool last = t + 1 == steps;
      bits* h_next = hbuf + ((t + 1) & 1) * plane;
      // the thread's four elements in one straight run, so that their SFU
      // operations overlap; then the stores
      float hn[4], cn[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        finish(gate[0][e] + bias[0][e % 2], gate[1][e] + bias[1][e % 2],
               gate[2][e] + bias[2][e % 2], gate[3][e] + bias[3][e % 2],
               c[e], hn[e], cn[e]);
        c[e] = __bfloat162float(__float2bfloat16(cn[e]));
      }
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int m = m_base + 8 * (e / 2);
        if (m >= rows) continue;
        const size_t idx = static_cast<size_t>(m) * hidden + j;
        *reinterpret_cast<uint32_t*>(h_next + idx) =
            sm90::pack(hn[e], hn[e + 1]);
        if (last)
          *reinterpret_cast<uint32_t*>(c_out + idx) =
              sm90::pack(cn[e], cn[e + 1]);
      }
      if (!last) {
        warp_arrive(stored);
        // x_{t+1} . Wx while the producer waits for the other blocks
        x_product(acc, slots + rows_at, slot, wxs, nx, xbar, (t + 1) & 1,
                  live);
        warp_arrive(xdone);
      }
    }
  }
  // neither block leaves while the other may still write to it
  sm90::cluster_arrive();
  sm90::cluster_wait();
}

// 3-D map over `planes` bf16 [rows][cols] planes at ptr, rows `ld`
// elements apart: boxes of 64 columns by slot_rows(rows) rows of one
// plane, 128-byte swizzled; rows past the batch and columns past cols
// read as zeros
bool make_map(CUtensorMap* map, const void* ptr, int planes, int rows,
              int cols, int ld) {
  const sm90::EncodeTiled encode = sm90::encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[3] = {cuuint64_t(cols), cuuint64_t(rows),
                              cuuint64_t(planes)};
  const cuuint64_t strides[2] = {cuuint64_t(ld) * 2,
                                 cuuint64_t(rows) * ld * 2};
  const cuuint32_t box[3] = {BK, cuuint32_t(slot_rows(rows)), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the cooperative launch (attrs[1]) of the grid for `hidden` in clusters
// of 2 (attrs[0]) with `smem` bytes of shared memory a block; the
// residency question asks with the same attributes
cudaLaunchConfig_t launch_config(int hidden, int smem,
                                 cudaLaunchAttribute (&attrs)[2]) {
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = 2;
  attrs[0].val.clusterDim.y = attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(2 * (hidden / BJ));
  config.blockDim = dim3(NT + 32);
  config.dynamicSmemBytes = smem;
  config.attrs = attrs;
  config.numAttrs = 2;
  return config;
}

// lets the kernel ask for up to SMEM_MAX bytes (once)
cudaError_t allow_smem() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      lstm_cell_seq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_MAX);
  return attr;
}

}  // namespace seq

}  // namespace

extern "C" {

// route: 0 = fp32 on FMA; 1 = bf16, element-wise loads; 2 = bf16 ring
// (F % 4 == 0, H % 16 == 0, x 8-byte and h, wx, wh 16-byte aligned).
// x: [rows][features]; h, c, h_out, c_out: [rows][hidden];
// wx: [features][4*hidden]; wh: [hidden][4*hidden]; b: [4*hidden]; all
// row-major on the device. Returns the CUDA error of the launch (0 on
// success).
int vtpu_lstm_cell(int route, const void* x, const void* h, const void* c,
                   const void* wx, const void* wh, const void* b,
                   void* h_out, void* c_out, int rows, int features,
                   int hidden, void* stream) {
  if (rows <= 0 || features <= 0 || hidden <= 0 || rows > 65535 * BM)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto aligned = [](const void* p, uintptr_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  const auto launch = [&](auto kernel, dim3 grid, int threads, int smem,
                          auto type) {
    using T = decltype(type);
    kernel<<<grid, threads, smem, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(h),
        static_cast<const T*>(c), static_cast<const T*>(wx),
        static_cast<const T*>(wh), static_cast<const T*>(b),
        static_cast<T*>(h_out), static_cast<T*>(c_out), rows, features,
        hidden);
  };
  if (route == 0) {
    launch(lstm_cell_fp32_kernel,
           dim3((hidden + BJ - 1) / BJ, (rows + BM - 1) / BM), NT, 0, 0.f);
  } else if (route == 1) {
    launch(tc::lstm_cell_bf16_kernel,
           dim3((hidden + tc::BJ - 1) / tc::BJ,
                (rows + tc::BM - 1) / tc::BM),
           tc::NT, 0, bits{});
  } else if (route == 2) {
    if (features % 4 || hidden % ring::BJ || !aligned(x, 8)
        || !aligned(h, 16) || !aligned(wx, 16) || !aligned(wh, 16))
      return static_cast<int>(cudaErrorInvalidValue);
    static const cudaError_t attr = cudaFuncSetAttribute(
        ring::lstm_cell_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        ring::SMEM);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    launch(ring::lstm_cell_kernel,
           dim3(2 * (hidden / ring::BJ), (rows + ring::BM - 1) / ring::BM),
           ring::NT, ring::SMEM, bits{});
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Whether the sequence route's grid (hidden / 8 blocks in clusters of 2,
// seq::smem_bytes of shared memory each) is resident all at once on the
// current device: *resident = 1 where cudaOccupancyMaxActiveClusters,
// asked with the launch's own attributes (cooperative included), counts
// every cluster and the blocks a multiprocessor holds times the
// multiprocessors count every block (the cooperative launch's own limit);
// 0 where either falls short or the shared memory does not fit. On an
// H100 the first answer agrees with the cooperative launch at clusters of
// 1, 2, 4 and 8 (30 clusters of 4 resident where 32 are asked: refused
// with cudaErrorCooperativeLaunchTooLarge). Launches nothing. Returns the
// CUDA error of the queries (0 on success).
int vtpu_lstm_sequence_resident(int rows, int features, int hidden,
                                int* resident) {
  *resident = 0;
  if (rows <= 0 || rows > seq::MAX_ROWS || features <= 0 || hidden <= 0
      || features % 4 || hidden % seq::BJ)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = seq::smem_bytes(rows, features, hidden);
  if (smem > seq::SMEM_MAX) return 0;
  const cudaError_t attr = seq::allow_smem();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchAttribute attrs[2];
  const cudaLaunchConfig_t config = seq::launch_config(hidden, smem, attrs);
  int clusters = 0, per_sm = 0, device = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(
      &clusters, seq::lstm_cell_seq_kernel, &config);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, seq::lstm_cell_seq_kernel, config.blockDim.x, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *resident = clusters >= hidden / seq::BJ
              && per_sm * sms >= static_cast<int>(config.gridDim.x);
  return 0;
}

// The whole sequence in one cooperative launch: xs [steps][rows][features]
// with rows ld elements apart (ld % 8 == 0, ld >= features);
// h0, c0, c_out [rows][hidden]; hbuf [2][rows][hidden], whose plane
// steps % 2 holds h after the last step; wx, wh, b as vtpu_lstm_cell's;
// bar: one zeroed word, reused by every launch on this stream. Needs
// 1 <= rows <= 128, F % 4 == 0, H % 16 == 0, xs, h0, wx, wh and hbuf
// 16-byte aligned, and vtpu_lstm_sequence_resident's yes for this
// shape. Returns the CUDA error of the launch (0 on success).
int vtpu_lstm_sequence(const void* xs, int ld, const void* h0, const void* c0,
                       const void* wx, const void* wh, const void* b,
                       void* hbuf, void* c_out, void* bar, int steps,
                       int rows, int features, int hidden, void* stream) {
  auto aligned = [](const void* p, uintptr_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  if (steps <= 0 || rows <= 0 || rows > seq::MAX_ROWS || features <= 0
      || hidden <= 0 || features % 4 || hidden % seq::BJ
      || seq::smem_bytes(rows, features, hidden) > seq::SMEM_MAX
      || ld % 8 || ld < features || !aligned(xs, 16) || !aligned(h0, 16)
      || !aligned(wx, 16) || !aligned(wh, 16) || !aligned(hbuf, 16)
      || !aligned(bar, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap x_map, h0_map, h_map;
  if (!seq::make_map(&x_map, xs, steps, rows, features, ld)
      || !seq::make_map(&h0_map, h0, 1, rows, hidden, hidden)
      || !seq::make_map(&h_map, hbuf, 2, rows, hidden, hidden))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = seq::allow_smem();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchAttribute attrs[2];
  cudaLaunchConfig_t config = seq::launch_config(
      hidden, seq::smem_bytes(rows, features, hidden), attrs);
  config.stream = static_cast<cudaStream_t>(stream);
  using T = bits;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, seq::lstm_cell_seq_kernel, x_map, h0_map, h_map,
      static_cast<const T*>(xs), ld, static_cast<const T*>(c0),
      static_cast<const T*>(wx), static_cast<const T*>(wh),
      static_cast<const T*>(b), static_cast<T*>(hbuf),
      static_cast<T*>(c_out), static_cast<uint32_t*>(bar), steps, rows,
      features, hidden);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* vtpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
