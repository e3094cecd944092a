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

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

__device__ __forceinline__ float bf(bits v) {
  return __bfloat162float(__ushort_as_bfloat16(v));
}

// the gate math for one (row, j): gates i, f, g, o with their biases added
__device__ __forceinline__ void finish(float i, float f, float g, float o,
                                       float c, float& h_new, float& c_new) {
  c_new = sigmoid(f) * c + sigmoid(i) * tanhf(g);
  h_new = sigmoid(o) * tanhf(c_new);
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

const char* vtpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
