// Flash-attention absorb: folds K/V into a carried streaming-softmax state
// (running max m, normalizer l, accumulator o), one launch per call.
//
// Replaces the Pallas kernel of k8s_device_plugin_tpu/workloads/flash.py
// (_flash_kernel, lines 60-116, launched by _flash_absorb_impl at line 158
// under flash_absorb). Same semantics: s = q.k^T / sqrt(D) in fp32, a
// runtime mask kind (0 attends to all, 1 is causal on call-local
// row >= col, 2 masks all), an optional window W (key col visible to query
// row only when row - col < W; 0 for none), and the state carried in and
// out: m, l
// [B][H][Tq] and o [B][Tq][H][D] in fp32, contiguous; q, k, v [B][T][H][D],
// bf16 or fp32, each with its own strides (the unit-stride head dim
// aside), so the views of a fused QKV projection are read in place. The
// new state goes to separate output arrays.
//
// Update form: FA2's. Per K/V tile, m_new = max(m, max_row s),
// corr = exp(m - m_new), p = exp(s - m_new), l = l corr + sum p,
// o = o corr + p V. The TPU kernel takes p against the tile's own max and
// scales the tile's sums by exp(m_blk - m_new) (blk_corr); the two agree up
// to rounding. Masked entries give p = 0, also in rows with nothing visible
// yet. NEG_INF is -1e30, never -inf, so the identity state's m - m_new is
// 0, not NaN.
//
// What bounds it: at the LM case (B=8, T=2048, H=8, D=64, bf16, causal, one
// absorb from the identity state) the call must move 119.5 MB (q, k, v
// 50.3 MB; o read and written in fp32 67.1 MB; m, l 2.1 MB), 35.7 us at
// 3.35 TB/s, and do 34.4 GFLOP of products over the causal half, 34.8 us
// at 989 TFLOP/s. Bytes and operations are nearly balanced, bytes a little
// ahead: the bound is about 36 us.
//
// Common to every route: a loop over K/V tiles inside the block takes the
// place of the TPU's sequential grid dimension, per-row m and l and the o
// accumulator stay in fp32 registers for the whole loop, query tiles run
// heaviest first (causal rows near the end see the most keys), and ragged
// Tq, Tk are zero-filled and masked (the TPU fitted tiles to divisors of
// T). kind 1 skips tiles wholly above the diagonal and kind 2 absorbs no
// tile; both are exact (they would add p = 0 with corr = 1), so kind 2
// copies the state bit for bit. A window W starts each query tile's key
// loop at the tile that holds key q0 - W + 1 (q0 the tile's first row), so
// the tiles wholly before the band are never loaded; the band's edge is
// masked element by element. Every route takes a window, each through a
// kernel of its own name, flash_window_kernel, over the same body as
// flash_kernel (a compile-time flag, off in flash_kernel, so the
// unwindowed kernels compile as before): a trace tells the two apart.
// Three routes, chosen by the wrapper from dtype and head dim (never after
// a failure):
//
// wgmma (bf16, D = 64, the LM's and LFM2's, and D = 128, Trinity's):
// warp-specialised. A block is a producer warpgroup and consumer
// warpgroups of 64 query rows each: three at D = 64 (192 rows a block),
// two at D = 128 (128 rows), whose O alone is 64 registers a thread. The
// producer's one thread issues TMA loads (cp.async.bulk.tensor over the
// 4-D [B, T, H, D] view, so strides come from the tensor map and the ragged
// T edge of each batch is zero-filled by the hardware) into a ring of
// STAGES K/V tiles in shared memory, with full/empty mbarriers per stage.
// Q is loaded once per block the same way. A row of D bf16 is loaded as
// D / 64 panels of 64 columns, each a box of its own (a 128-byte swizzled
// box is at most 128 bytes wide). setmaxnreg moves the producer's
// registers to the consumers. TMA writes 128-byte-swizzled rows, which are
// the wgmma descriptors' layout: S = Q K^T is wgmma m64n64k16 with Q and K
// from shared memory (both K-major), D / 16 steps, each in its panel; O +=
// P V is wgmma with P from registers (the S accumulator's layout is the A
// fragment's, so P never leaves registers) and V read in its natural
// [keys, D] layout as a transposed (MN-major) B: no transposing stores; at
// D = 128 one m64n128k16 a step spans both V panels (the descriptor's
// leading byte offset is the panel stride). Under a window the producer
// starts the ring at the block's first tile of the band and each consumer
// at its own rows' first, waiting on and releasing the tiles it skips.
// Softmax uses exp2 with log2(e)/sqrt(D) folded into one FMA; masks are
// evaluated only on tiles that cross the diagonal, the band's lower edge
// or the Tk edge. P is not rounded to bf16 (the TPU kernel keeps it in
// fp32): each p is split into a bf16 pair, hi + lo, and P V runs once for
// each, so p keeps 16 significant bits. Rounding p to bf16 instead cost
// 0.058 in the unnormalized o at the LM case (tolerance 2e-2), where up to
// 2048 rounded terms add up before the divide by l; that variant is built
// too, at D = 64 without a window, for measurement only (route 3). At the
// LM case the kernel is bound by the consumers' instruction issue (softmax
// and the split), not by its loads: a ring of 2 or 4 stages timed as 3
// does, and a third consumer warpgroup (more warps to hide the softmax's
// latencies) was faster than two. At D = 128 each P element carries twice
// the products, so the tensor cores' share of the time is larger.
// mma.sync (bf16, other head dims; forced, any): one block of 4 warps per
// 64-row query tile, mma.sync m16n8k16, tiles staged through shared memory
// with V transposed, P split as above.
// fp32: FMA on the CUDA cores (tensor cores would round to TF32 and miss
// the 1e-5 parity), 32 query rows per block, 4 threads per row, each
// holding every 4th value of the head dim; the dot products reduce across
// the 4 by shuffles.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

using sm90::bits;
using sm90::ex2;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int NT = 128;  // 4 warps (fp32 and mma.sync routes)

// element strides of a [B][T][H][D] input (D has unit stride)
struct Strides {
  long long b, t, h;
};

__device__ __forceinline__ size_t at(const Strides& s, int b, int t, int h) {
  return b * s.b + t * s.t + h * s.h;
}

// index of element (b, t, h, 0) of a contiguous [B][T][H][D] state array
__device__ __forceinline__ size_t state_at(int b, int t, int h, int len,
                                           int heads, int dim) {
  return ((static_cast<size_t>(b) * len + t) * heads + h) * dim;
}

__device__ __forceinline__ bool allowed(int kind, int row, int col, int tk) {
  return col < tk && (kind == 0 || (kind == 1 && row >= col));
}

// kind's mask, and under a window W also row - col < W
template <bool kWindow>
__device__ __forceinline__ bool visible(int kind, int row, int col, int tk,
                                        int window) {
  return allowed(kind, row, col, tk) && (!kWindow || row - col < window);
}

// the first K/V tile of bk keys that a window W leaves to query rows from
// q0 on: the one holding key q0 - W + 1 (0 without a window)
template <bool kWindow>
__device__ __forceinline__ int first_tile(int q0, int window, int bk) {
  return kWindow ? max(0, q0 - window + 1) / bk : 0;
}

// K/V tiles of bk keys to absorb for query rows up to `last`: kind 1 stops
// at the diagonal, kind 2 absorbs none.
__device__ __forceinline__ int tiles_for(int kind, int last, int tk, int bk) {
  if (kind == 2) return 0;
  const int n = (tk + bk - 1) / bk;
  return kind == 1 ? min(n, last / bk + 1) : n;
}

// ---------------------------------------------------------------- fp32, FMA

namespace fp32 {

constexpr int BQ = 32;  // query rows per block, 4 threads each
constexpr int BK = 32;  // keys per shared-memory tile

// DP: head dim rounded up to 16, 32, 64 or 128; kWindow: mask and skip by
// `window` (flash_window_kernel) or not (flash_kernel)
template <int DP, bool kWindow>
__device__ __forceinline__ void absorb(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, Strides qs, Strides ks_, Strides vs_,
    const float* __restrict__ m_in,
    const float* __restrict__ l_in, const float* __restrict__ o_in,
    float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ o_out, int heads, int tq, int tk, int dim, int kind,
    int window, float scale) {
  constexpr int DS = DP / 4;  // head-dim values per thread
  __shared__ float ks[BK][DP];
  __shared__ float vs[BK][DP];
  const int bh = blockIdx.x, b = bh / heads, h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int part = threadIdx.x % 4, row = q0 + threadIdx.x / 4;
  const bool live = row < tq;
  const size_t qo = at(qs, b, row, h);
  const size_t so = state_at(b, row, h, tq, heads, dim);
  const size_t ml = static_cast<size_t>(bh) * tq + row;

  float qr[DS], acc[DS];
#pragma unroll
  for (int i = 0; i < DS; ++i) {
    const int d = part + 4 * i;
    qr[i] = live && d < dim ? q[qo + d] : 0.f;
    acc[i] = live && d < dim ? o_in[so + d] : 0.f;
  }
  float m = live ? m_in[ml] : NEG_INF;
  float l = live ? l_in[ml] : 0.f;

  const int n_tiles = tiles_for(kind, min(q0 + BQ, tq) - 1, tk, BK);
  for (int t = first_tile<kWindow>(q0, window, BK); t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < BK * DP; e += NT) {
      const int j = e / DP, d = e % DP, key = k0 + j;
      const bool in = key < tk && d < dim;
      ks[j][d] = in ? k[at(ks_, b, key, h) + d] : 0.f;
      vs[j][d] = in ? v[at(vs_, b, key, h) + d] : 0.f;
    }
    __syncthreads();

    float s[BK];
    float m_blk = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DS; ++i) dot = fmaf(qr[i], ks[j][part + 4 * i], dot);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      s[j] = visible<kWindow>(kind, row, k0 + j, tk, window) ? dot * scale
                                                              : NEG_INF;
      m_blk = fmaxf(m_blk, s[j]);
    }
    const float m_new = fmaxf(m, m_blk);
    const float corr = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = visible<kWindow>(kind, row, k0 + j, tk, window)
                 ? expf(s[j] - m_new)
                 : 0.f;
      sum += s[j];
    }
    m = m_new;
    l = l * corr + sum;
#pragma unroll
    for (int i = 0; i < DS; ++i) {
      float o = acc[i] * corr;
#pragma unroll
      for (int j = 0; j < BK; ++j) o = fmaf(s[j], vs[j][part + 4 * i], o);
      acc[i] = o;
    }
  }

  if (!live) return;
  if (part == 0) {
    m_out[ml] = m;
    l_out[ml] = l;
  }
#pragma unroll
  for (int i = 0; i < DS; ++i) {
    const int d = part + 4 * i;
    if (d < dim) o_out[so + d] = acc[i];
  }
}

template <int DP>
__global__ void __launch_bounds__(NT)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, Strides qs, Strides ks_,
             Strides vs_, const float* __restrict__ m_in,
             const float* __restrict__ l_in, const float* __restrict__ o_in,
             float* __restrict__ m_out, float* __restrict__ l_out,
             float* __restrict__ o_out, int heads, int tq, int tk, int dim,
             int kind, float scale) {
  absorb<DP, false>(q, k, v, qs, ks_, vs_, m_in, l_in, o_in, m_out, l_out,
                    o_out, heads, tq, tk, dim, kind, 0, scale);
}

template <int DP>
__global__ void __launch_bounds__(NT)
flash_window_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, Strides qs, Strides ks_,
                    Strides vs_, const float* __restrict__ m_in,
                    const float* __restrict__ l_in,
                    const float* __restrict__ o_in, float* __restrict__ m_out,
                    float* __restrict__ l_out, float* __restrict__ o_out,
                    int heads, int tq, int tk, int dim, int kind, int window,
                    float scale) {
  absorb<DP, true>(q, k, v, qs, ks_, vs_, m_in, l_in, o_in, m_out, l_out,
                   o_out, heads, tq, tk, dim, kind, window, scale);
}

}  // namespace fp32

// ---------------------------------------------------- bf16, mma.sync route

namespace tc {

constexpr int BQ = 64;  // query rows per block: one m16 tile per warp
constexpr int BK = 64;  // keys per shared-memory tile
using sm90::mma;
using sm90::split;

__device__ __forceinline__ uint32_t ld32(const bits* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 8 bf16 of row t at head-dim offset c, or zeros outside the array
__device__ __forceinline__ uint4 load8(const bits* __restrict__ x,
                                       const Strides& s, int b, int t, int h,
                                       int c, int len, int dim) {
  if (t >= len || c >= dim) return make_uint4(0, 0, 0, 0);
  return *reinterpret_cast<const uint4*>(x + at(s, b, t, h) + c);
}

// DP: head dim rounded up to 16, 32, 64 or 128; kWindow as in fp32::absorb
template <int DP, bool kWindow>
__device__ __forceinline__ void absorb(
    const bits* __restrict__ q, const bits* __restrict__ k,
    const bits* __restrict__ v, Strides qs, Strides kst, Strides vst,
    const float* __restrict__ m_in,
    const float* __restrict__ l_in, const float* __restrict__ o_in,
    float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ o_out, int heads, int tq, int tk, int dim, int kind,
    int window, float scale) {
  constexpr int CH = DP / 8;  // 16-byte chunks in a row
  // Rows padded by 8 bf16: with row strides of 4 * odd words, a warp's
  // fragment loads (8 rows x 4 words) hit 32 distinct banks.
  __shared__ __align__(16) bits ks[BK][DP + 8];  // K tile; Q staged here first
  __shared__ __align__(16) bits vt[DP][BK + 8];  // V tile, transposed
  const int bh = blockIdx.x, b = bh / heads, h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8

  for (int e = threadIdx.x; e < BQ * CH; e += NT) {
    const int r = e / CH, c = (e % CH) * 8;
    *reinterpret_cast<uint4*>(&ks[r][c]) =
        load8(q, qs, b, q0 + r, h, c, tq, dim);
  }
  __syncthreads();
  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int c = kk * 16 + 2 * tig;
    qf[kk][0] = ld32(&ks[r0][c]);
    qf[kk][1] = ld32(&ks[r0 + 8][c]);
    qf[kk][2] = ld32(&ks[r0][c + 8]);
    qf[kk][3] = ld32(&ks[r0 + 8][c + 8]);
  }

  float m[2], l[2], acc[DP / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    const bool live = row < tq;
    const size_t ml = static_cast<size_t>(bh) * tq + row;
    m[i] = live ? m_in[ml] : NEG_INF;
    l[i] = live ? l_in[ml] : 0.f;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = n * 8 + 2 * tig;
      const float2 o = live && d < dim
          ? *reinterpret_cast<const float2*>(
                o_in + state_at(b, row, h, tq, heads, dim) + d)
          : make_float2(0.f, 0.f);
      acc[n][2 * i] = o.x;
      acc[n][2 * i + 1] = o.y;
    }
  }

  const int n_tiles = tiles_for(kind, min(q0 + BQ, tq) - 1, tk, BK);
  for (int t = first_tile<kWindow>(q0, window, BK); t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // every warp is done with Q's staging / the last tile
    for (int e = threadIdx.x; e < BK * CH; e += NT) {
      const int j = e / CH, c = (e % CH) * 8;
      *reinterpret_cast<uint4*>(&ks[j][c]) =
          load8(k, kst, b, k0 + j, h, c, tk, dim);
      const uint4 w = load8(v, vst, b, k0 + j, h, c, tk, dim);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int x = 0; x < 8; ++x)
        vt[c + x][j] = static_cast<bits>(words[x / 2] >> (16 * (x % 2)));
    }
    __syncthreads();

    // S = Q K^T: this warp's 16 rows x BK keys, 8 n8 tiles
    float s[BK / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int c = kk * 16 + 2 * tig;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
        mma(s[n], qf[kk], ld32(&ks[n * 8 + g][c]), ld32(&ks[n * 8 + g][c + 8]));
    }

    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + r0 + 8 * (e / 2);
        const int col = k0 + n * 8 + 2 * tig + e % 2;
        s[n][e] = visible<kWindow>(kind, row, col, tk, window)
                      ? s[n][e] * scale
                      : NEG_INF;
        mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // the 4 lanes of a quad share a row
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + r0 + 8 * (e / 2);
        const int col = k0 + n * 8 + 2 * tig + e % 2;
        s[n][e] = visible<kWindow>(kind, row, col, tk, window)
                      ? expf(s[n][e] - m[e / 2])
                      : 0.f;
        sum[e / 2] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * corr[i] + sum[i];
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e / 2];

    // O += P V, P as hi + lo; the A fragment of keys 16kk..16kk+15 is S
    // tiles 2kk, 2kk+1
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
      const int c = kk * 16 + 2 * tig;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const uint32_t b0 = ld32(&vt[n * 8 + g][c]);
        const uint32_t b1 = ld32(&vt[n * 8 + g][c + 8]);
        mma(acc[n], hi, b0, b1);
        mma(acc[n], lo, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    if (row >= tq) continue;
    const size_t ml = static_cast<size_t>(bh) * tq + row;
    if (tig == 0) {
      m_out[ml] = m[i];
      l_out[ml] = l[i];
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = n * 8 + 2 * tig;
      if (d < dim)
        *reinterpret_cast<float2*>(
            o_out + state_at(b, row, h, tq, heads, dim) + d) =
            make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(NT)
flash_kernel(const bits* __restrict__ q, const bits* __restrict__ k,
             const bits* __restrict__ v, Strides qs, Strides kst,
             Strides vst, const float* __restrict__ m_in,
             const float* __restrict__ l_in, const float* __restrict__ o_in,
             float* __restrict__ m_out, float* __restrict__ l_out,
             float* __restrict__ o_out, int heads, int tq, int tk, int dim,
             int kind, float scale) {
  absorb<DP, false>(q, k, v, qs, kst, vst, m_in, l_in, o_in, m_out, l_out,
                    o_out, heads, tq, tk, dim, kind, 0, scale);
}

template <int DP>
__global__ void __launch_bounds__(NT)
flash_window_kernel(const bits* __restrict__ q, const bits* __restrict__ k,
                    const bits* __restrict__ v, Strides qs, Strides kst,
                    Strides vst, const float* __restrict__ m_in,
                    const float* __restrict__ l_in,
                    const float* __restrict__ o_in, float* __restrict__ m_out,
                    float* __restrict__ l_out, float* __restrict__ o_out,
                    int heads, int tq, int tk, int dim, int kind, int window,
                    float scale) {
  absorb<DP, true>(q, k, v, qs, kst, vst, m_in, l_in, o_in, m_out, l_out,
                   o_out, heads, tq, tk, dim, kind, window, scale);
}

}  // namespace tc

// ------------------------------------------------------- bf16, wgmma route

namespace wg {

constexpr int BK = 64;    // keys per K/V tile
constexpr int ROW = 128;  // bytes of one swizzled row: 64 bf16 of a panel
constexpr int PANEL = BK * ROW;  // 8 KB: 64 head-dim columns of a K/V tile
constexpr int PRODUCER_REGS = 24;

// The shape of a block at head dim D (64 or 128). A row of D bf16 is D / 64
// panels of 64 columns, each TMA-loaded as its own box (a 128-byte-swizzled
// box is at most 128 bytes wide) into a region of its own. D = 64 runs
// three consumer warpgroups; D = 128 two, which leaves each 240 registers
// for O (64 a thread), S (32) and P's hi and lo fragments (32).
// Registers: the block is launched with 65536 / NT each (in steps of 8);
// the producer gives up all but PRODUCER_REGS and the consumers take them.
// setmaxnreg.inc waits until what it asks for is free, so asking for more
// than the block holds would hang.
template <int D>
struct Shape {
  static constexpr int PANELS = D / 64;
  static constexpr int CW = D == 64 ? 3 : 2;  // consumers, 64 query rows each
  static constexpr int BQ = 64 * CW;          // query rows per block
  static constexpr int STAGES = 3;            // K/V tiles in flight
  static constexpr int NT = 128 * (CW + 1);   // consumers 0 .. CW-1, producer CW
  static constexpr int CONSUMER_REGS =
      (65536 / NT / 8 * 8 * NT - 128 * PRODUCER_REGS) / (128 * CW) / 8 * 8;
  static constexpr int QPANEL = BQ * ROW;       // one panel of the Q block
  static constexpr int QBYTES = PANELS * QPANEL;
  static constexpr int TILE = PANELS * PANEL;   // one K or V tile
  // tiles on 1024-byte boundaries (the swizzle atom), then 2 * STAGES + 1
  // mbarriers; 1024 bytes of slack to align the dynamic buffer
  static constexpr int SMEM =
      1024 + QBYTES + 2 * STAGES * TILE + 8 * (2 * STAGES + 1);
};

// descriptors: K-major (Q, K: the head dim contiguous) and MN-major (V:
// the head dim, wgmma's N, contiguous); either way 8-row groups of 128-byte
// rows are 1024 bytes apart (SBO). LBO is unused for 64 columns; an N of
// 128 spans V's two panels, a panel (PANEL bytes) apart.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return sm90::sw128_desc(addr, 1, 1024 >> 4);
}

// The body of flash_kernel (kWindow false) and flash_window_kernel.
// Accumulator layout of m64nN (warp w of the warpgroup, g = lane / 4,
// tig = lane % 4): element 4j + e at row 16w + g + 8(e/2), column
// 8j + 2tig + e%2; for S the column is a key, for O a head-dim index.
template <int D, bool kSplitP, bool kWindow>
__device__ __forceinline__ void absorb(
    const CUtensorMap& q_map, const CUtensorMap& k_map,
    const CUtensorMap& v_map, const float* __restrict__ m_in,
    const float* __restrict__ l_in, const float* __restrict__ o_in,
    float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ o_out, int heads, int tq, int tk, int kind,
    int window, float scale) {
  using S = Shape<D>;
  constexpr int STAGES = S::STAGES, CW = S::CW, BQ = S::BQ, TILE = S::TILE;
  extern __shared__ uint8_t raw[];
  const uint32_t base = (sm90::smem_u32(raw) + 1023) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk = sq + S::QBYTES;        // STAGES K tiles
  const uint32_t sv = sk + STAGES * TILE;    // STAGES V tiles
  const uint32_t bars = sv + STAGES * TILE;  // full[S], empty[S], q
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const uint32_t qbar = bars + 16 * STAGES;

  const int bh = blockIdx.x, b = bh / heads, h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int n_tiles = tiles_for(kind, min(q0 + BQ, tq) - 1, tk, BK);
  // the block's first tile; the ring counts from it
  const int t0 = first_tile<kWindow>(q0, window, BK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(full(s), 1);   // the producer's expect_tx
      sm90::mbar_init(empty(s), 4 * CW);  // an arrival per consumer warp
    }
    sm90::mbar_init(qbar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int group = threadIdx.x / 128;
  if (group == CW) {  // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 128 * CW) {
      sm90::mbar_expect_tx(qbar, S::QBYTES);
#pragma unroll
      for (int p = 0; p < S::PANELS; ++p)
        sm90::tma_load_4d(sq + p * S::QPANEL, &q_map, qbar, 64 * p, h, q0, b);
      for (int t = t0; t < n_tiles; ++t) {
        const int n = t - t0, s = n % STAGES;
        if (n >= STAGES)  // every consumer is done with tile t - STAGES
          sm90::mbar_wait(empty(s), (n / STAGES - 1) & 1);
        sm90::mbar_expect_tx(full(s), 2 * TILE);
#pragma unroll
        for (int p = 0; p < S::PANELS; ++p)
          sm90::tma_load_4d(sk + s * TILE + p * PANEL, &k_map, full(s),
                            64 * p, h, t * BK, b);
#pragma unroll
        for (int p = 0; p < S::PANELS; ++p)
          sm90::tma_load_4d(sv + s * TILE + p * PANEL, &v_map, full(s),
                            64 * p, h, t * BK, b);
      }
    }
    return;
  }

  // consumer warpgroup `group`: 64 query rows from row0
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(S::CONSUMER_REGS));
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int g = lane / 4, tig = lane % 4;
  const int row0 = q0 + 64 * group;
  const int r = row0 + 16 * warp + g;  // this thread's rows: r and r + 8
  const int my_tiles =
      row0 < tq ? tiles_for(kind, min(row0 + 64, tq) - 1, tk, BK) : 0;
  const int my_first = first_tile<kWindow>(row0, window, BK);
  const float sl2 = scale * LOG2E;
  const float minus_inf = __int_as_float(0xff800000);

  float m[2], l[2], acc[D / 2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r + 8 * i;
    const bool live = row < tq;
    const size_t ml = static_cast<size_t>(bh) * tq + row;
    m[i] = live ? m_in[ml] : NEG_INF;
    l[i] = live ? l_in[ml] : 0.f;
    const float* src = o_in + state_at(b, row, h, tq, heads, D) + 2 * tig;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float2 o = live ? *reinterpret_cast<const float2*>(src + 8 * j)
                            : make_float2(0.f, 0.f);
      acc[4 * j + 2 * i] = o.x;
      acc[4 * j + 2 * i + 1] = o.y;
    }
  }

  sm90::mbar_wait(qbar, 0);
  const uint32_t qa = sq + 64 * group * ROW;
  for (int t = t0; t < n_tiles; ++t) {
    const int n = t - t0, s = n % STAGES;
    // wait even for a tile this warpgroup skips (before its band or past
    // its diagonal): its release below must count towards this round of
    // the stage, not the previous one
    sm90::mbar_wait(full(s), (n / STAGES) & 1);
    if ((!kWindow || t >= my_first) && t < my_tiles) {
      const int k0 = t * BK;
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {  // 16 head-dim values a step
        const uint32_t off = 32 * (kk % 4);  // within panel kk / 4
        sm90::wgmma_ss<0>(sc, desc(qa + kk / 4 * S::QPANEL + off),
                          desc(sk + s * TILE + kk / 4 * PANEL + off), kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::reg_fence(sc);

      // raw scores; masked ones -inf, so they never raise the max and
      // exp2 turns them into 0 (also against m = NEG_INF). Only a tile
      // that crosses the Tk edge, the diagonal or the band's lower edge
      // (row - col >= W for its last row and first key) is masked.
      if (k0 + BK > tk || (kind == 1 && k0 + BK - 1 > row0)
          || (kWindow && row0 + 63 - k0 >= window)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int row = r + 8 * ((i % 4) / 2);
          const int col = k0 + 8 * (i / 4) + 2 * tig + i % 2;
          if (!visible<kWindow>(kind, row, col, tk, window))
            sc[i] = minus_inf;
        }
      }
      float mx[2] = {minus_inf, minus_inf};
#pragma unroll
      for (int i = 0; i < 32; ++i)
        mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], sc[i]);
      float corr[2], neg[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // the 4 lanes of a quad share a row
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i] * scale);
        corr[i] = ex2((m[i] - m_new) * LOG2E);
        neg[i] = -m_new * LOG2E;
        m[i] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc[i] = ex2(fmaf(sc[i], sl2, neg[(i % 4) / 2]));
        sum[(i % 4) / 2] += sc[i];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
        l[i] = l[i] * corr[i] + sum[i];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i % 4) / 2];

      // P as A fragments: keys 16kk..16kk+15 are S columns 8(2kk) ..,
      // i.e. accumulator elements 8kk .. 8kk+7, in the A order
      // (row g, cols 0-1), (row g+8, cols 0-1), (row g, 8-9), (row g+8, 8-9)
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float a = sc[8 * kk + 2 * x], c = sc[8 * kk + 2 * x + 1];
          if (kSplitP)
            sm90::split(a, c, hi[kk][x], lo[kk][x]);
          else
            hi[kk][x] = sm90::pack(a, c);
        }
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // 16 keys a step: 16 rows of V
        const uint32_t rows = sv + s * TILE + 16 * kk * ROW;
        if constexpr (D == 64) {
          const uint64_t dv = desc(rows);
          sm90::wgmma_rs_tb(acc, hi[kk], dv);
          if (kSplitP) sm90::wgmma_rs_tb(acc, lo[kk], dv);
        } else {  // N = 128 over V's two panels
          const uint64_t dv = sm90::sw128_desc(rows, PANEL >> 4, 1024 >> 4);
          sm90::wgmma_rs_tb_n128(acc, hi[kk], dv);
          if (kSplitP) sm90::wgmma_rs_tb_n128(acc, lo[kk], dv);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::reg_fence(acc);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty(s));  // this warp is done with s
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r + 8 * i;
    if (row >= tq) continue;
    const size_t ml = static_cast<size_t>(bh) * tq + row;
    if (tig == 0) {
      m_out[ml] = m[i];
      l_out[ml] = l[i];
    }
    float* dst = o_out + state_at(b, row, h, tq, heads, D) + 2 * tig;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
}

template <int D, bool kSplitP>
__global__ void __launch_bounds__(Shape<D>::NT, 1)
flash_kernel(const __grid_constant__ CUtensorMap q_map,
             const __grid_constant__ CUtensorMap k_map,
             const __grid_constant__ CUtensorMap v_map,
             const float* __restrict__ m_in, const float* __restrict__ l_in,
             const float* __restrict__ o_in, float* __restrict__ m_out,
             float* __restrict__ l_out, float* __restrict__ o_out, int heads,
             int tq, int tk, int kind, float scale) {
  absorb<D, kSplitP, false>(q_map, k_map, v_map, m_in, l_in, o_in, m_out,
                            l_out, o_out, heads, tq, tk, kind, 0, scale);
}

template <int D>
__global__ void __launch_bounds__(Shape<D>::NT, 1)
flash_window_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const float* __restrict__ m_in,
                    const float* __restrict__ l_in,
                    const float* __restrict__ o_in, float* __restrict__ m_out,
                    float* __restrict__ l_out, float* __restrict__ o_out,
                    int heads, int tq, int tk, int kind, int window,
                    float scale) {
  absorb<D, true, true>(q_map, k_map, v_map, m_in, l_in, o_in, m_out, l_out,
                        o_out, heads, tq, tk, kind, window, scale);
}

// 4-D map over a bf16 [batch][len][heads][dim] input with element strides
// st, boxes of `rows` rows of 64 head-dim columns of one head, 128-byte
// swizzled; rows past len read as zeros
bool make_map(CUtensorMap* map, const void* ptr, const Strides& st,
              int batch, int len, int heads, int dim, int rows) {
  const sm90::EncodeTiled encode = sm90::encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {cuuint64_t(dim), cuuint64_t(heads),
                              cuuint64_t(len), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(st.h) * 2, cuuint64_t(st.t) * 2,
                                 cuuint64_t(st.b) * 2};
  const cuuint32_t box[4] = {ROW / 2, 1, cuuint32_t(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// kWindow: flash_window_kernel (P split), else flash_kernel<D, kSplitP>
template <int D, bool kSplitP, bool kWindow>
int launch(const void* q, const void* k, const void* v, const Strides* st,
           const float* mi, const float* li, const float* oi, float* mo,
           float* lo, float* oo, int batch, int heads, int tq, int tk,
           int kind, int window, float scale, cudaStream_t s) {
  using S = Shape<D>;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, st[0], batch, tq, heads, D, S::BQ)
      || !make_map(&km, k, st[1], batch, tk, heads, D, BK)
      || !make_map(&vm, v, st[2], batch, tk, heads, D, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(batch * heads, (tq + S::BQ - 1) / S::BQ);
  if constexpr (kWindow) {
    auto kernel = flash_window_kernel<D>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    kernel<<<grid, S::NT, S::SMEM, s>>>(qm, km, vm, mi, li, oi, mo, lo, oo,
                                        heads, tq, tk, kind, window, scale);
  } else {
    auto kernel = flash_kernel<D, kSplitP>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    kernel<<<grid, S::NT, S::SMEM, s>>>(qm, km, vm, mi, li, oi, mo, lo, oo,
                                        heads, tq, tk, kind, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

template <class Kernel>
Kernel pick(int dim, Kernel k16, Kernel k32, Kernel k64, Kernel k128) {
  return dim <= 16 ? k16 : dim <= 32 ? k32 : dim <= 64 ? k64 : k128;
}

}  // namespace

extern "C" {

// route: 0 = fp32 on FMA; 1 = bf16 on mma.sync; 2 = bf16 on wgmma with
// TMA (head dim 64 or 128, at least one key); 3 = route 2 with P rounded to
// bf16 (measurement only: head dim 64, no window). q [batch][tq][heads][dim], k, v [batch][tk][heads][dim], each
// with element strides (b, t, h) at strides[0..2], [3..5], [6..8] and a
// unit-stride head dim; routes 1-3 need 16-byte aligned bases and strides.
// m, l, m_out, l_out: [batch][heads][tq]; o, o_out: [batch][tq][heads][dim],
// contiguous fp32. kind: 0 all, 1 causal (call-local row >= col), 2 none.
// window: 0 none, else keys col with row - col < window only (routes 0 to
// 2, through flash_window_kernel). Returns the CUDA error of the launch (0 on
// success).
int vtpu_flash_absorb(int route, const void* q, const void* k, const void* v,
                      const long long* strides, const void* m, const void* l,
                      const void* o, void* m_out, void* l_out, void* o_out,
                      int batch, int heads, int tq, int tk, int dim, int kind,
                      int window, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || tq <= 0 || tk < 0 || dim <= 0
      || dim > 128 || kind < 0 || kind > 2 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides st[3] = {{strides[0], strides[1], strides[2]},
                         {strides[3], strides[4], strides[5]},
                         {strides[6], strides[7], strides[8]}};
  const auto* mi = static_cast<const float*>(m);
  const auto* li = static_cast<const float*>(l);
  const auto* oi = static_cast<const float*>(o);
  auto* mo = static_cast<float*>(m_out);
  auto* lo = static_cast<float*>(l_out);
  auto* oo = static_cast<float*>(o_out);
  if (route == 0) {
    const dim3 grid(batch * heads, (tq + fp32::BQ - 1) / fp32::BQ);
    if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const auto* fq = static_cast<const float*>(q);
    const auto* fk = static_cast<const float*>(k);
    const auto* fv = static_cast<const float*>(v);
    if (window > 0) {
      auto kernel = pick(dim, fp32::flash_window_kernel<16>,
                         fp32::flash_window_kernel<32>,
                         fp32::flash_window_kernel<64>,
                         fp32::flash_window_kernel<128>);
      kernel<<<grid, NT, 0, s>>>(fq, fk, fv, st[0], st[1], st[2], mi, li, oi,
                                 mo, lo, oo, heads, tq, tk, dim, kind, window,
                                 scale);
    } else {
      auto kernel = pick(dim, fp32::flash_kernel<16>, fp32::flash_kernel<32>,
                         fp32::flash_kernel<64>, fp32::flash_kernel<128>);
      kernel<<<grid, NT, 0, s>>>(fq, fk, fv, st[0], st[1], st[2], mi, li, oi,
                                 mo, lo, oo, heads, tq, tk, dim, kind, scale);
    }
  } else if (route == 1) {
    const dim3 grid(batch * heads, (tq + tc::BQ - 1) / tc::BQ);
    if (dim % 8 || grid.y > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    const auto* bq = static_cast<const bits*>(q);
    const auto* bk = static_cast<const bits*>(k);
    const auto* bv = static_cast<const bits*>(v);
    if (window > 0) {
      auto kernel = pick(dim, tc::flash_window_kernel<16>,
                         tc::flash_window_kernel<32>,
                         tc::flash_window_kernel<64>,
                         tc::flash_window_kernel<128>);
      kernel<<<grid, NT, 0, s>>>(bq, bk, bv, st[0], st[1], st[2], mi, li, oi,
                                 mo, lo, oo, heads, tq, tk, dim, kind, window,
                                 scale);
    } else {
      auto kernel = pick(dim, tc::flash_kernel<16>, tc::flash_kernel<32>,
                         tc::flash_kernel<64>, tc::flash_kernel<128>);
      kernel<<<grid, NT, 0, s>>>(bq, bk, bv, st[0], st[1], st[2], mi, li, oi,
                                 mo, lo, oo, heads, tq, tk, dim, kind, scale);
    }
  } else if (route == 2 || route == 3) {
    // route 3 (measurement only) keeps to the LM's case: D = 64, no window
    const int bq = dim == 64 ? wg::Shape<64>::BQ : wg::Shape<128>::BQ;
    if ((dim != 64 && dim != 128) || tk == 0
        || (route == 3 && (dim != 64 || window > 0))
        || (tq + bq - 1) / bq > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    if (route == 3)
      return wg::launch<64, false, false>(q, k, v, st, mi, li, oi, mo, lo, oo,
                                          batch, heads, tq, tk, kind, 0,
                                          scale, s);
    if (dim == 64)
      return window > 0
          ? wg::launch<64, true, true>(q, k, v, st, mi, li, oi, mo, lo, oo,
                                       batch, heads, tq, tk, kind, window,
                                       scale, s)
          : wg::launch<64, true, false>(q, k, v, st, mi, li, oi, mo, lo, oo,
                                        batch, heads, tq, tk, kind, 0, scale,
                                        s);
    return window > 0
        ? wg::launch<128, true, true>(q, k, v, st, mi, li, oi, mo, lo, oo,
                                      batch, heads, tq, tk, kind, window,
                                      scale, s)
        : wg::launch<128, true, false>(q, k, v, st, mi, li, oi, mo, lo, oo,
                                       batch, heads, tq, tk, kind, 0, scale,
                                       s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* vtpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
