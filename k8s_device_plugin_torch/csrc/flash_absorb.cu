// Flash-attention absorb: folds K/V into a carried streaming-softmax state
// (running max m, normalizer l, accumulator o), one launch per call.
//
// Replaces the Pallas kernel of k8s_device_plugin_tpu/workloads/flash.py
// (_flash_kernel, lines 60-116, launched by _flash_absorb_impl at line 158
// under flash_absorb). Same semantics: s = q.k^T / sqrt(D) in fp32, a
// runtime mask kind (0 attends to all, 1 is causal on call-local
// row >= col, 2 masks all), and the state carried in and out: m, l
// [B][H][Tq] and o [B][Tq][H][D] in fp32; q, k, v [B][T][H][D], bf16 or
// fp32. The new state goes to separate output arrays.
//
// Update form: FA2's. Per K/V tile, m_new = max(m, max_row s),
// corr = exp(m - m_new), p = exp(s - m_new), l = l corr + sum p,
// o = o corr + p V. The TPU kernel takes p against the tile's own max and
// scales the tile's sums by exp(m_blk - m_new) (blk_corr); the two agree up
// to rounding. Masked entries give p = 0, also in rows with nothing visible
// yet, where the TPU kernel zeroes p because m_blk == NEG_INF. NEG_INF is
// -1e30, never -inf, so the identity state's m - m_new is 0, not NaN.
//
// What bounds it: at the LM case (B=8, T=2048, H=8, D=64, bf16, causal, one
// absorb from the identity state) the call must move 119.5 MB (q, k, v
// 50.3 MB; o read and written in fp32 67.1 MB; m, l 2.1 MB), 35.7 us at
// 3.35 TB/s, and do 34.4 GFLOP of products over the causal half, 34.8 us
// at 989 TFLOP/s. Bytes and operations are nearly balanced, bytes a little
// ahead: the bound is about 36 us. This first version is far from it: its
// products run on mma.sync (not wgmma) and its tile loads are not
// pipelined (no cp.async or TMA), which is the later work.
//
// Design: one block of 4 warps per (query tile, b*h), the heaviest causal
// tiles scheduled first. A loop over K/V tiles inside the block takes the
// place of the TPU's sequential grid dimension; each tile is staged in
// shared memory, zero-filled past Tk and past D, so any Tq, Tk and D <= 128
// work with ragged tiles masked (the TPU fitted tiles to divisors of T).
// Per-row m and l and the o accumulator stay in fp32 registers for the
// whole loop. kind 1 skips tiles wholly above the diagonal and kind 2
// absorbs no tile; both are exact (they would add p = 0 with corr = 1), so
// kind 2 copies the state bit for bit.
//
// bf16 (the LM path): 64 query rows per block, one m16 tile per warp, Q
// held as mma A fragments for the whole loop. S = Q K^T and O += P V run as
// mma.sync m16n8k16 with fp32 accumulation, so the products of the bf16
// inputs are exact. P is NOT rounded to bf16 (the TPU kernel keeps it in
// fp32): each p is split into a bf16 pair, hi + lo, and P V takes two
// mma, one for each, so p keeps 16 significant bits (relative error below
// 2^-17). Rounding p to bf16 instead cost 0.058 in the unnormalized o at
// the LM case, where up to 2048 rounded terms add up before the divide by
// l. S's accumulator fragments are P's A fragments, so P never leaves
// registers; V is stored transposed so its B fragments are 32-bit shared
// loads, as K's are. Needs D % 8 == 0 and 16-byte aligned q, k, v (one
// 16-byte load per 8 values).
// fp32: FMA on the CUDA cores (tensor cores would round to TF32 and miss
// the 1e-5 parity), 32 query rows per block, 4 threads per row, each
// holding every 4th value of the head dim; the dot products reduce across
// the 4 by shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NT = 128;  // 4 warps

__device__ __forceinline__ bool allowed(int kind, int row, int col, int tk) {
  return col < tk && (kind == 0 || (kind == 1 && row >= col));
}

// K/V tiles of bk keys to absorb for query rows up to `last`: kind 1 stops
// at the diagonal, kind 2 absorbs none.
__device__ __forceinline__ int tiles_for(int kind, int last, int tk, int bk) {
  if (kind == 2) return 0;
  const int n = (tk + bk - 1) / bk;
  return kind == 1 ? min(n, last / bk + 1) : n;
}

// index of element (b, t, h, 0) of a [B][T][H][D] array
__device__ __forceinline__ size_t at(int b, int t, int h, int len, int heads,
                                     int dim) {
  return ((static_cast<size_t>(b) * len + t) * heads + h) * dim;
}

// ---------------------------------------------------------------- fp32, FMA

namespace fp32 {

constexpr int BQ = 32;  // query rows per block, 4 threads each
constexpr int BK = 32;  // keys per shared-memory tile

template <int DP>  // head dim rounded up to 16, 32, 64 or 128
__global__ void __launch_bounds__(NT)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ m_in,
             const float* __restrict__ l_in, const float* __restrict__ o_in,
             float* __restrict__ m_out, float* __restrict__ l_out,
             float* __restrict__ o_out, int heads, int tq, int tk, int dim,
             int kind, float scale) {
  constexpr int DS = DP / 4;  // head-dim values per thread
  __shared__ float ks[BK][DP];
  __shared__ float vs[BK][DP];
  const int bh = blockIdx.x, b = bh / heads, h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int part = threadIdx.x % 4, row = q0 + threadIdx.x / 4;
  const bool live = row < tq;
  const size_t qo = at(b, row, h, tq, heads, dim);
  const size_t ml = static_cast<size_t>(bh) * tq + row;

  float qr[DS], acc[DS];
#pragma unroll
  for (int i = 0; i < DS; ++i) {
    const int d = part + 4 * i;
    qr[i] = live && d < dim ? q[qo + d] : 0.f;
    acc[i] = live && d < dim ? o_in[qo + d] : 0.f;
  }
  float m = live ? m_in[ml] : NEG_INF;
  float l = live ? l_in[ml] : 0.f;

  const int n_tiles = tiles_for(kind, min(q0 + BQ, tq) - 1, tk, BK);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < BK * DP; e += NT) {
      const int j = e / DP, d = e % DP, key = k0 + j;
      const bool in = key < tk && d < dim;
      const size_t idx = in ? at(b, key, h, tk, heads, dim) + d : 0;
      ks[j][d] = in ? k[idx] : 0.f;
      vs[j][d] = in ? v[idx] : 0.f;
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
      s[j] = allowed(kind, row, k0 + j, tk) ? dot * scale : NEG_INF;
      m_blk = fmaxf(m_blk, s[j]);
    }
    const float m_new = fmaxf(m, m_blk);
    const float corr = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = allowed(kind, row, k0 + j, tk) ? expf(s[j] - m_new) : 0.f;
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
    if (d < dim) o_out[qo + d] = acc[i];
  }
}

}  // namespace fp32

// ------------------------------------------------------- bf16, tensor cores

namespace tc {

constexpr int BQ = 64;  // query rows per block: one m16 tile per warp
constexpr int BK = 64;  // keys per shared-memory tile
using bits = unsigned short;  // one bf16, moved as raw bits

__device__ __forceinline__ uint32_t ld32(const bits* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two floats as bf16x2, a in the low half (the lower column)
__device__ __forceinline__ uint32_t pack(float a, float b) {
  return uint32_t(__bfloat16_as_ushort(__float2bfloat16(a)))
       | (uint32_t(__bfloat16_as_ushort(__float2bfloat16(b))) << 16);
}

// a and b as two bf16x2 words, hi + lo: hi the rounded values, lo what
// rounding left (also rounded), so hi + lo keeps 16 significant bits
__device__ __forceinline__ void split(float a, float b, uint32_t& hi,
                                      uint32_t& lo) {
  hi = pack(a, b);
  lo = pack(a - __bfloat162float(__ushort_as_bfloat16(hi & 0xffffu)),
            b - __bfloat162float(__ushort_as_bfloat16(hi >> 16)));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 bf16 of row t at head-dim offset c, or zeros outside the array
__device__ __forceinline__ uint4 load8(const bits* __restrict__ x, int b,
                                       int t, int h, int c, int len,
                                       int heads, int dim) {
  if (t >= len || c >= dim) return make_uint4(0, 0, 0, 0);
  return *reinterpret_cast<const uint4*>(x + at(b, t, h, len, heads, dim) + c);
}

// Fragment layouts of m16n8k16 (g = lane / 4, tig = lane % 4): A element
// pairs at rows g, g+8 and columns 2tig, 2tig+8; B pairs at column g and
// rows 2tig, 2tig+8; C element e at row g + 8(e/2), column 2tig + e%2.
template <int DP>  // head dim rounded up to 16, 32, 64 or 128
__global__ void __launch_bounds__(NT)
flash_kernel(const bits* __restrict__ q, const bits* __restrict__ k,
             const bits* __restrict__ v, const float* __restrict__ m_in,
             const float* __restrict__ l_in, const float* __restrict__ o_in,
             float* __restrict__ m_out, float* __restrict__ l_out,
             float* __restrict__ o_out, int heads, int tq, int tk, int dim,
             int kind, float scale) {
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
        load8(q, b, q0 + r, h, c, tq, heads, dim);
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
                o_in + at(b, row, h, tq, heads, dim) + d)
          : make_float2(0.f, 0.f);
      acc[n][2 * i] = o.x;
      acc[n][2 * i + 1] = o.y;
    }
  }

  const int n_tiles = tiles_for(kind, min(q0 + BQ, tq) - 1, tk, BK);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // every warp is done with Q's staging / the last tile
    for (int e = threadIdx.x; e < BK * CH; e += NT) {
      const int j = e / CH, c = (e % CH) * 8;
      *reinterpret_cast<uint4*>(&ks[j][c]) =
          load8(k, b, k0 + j, h, c, tk, heads, dim);
      const uint4 w = load8(v, b, k0 + j, h, c, tk, heads, dim);
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
        s[n][e] = allowed(kind, row, col, tk) ? s[n][e] * scale : NEG_INF;
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
        s[n][e] = allowed(kind, row, col, tk) ? expf(s[n][e] - m[e / 2])
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
        *reinterpret_cast<float2*>(o_out + at(b, row, h, tq, heads, dim) + d) =
            make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
    }
  }
}

}  // namespace tc

template <class Kernel>
Kernel pick(int dim, Kernel k16, Kernel k32, Kernel k64, Kernel k128) {
  return dim <= 16 ? k16 : dim <= 32 ? k32 : dim <= 64 ? k64 : k128;
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16, for q, k, v; the state is fp32. q, o, o_out:
// [batch][tq][heads][dim]; k, v: [batch][tk][heads][dim]; m, l, m_out,
// l_out: [batch][heads][tq]; all row-major on the device. kind: 0 all,
// 1 causal (call-local row >= col), 2 none. Returns the CUDA error of the
// launch (0 on success).
int vtpu_flash_absorb(int dtype, const void* q, const void* k, const void* v,
                      const void* m, const void* l, const void* o,
                      void* m_out, void* l_out, void* o_out, int batch,
                      int heads, int tq, int tk, int dim, int kind,
                      float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || tq <= 0 || tk < 0 || dim <= 0
      || dim > 128 || kind < 0 || kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* mi = static_cast<const float*>(m);
  const auto* li = static_cast<const float*>(l);
  const auto* oi = static_cast<const float*>(o);
  auto* mo = static_cast<float*>(m_out);
  auto* lo = static_cast<float*>(l_out);
  auto* oo = static_cast<float*>(o_out);
  if (dtype == 0) {
    const dim3 grid(batch * heads, (tq + fp32::BQ - 1) / fp32::BQ);
    if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = pick(dim, fp32::flash_kernel<16>, fp32::flash_kernel<32>,
                       fp32::flash_kernel<64>, fp32::flash_kernel<128>);
    kernel<<<grid, NT, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), mi, li, oi, mo, lo, oo, heads, tq, tk,
        dim, kind, scale);
  } else if (dtype == 1) {
    const dim3 grid(batch * heads, (tq + tc::BQ - 1) / tc::BQ);
    if (dim % 8 || grid.y > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    using tc::bits;
    auto kernel = pick(dim, tc::flash_kernel<16>, tc::flash_kernel<32>,
                       tc::flash_kernel<64>, tc::flash_kernel<128>);
    kernel<<<grid, NT, 0, s>>>(
        static_cast<const bits*>(q), static_cast<const bits*>(k),
        static_cast<const bits*>(v), mi, li, oi, mo, lo, oo, heads, tq, tk,
        dim, kind, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* vtpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
