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
// Design, both paths: one block owns a tile of rows by hidden columns j of
// ALL FOUR gate slabs (columns j, H+j, 2H+j, 3H+j), so each thread ends
// the K loop holding i, f, g and o for its (row, j) pairs and finishes
// h'/c' in registers. x.Wx and h.Wh run as two K phases into one fp32
// accumulator. Ragged B, F and H are masked: loads outside the arrays
// read 0, stores outside are skipped, so no shape needs padding (the TPU
// kernel needed H, F % 128 == 0 and B % 8 == 0).
//
// bf16 (the case-5 path): tensor cores, mma.sync m16n8k16 with fp32
// accumulation. A block is 64 rows x 8 hidden columns, so its n8 tiles
// are exactly the four gates; each of 4 warps owns one m16 tile. With
// 128 column blocks at H = 1024 every SM streams its own slice of the
// weights. Tiles are staged through shared memory (padded so fragment
// loads hit 32 distinct banks), and the next tile's loads are in flight
// in registers while the current one multiplies.
// fp32: plain FMA on the CUDA cores (tensor cores would round to TF32),
// 64 rows x 16 columns per block, each thread 8 rows of one column.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 64;   // rows of the batch per block
constexpr int BJ = 16;   // hidden columns per block, in each of 4 slabs
constexpr int BK = 32;   // depth of one shared-memory tile
constexpr int NT = 128;  // threads: 16 columns x 8 row groups of 8 rows
constexpr int RT = BM / (NT / BJ);  // rows per thread (8)
constexpr int AS = BM + 4;  // padded row of the transposed A tile

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
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
  const float bi = b[j], bf = b[hidden + j];
  const float bg = b[2 * hidden + j], bo = b[3 * hidden + j];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int m = m0 + tr * RT + r;
    if (m >= rows) break;
    const size_t idx = static_cast<size_t>(m) * hidden + j;
    const float c_new = sigmoid(acc[r][1] + bf) * c[idx]
                      + sigmoid(acc[r][0] + bi) * tanhf(acc[r][2] + bg);
    h_out[idx] = sigmoid(acc[r][3] + bo) * tanhf(c_new);
    c_out[idx] = c_new;
  }
}

// ------------------------------------------------------- bf16, tensor cores

namespace tc {

constexpr int BM = 64;      // rows per block: one m16 tile per warp
constexpr int BJ = 8;       // hidden columns per block: one n8 tile per gate
constexpr int NT = 128;     // 4 warps
// A tile of depth BK = 64 is stored in rows of BK + 8 bf16, 36 words: 4
// times an odd number, so the 8 rows x 4 words of a warp's fragment load
// hit 32 distinct banks.
using bits = unsigned short;  // one bf16, moved as raw bits

__device__ __forceinline__ uint32_t ld32(const bits* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float bf(bits v) {
  return __bfloat162float(__ushort_as_bfloat16(v));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Up to 4 (8) bf16 from p, n of them inside the array, 0 for the rest.
// kVector: the launch guarantees every chunk is whole (n >= 4, resp. 8)
// or wholly outside (n <= 0) and aligned, so one 8- (16-) byte load or
// none; else one bf16 at a time. Element e lands in bits 16*(e%2) of
// word e/2 either way.
template <bool kVector>
__device__ __forceinline__ uint2 load4(const bits* p, int n) {
  if (kVector) return n > 0 ? *reinterpret_cast<const uint2*>(p)
                            : make_uint2(0, 0);
  uint32_t v[2] = {0, 0};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < n) v[e / 2] |= uint32_t(p[e]) << (16 * (e % 2));
  return make_uint2(v[0], v[1]);
}

template <bool kVector>
__device__ __forceinline__ uint4 load8(const bits* p, int n) {
  if (kVector) return n > 0 ? *reinterpret_cast<const uint4*>(p)
                            : make_uint4(0, 0, 0, 0);
  uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e < n) v[e / 2] |= uint32_t(p[e]) << (16 * (e % 2));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// A K tile, BK deep, is staged global -> registers -> shared memory, and
// the next tile's loads start before the current tile's MMAs, so they are
// in flight while the tensor cores work. Thread t always loads A's 4-wide
// chunk t % (BK/4) of rows t / (BK/4) + i * NT/(BK/4), and W's gate
// q = t % 4 (columns j0..j0+7) at depths t / 4 + i * NT/4. With
// depth % 4 == 0, hidden % 8 == 0 and aligned inputs (case 5.1) each chunk
// is one vector load (kVector): scalar 16-bit loads were five times the
// load instructions and bounded the kernel. Other shapes load element by
// element. A branch per chunk between the two, instead of one per launch,
// cost 16% at case 5.1 (0.0267 -> 0.0312 ms on the H100).
template <bool kVector>
struct Tile {
  static constexpr int BK = 64;
  static constexpr int CA = BK / 4;  // A chunks per tile row
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
      a[i] = am + i * (NT / CA) < rows ? load4<kVector>(p, depth - ak)
                                       : make_uint2(0, 0);
    }
    const int wk = k0 + t / 4;
    const bits* pw = gw + static_cast<size_t>(wk) * 4 * hidden
                   + static_cast<size_t>(t % 4) * hidden + j0;
#pragma unroll
    for (int i = 0; i < BK * 4 / NT; ++i) {
      const bits* p = pw + static_cast<size_t>(i) * (NT / 4) * 4 * hidden;
      w[i] = wk + i * (NT / 4) < depth ? load8<kVector>(p, hidden - j0)
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
template <class Tile>
__device__ void accumulate(const bits* __restrict__ a,
                           const bits* __restrict__ w, int rows, int depth,
                           int hidden, int m0, int j0,
                           bits (*as)[Tile::BK + 8], bits (*bs)[Tile::BK + 8],
                           float (&acc)[4][4]) {
  constexpr int BK = Tile::BK;
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

template <bool kVector>
__global__ void __launch_bounds__(NT)
lstm_cell_bf16_kernel(const bits* __restrict__ x, const bits* __restrict__ h,
                      const bits* __restrict__ c, const bits* __restrict__ wx,
                      const bits* __restrict__ wh, const bits* __restrict__ b,
                      bits* __restrict__ h_out, bits* __restrict__ c_out,
                      int rows, int features, int hidden) {
  using T = Tile<kVector>;
  __shared__ __align__(16) bits as[BM][T::BK + 8];
  __shared__ __align__(16) bits bs[4 * BJ][T::BK + 8];
  const int j0 = blockIdx.x * BJ, m0 = blockIdx.y * BM;
  float acc[4][4] = {};  // [gate][m16n8 accumulator fragment]
  accumulate<T>(x, wx, rows, features, hidden, m0, j0, as, bs, acc);
  accumulate<T>(h, wh, rows, hidden, hidden, m0, j0, as, bs, acc);

  // fragment element e holds row g + 8*(e/2), column 2*tig + e%2
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int m = m0 + warp * 16 + g + 8 * (e / 2);
    const int j = j0 + 2 * tig + e % 2;
    if (m >= rows || j >= hidden) continue;
    const size_t idx = static_cast<size_t>(m) * hidden + j;
    const float c_new =
        sigmoid(acc[1][e] + bf(b[hidden + j])) * bf(c[idx])
        + sigmoid(acc[0][e] + bf(b[j])) * tanhf(acc[2][e] + bf(b[2 * hidden + j]));
    const float h_new = sigmoid(acc[3][e] + bf(b[3 * hidden + j])) * tanhf(c_new);
    h_out[idx] = __bfloat16_as_ushort(__float2bfloat16(h_new));
    c_out[idx] = __bfloat16_as_ushort(__float2bfloat16(c_new));
  }
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16, for every array. x: [rows][features];
// h, c, h_out, c_out: [rows][hidden]; wx: [features][4*hidden];
// wh: [hidden][4*hidden]; b: [4*hidden]; all row-major on the device.
// Returns the CUDA error of the launch (0 on success).
int vtpu_lstm_cell(int dtype, const void* x, const void* h, const void* c,
                   const void* wx, const void* wh, const void* b,
                   void* h_out, void* c_out, int rows, int features,
                   int hidden, void* stream) {
  if (rows <= 0 || features <= 0 || hidden <= 0 || rows > 65535 * BM)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid((hidden + BJ - 1) / BJ, (rows + BM - 1) / BM);
    lstm_cell_fp32_kernel<<<grid, NT, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(h),
        static_cast<const float*>(c), static_cast<const float*>(wx),
        static_cast<const float*>(wh), static_cast<const float*>(b),
        static_cast<float*>(h_out), static_cast<float*>(c_out), rows,
        features, hidden);
  } else if (dtype == 1) {
    using tc::bits;
    const dim3 grid((hidden + tc::BJ - 1) / tc::BJ,
                    (rows + tc::BM - 1) / tc::BM);
    auto aligned = [](const void* p, uintptr_t n) {
      return reinterpret_cast<uintptr_t>(p) % n == 0;
    };
    const bool vector = features % 4 == 0 && hidden % 8 == 0
        && aligned(x, 8) && aligned(h, 8) && aligned(wx, 16)
        && aligned(wh, 16);
    auto kernel = vector ? tc::lstm_cell_bf16_kernel<true>
                         : tc::lstm_cell_bf16_kernel<false>;
    kernel<<<grid, tc::NT, 0, s>>>(
        static_cast<const bits*>(x), static_cast<const bits*>(h),
        static_cast<const bits*>(c), static_cast<const bits*>(wx),
        static_cast<const bits*>(wh), static_cast<const bits*>(b),
        static_cast<bits*>(h_out), static_cast<bits*>(c_out), rows,
        features, hidden);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* vtpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
