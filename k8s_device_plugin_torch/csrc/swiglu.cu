// LFM2-MoE's SwiGLU and its gate between the two products of a feed-forward
// layer, in one pass over bf16 rows (K6).
//
// Replaces no TPU kernel: LFM2 has no JAX counterpart. It was added because
// ATen runs the chain a = silu(h1) * h3 * g as three passes (the SiLU, then
// two multiplies), each over strided halves of h13 = u [W1 | W3] or the
// broadcast [rows, 1] gate, so on its non-vectorised elementwise path. One
// entry point:
//   vtpu_swiglu_gate:  a = bf16(bf16(bf16(silu(h1)) * h3) * g)
// with h1 and h3 the first and second halves of each row of h13 and g one
// value a row; without g the last product and rounding are left out. The
// arithmetic is ATen's, in fp32 and rounded to bf16 where its three passes
// round: silu(x) = x / (1 + expf(-x)) (ActivationSiluKernel.cu), each
// product of two bf16 values in fp32. Built without fast math, so a equals
// the chain bit for bit.
//
// What bounds it: device-memory bytes. An element of a costs 4 bytes in
// (h1, h3) and 2 out for about 25 FLOP, far below the H100's ~295 FLOP a
// byte: 3 * rows * hidden * 2 bytes (+ 2 * rows for g) over HBM's 3.35 TB/s.
// The only gain is one pass over memory where ATen makes three.
//
// Design: one warp a row at a time (a grid-stride loop over rows, one wave
// of blocks on the card). Its 32 lanes walk the row's 16-byte octets of 8
// bf16, each octet of h1 beside the same octet of h3, so each load of a warp
// is 512 contiguous bytes; UNROLL octets a lane are loaded before any is
// used, so enough bytes are in flight to keep HBM busy. The row's gate is
// loaded once (one address for the warp) and held in a register across the
// row's octets. Loads and stores keep the default cache policy: W13's
// product has just written h13, whose last rows are still in L2, and W2's
// product reads a next. Between the two grouped products at the MoE shape,
// evict-first loads (__ldcs) and streaming stores (__stcs) made this pass
// about 4% slower and W2's product no faster on the H100. Needs hidden % 8
// == 0 and 16-byte aligned h13 and a. The kernel allocates nothing and
// launches on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int NT = 256;         // threads a block
constexpr int WARPS = NT / 32;  // rows a block works on at once
constexpr int UNROLL = 4;       // octets a lane has in flight

// the 8 bf16 of a 16-byte vector, as fp32
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                    pack2(f[6], f[7]));
}

// x rounded to bf16, as fp32
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// a[row] = swiglu(h13[row]) (* g[row]); h13 rows hold 2 * octets vectors,
// a rows octets
template <bool GATE>
__global__ void __launch_bounds__(NT)
swiglu_gate_kernel(const uint4* __restrict__ h13,
                   const unsigned short* __restrict__ g,
                   uint4* __restrict__ a, int64_t rows, int octets) {
  const int lane = threadIdx.x % 32;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * WARPS;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * WARPS
                     + threadIdx.x / 32;
       row < rows; row += stride) {
    const uint4* h1 = h13 + row * 2 * octets;
    const uint4* h3 = h1 + octets;
    uint4* out = a + row * octets;
    float gate = 1.f;
    if (GATE) gate = __uint_as_float(static_cast<uint32_t>(__ldg(g + row))
                                     << 16);
    for (int base = lane; base < octets; base += 32 * UNROLL) {
      uint4 v1[UNROLL], v3[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int o = base + 32 * u;
        if (o < octets) {
          v1[u] = h1[o];
          v3[u] = h3[o];
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int o = base + 32 * u;
        if (o >= octets) break;
        float x[8], y[8];
        unpack(v1[u], x);
        unpack(v3[u], y);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float s = bf16_round(x[j] / (1.f + expf(-x[j])));
          x[j] = GATE ? bf16_round(s * y[j]) * gate : s * y[j];
        }
        out[o] = pack(x);
      }
    }
  }
}

template <bool GATE>
int launch(const void* h13, const void* g, void* a, int64_t rows, int octets,
           cudaStream_t stream) {
  static int per_sm = 0;
  static const cudaError_t occupancy =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, swiglu_gate_kernel<GATE>, NT, 0);
  if (occupancy != cudaSuccess) return static_cast<int>(occupancy);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t grid = std::min<int64_t>((rows + WARPS - 1) / WARPS,
                                         static_cast<int64_t>(sms) * per_sm);
  swiglu_gate_kernel<GATE><<<static_cast<unsigned>(grid), NT, 0, stream>>>(
      static_cast<const uint4*>(h13), static_cast<const unsigned short*>(g),
      static_cast<uint4*>(a), rows, octets);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// h13: [rows][2 * hidden] bf16 on the device, W1's half first; g: [rows]
// bf16 or null; a: [rows][hidden] bf16. h13 and a 16-byte aligned, hidden
// % 8 == 0. Returns the CUDA error of the launch (0 on success).
int vtpu_swiglu_gate(const void* h13, const void* g, void* a, long long rows,
                     int hidden, void* stream) {
  const auto aligned = [](const void* p, uintptr_t to) {
    return reinterpret_cast<uintptr_t>(p) % to == 0;
  };
  if (rows < 0 || hidden <= 0 || hidden % 8 || !aligned(h13, 16)
      || !aligned(a, 16) || !aligned(g, 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  return g != nullptr ? launch<true>(h13, g, a, rows, hidden / 8, st)
                      : launch<false>(h13, g, a, rows, hidden / 8, st);
}

const char* vtpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
