// Eval BatchNorm + ReLU over channels-last bf16 activations in one pass,
// alone or after a residual add.
//
// Replaces no TPU kernel. On the TPU, XLA fused ResNet-V2's inference
// BatchNorm, ReLU and residual add into their neighbours by itself; ATen
// runs each as its own pass over the activations (BatchNorm's
// channels-last transform, the ReLU, the add). Two entry points:
//   vtpu_bn_relu:      y = relu(bn(x))
//   vtpu_add_bn_relu:  s = bf16(a + b), y = relu(bn(s)); s stored only
//                      when the caller passes somewhere to store it.
// The arithmetic is ATen's eval path, rounding where it rounds: the sum
// in fp32, rounded to bf16 (ATen's add); invstd = rsqrt(var + eps) and
// t = w * (x - mean) * invstd + bias in fp32 from the module's four fp32
// vectors (batch_norm_calc_invstd and
// batch_norm_transform_input_channels_last_kernel); t rounded to bf16
// and the ReLU applied to it. So y matches the three ATen passes in value
// (the ReLU may give +0 where ATen's keeps a -0).
//
// What bounds it: device-memory bytes. An element costs 2 bytes in and 2
// out (4 in and 2 or 4 out with the add) for about 5 FLOP, far below the
// H100's ~295 FLOP a byte; the only gain is fewer passes over memory.
//
// Design: the tensor is [rows][C], rows = N*H*W, read and written as
// 16-byte vectors of 8 channels (C % 8 == 0, 16-byte aligned rows). Each
// thread walks the vectors with a stride that is a multiple of C / 8, so
// it keeps one channel octet for the whole launch and its 8 channels'
// mean, weight, bias and invstd stay in registers: no per-element
// parameter load. UNROLL independent vectors a thread are loaded before
// any is used, so enough bytes are in flight to keep HBM busy; the grid
// is as many blocks as fit on the card at once (one wave), rounded up so
// that the stride keeps each thread's octet. Inputs are read once and
// dead after, so they are loaded evict-first (__ldcs), leaving L2 to the
// outputs that the next convolution reads. The kernel allocates nothing
// and launches on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int NT = 256;    // threads a block
constexpr int UNROLL = 4;  // vectors a thread has in flight

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

// one channel octet's eval BatchNorm, as ATen computes it
struct Octet {
  float mean[8], invstd[8], weight[8], bias[8];

  __device__ __forceinline__ Octet(const float* m, const float* var,
                                   const float* w, const float* b, float eps,
                                   int c0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mean[j] = m[c0 + j];
      invstd[j] = rsqrtf(var[c0 + j] + eps);
      weight[j] = w[c0 + j];
      bias[j] = b[c0 + j];
    }
  }

  // relu(bn(f)) in place; f holds values already rounded to bf16
  __device__ __forceinline__ void apply(float (&f)[8]) const {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float t = weight[j] * (f[j] - mean[j]) * invstd[j] + bias[j];
      f[j] = t <= 0.f ? 0.f : t;
    }
  }
};

// y = relu(bn(a)); with ADD, of the rounded a + b, stored to s unless
// s is null
template <bool ADD>
__device__ __forceinline__ void pass(const uint4* __restrict__ a,
                                     const uint4* __restrict__ b,
                                     uint4* __restrict__ s,
                                     uint4* __restrict__ y, const float* mean,
                                     const float* var, const float* weight,
                                     const float* bias, float eps,
                                     int64_t vectors, int octets) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * NT;
  if (first >= vectors) return;
  const Octet bn(mean, var, weight, bias, eps,
                 8 * static_cast<int>(first % octets));
  for (int64_t base = first; base < vectors; base += UNROLL * stride) {
    uint4 va[UNROLL], vb[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t i = base + u * stride;
      if (i < vectors) {
        va[u] = __ldcs(a + i);
        if (ADD) vb[u] = __ldcs(b + i);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t i = base + u * stride;
      if (i >= vectors) break;
      float f[8];
      unpack(va[u], f);
      if (ADD) {
        float g[8];
        unpack(vb[u], g);
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] += g[j];
        const uint4 sum = pack(f);
        if (s != nullptr) s[i] = sum;
        unpack(sum, f);  // BatchNorm reads the rounded sum
      }
      bn.apply(f);
      y[i] = pack(f);
    }
  }
}

__global__ void __launch_bounds__(NT)
bn_relu_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
               const float* __restrict__ mean, const float* __restrict__ var,
               const float* __restrict__ weight,
               const float* __restrict__ bias, float eps, int64_t vectors,
               int octets) {
  pass<false>(x, nullptr, nullptr, y, mean, var, weight, bias, eps, vectors,
              octets);
}

__global__ void __launch_bounds__(NT)
add_bn_relu_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                   uint4* __restrict__ s, uint4* __restrict__ y,
                   const float* __restrict__ mean,
                   const float* __restrict__ var,
                   const float* __restrict__ weight,
                   const float* __restrict__ bias, float eps,
                   int64_t vectors, int octets) {
  pass<true>(a, b, s, y, mean, var, weight, bias, eps, vectors, octets);
}

int gcd(int p, int q) {
  while (q) {
    const int r = p % q;
    p = q;
    q = r;
  }
  return p;
}

template <bool ADD>
int launch(const void* a, const void* b, void* s, void* y, const float* mean,
           const float* var, const float* weight, const float* bias,
           float eps, long long rows, int channels, void* stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (rows < 0 || channels <= 0 || channels % 8 || !aligned(a) || !aligned(y)
      || (ADD && !aligned(b)) || (s != nullptr && !aligned(s)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int octets = channels / 8;
  const int64_t vectors = static_cast<int64_t>(rows) * octets;
  if (vectors == 0) return 0;
  static int per_sm = 0;
  static const cudaError_t occupancy =
      ADD ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, add_bn_relu_kernel, NT, 0)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, bn_relu_kernel, NT, 0);
  if (occupancy != cudaSuccess) return static_cast<int>(occupancy);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a stride of grid * NT threads keeps each thread's octet when the grid
  // is a multiple of octets / gcd(NT, octets)
  const int64_t step = octets / gcd(NT, octets);
  int64_t grid = std::min<int64_t>((vectors + NT - 1) / NT,
                                   static_cast<int64_t>(sms) * per_sm);
  grid = (grid + step - 1) / step * step;
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 blocks(static_cast<unsigned>(grid));
  const auto st = static_cast<cudaStream_t>(stream);
  if (ADD)
    add_bn_relu_kernel<<<blocks, NT, 0, st>>>(
        static_cast<const uint4*>(a), static_cast<const uint4*>(b),
        static_cast<uint4*>(s), static_cast<uint4*>(y), mean, var, weight,
        bias, eps, vectors, octets);
  else
    bn_relu_kernel<<<blocks, NT, 0, st>>>(
        static_cast<const uint4*>(a), static_cast<uint4*>(y), mean, var,
        weight, bias, eps, vectors, octets);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, y: [rows][channels] bf16 on the device (channels-last N*H*W rows),
// 16-byte aligned, channels % 8 == 0; mean, var, weight, bias: [channels]
// fp32. Returns the CUDA error of the launch (0 on success).
int vtpu_bn_relu(const void* x, void* y, const float* mean, const float* var,
                 const float* weight, const float* bias, float eps,
                 long long rows, int channels, void* stream) {
  return launch<false>(x, nullptr, nullptr, y, mean, var, weight, bias, eps,
                       rows, channels, stream);
}

// as vtpu_bn_relu on the rounded sum of a and b; s (nullable) receives it
int vtpu_add_bn_relu(const void* a, const void* b, void* s, void* y,
                     const float* mean, const float* var, const float* weight,
                     const float* bias, float eps, long long rows,
                     int channels, void* stream) {
  return launch<true>(a, b, s, y, mean, var, weight, bias, eps, rows,
                      channels, stream);
}

const char* vtpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
