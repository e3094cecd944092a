// Duty-probe matmul chain: y <- y . W, `steps` times, inside one launch.
//
// Replaces the Pallas kernel of k8s_device_plugin_tpu/monitor/dutyprobe.py
// (PallasProbe._build.<locals>.kernel, lines 70-81): a VMEM-resident fp32
// matmul chain whose wall time, against its idle-card calibration, says
// how much of the device the tenants leave free.
//
// What bounds it: fp32 FMAs in the CUDA cores (about 67 TFLOP/s on an
// H100 SXM, so 1/132 of that per SM). It moves no device memory inside the
// loop: W and y live in shared memory for the whole chain, so a tenant's
// memory cap can never be tripped by the probe and the sample measures
// compute availability, not bandwidth.
//
// Design: the TPU default of 256x256 fp32 does not fit (W alone is
// 256 KiB, above the 227 KB a block may use), so the chain runs at
// n <= 128: W and y take 2*n*n*4 bytes (128 KiB at n = 128) of dynamic
// shared memory. One block per SM runs the same chain, so a tenant on any
// SM, under MPS or time slicing, stretches the sample; block 0 writes the
// output and every other block writes one element of its own chain to
// `sink`, so no block's work is dead code. Each of the (n/4)^2 threads
// owns a 4x4 tile of y and accumulates it in registers, reading y and W
// as float4 from shared memory; a step ends with two barriers (all reads
// of the old y done, then the new y written). Each output sums over k in
// order 0..n-1 with fmaf.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 4;

__global__ void __launch_bounds__(1024)
probe_chain_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ out, float* __restrict__ sink,
                   int n, int steps) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [n][n]
  float* ys = ws + n * n;                      // [n][n]
  const int t = threadIdx.x;
  const int tiles_per_row = n / kTile;
  const int r0 = (t / tiles_per_row) * kTile;
  const int c0 = (t % tiles_per_row) * kTile;

  for (int i = t; i < n * n; i += blockDim.x) {
    ws[i] = w[i];
    ys[i] = x[i];
  }
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    float acc[kTile][kTile] = {};
    for (int k = 0; k < n; k += kTile) {
      float4 a[kTile];
#pragma unroll
      for (int r = 0; r < kTile; ++r)
        a[r] = *reinterpret_cast<const float4*>(&ys[(r0 + r) * n + k]);
#pragma unroll
      for (int kk = 0; kk < kTile; ++kk) {
        const float4 b =
            *reinterpret_cast<const float4*>(&ws[(k + kk) * n + c0]);
#pragma unroll
        for (int r = 0; r < kTile; ++r) {
          const float av = kk == 0 ? a[r].x : kk == 1 ? a[r].y
                         : kk == 2 ? a[r].z : a[r].w;
          acc[r][0] = fmaf(av, b.x, acc[r][0]);
          acc[r][1] = fmaf(av, b.y, acc[r][1]);
          acc[r][2] = fmaf(av, b.z, acc[r][2]);
          acc[r][3] = fmaf(av, b.w, acc[r][3]);
        }
      }
    }
    __syncthreads();  // every thread has read the old y
#pragma unroll
    for (int r = 0; r < kTile; ++r)
      *reinterpret_cast<float4*>(&ys[(r0 + r) * n + c0]) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    __syncthreads();  // the new y is complete
  }

  if (blockIdx.x == 0) {
    for (int i = t; i < n * n; i += blockDim.x) out[i] = ys[i];
  } else if (t == 0) {
    sink[blockIdx.x] = ys[0];
  }
}

}  // namespace

extern "C" {

// x, w, out: [n][n] fp32, row-major, on the device; sink: [grid] fp32.
// Returns the CUDA error of the launch (0 on success).
int vtpu_probe_chain(const float* x, const float* w, float* out, float* sink,
                     int n, int steps, int grid, void* stream) {
  if (n <= 0 || n > 128 || n % kTile != 0 || steps < 0 || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 2 * n * n * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      probe_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = (n / kTile) * (n / kTile);
  probe_chain_kernel<<<grid, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(x, w, out, sink,
                                                            n, steps);
  return static_cast<int>(cudaGetLastError());
}

const char* vtpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
