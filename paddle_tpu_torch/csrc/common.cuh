// Helpers shared by the port's kernels: element conversion between the
// storage types (float, bfloat16) and the float32 the kernels compute in,
// warp-wide reductions, and the host's once-per-device raise of a kernel's
// dynamic shared-memory limit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ptt {

// The mask value the TPU kernels use (NEG_INF = -1e30, not -inf): a
// masked score gives exp(-1e30 - m) == 0 without inf - inf = NaN.
constexpr float kNegInf = -1e30f;

// dtype codes passed from Python (kernels/*.py keep the same table)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Devices that the launchers' once-per-device caches cover; past these a
// launcher asks again each time.
constexpr int kMaxDevices = 64;

// Raise a kernel's dynamic shared-memory limit to `bytes`, once per device
// and kernel (`done`, the launcher's own flags), not every launch. Returns
// 0 or the CUDA error.
template <typename Kernel>
int raise_smem(Kernel kernel, int bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < kMaxDevices && done[dev]) return 0;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  if (dev < kMaxDevices) done[dev] = true;
  return 0;
}

}  // namespace ptt
