// Helpers shared by the port's row-wise kernels (rms_norm.cu,
// fused_elementwise.cu): 16-byte vector loads and stores that convert to
// and from the float32 the kernels compute in, and block-wide reductions.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace ptt {
namespace rowwise {

// elements of T in one 16-byte vector
template <typename T>
__host__ __device__ constexpr int vec_elems() {
  return 16 / static_cast<int>(sizeof(T));
}

// N elements of T from p (16-byte aligned, N * sizeof(T) a multiple of 16)
// as float32.
template <typename T, int N>
__device__ __forceinline__ void load(const T* p, float (&f)[N]) {
  static_assert((N * sizeof(T)) % 16 == 0, "whole 16-byte vectors only");
  constexpr int E = vec_elems<T>();
#pragma unroll
  for (int j = 0; j < N / E; ++j) {
    const uint4 raw = reinterpret_cast<const uint4*>(p)[j];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < E; ++i) f[j * E + i] = to_float(e[i]);
  }
}

// f rounded to T and stored at p (16-byte aligned).
template <typename T, int N>
__device__ __forceinline__ void store(T* p, const float (&f)[N]) {
  static_assert((N * sizeof(T)) % 16 == 0, "whole 16-byte vectors only");
  constexpr int E = vec_elems<T>();
#pragma unroll
  for (int j = 0; j < N / E; ++j) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < E; ++i) e[i] = from_float<T>(f[j * E + i]);
    reinterpret_cast<uint4*>(p)[j] = raw;
  }
}

// N zeros of T stored at p (16-byte aligned).
template <typename T, int N>
__device__ __forceinline__ void store_zeros(T* p) {
  static_assert((N * sizeof(T)) % 16 == 0, "whole 16-byte vectors only");
#pragma unroll
  for (int j = 0; j < N * static_cast<int>(sizeof(T)) / 16; ++j)
    reinterpret_cast<uint4*>(p)[j] = make_uint4(0u, 0u, 0u, 0u);
}

// The sum of v over the block; every thread gets the same bits. blockDim.x
// is a multiple of 32 (at most 1024) and `red` is 32 floats of shared
// memory. The order of the additions is fixed (each warp's butterfly, then
// the warps' sums by one butterfly), so the result is deterministic. The
// call starts with a barrier, so it may be called again in a loop.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f;
  return warp_sum(v);
}

// The largest v over the block, under the same rules as block_sum.
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : -INFINITY;
  return warp_max(v);
}

}  // namespace rowwise
}  // namespace ptt
