// One-tile check of the primitives in wgmma.cuh, for the card tests.
//
// One warpgroup computes a single 64 x 128 float32 tile
//   out[n, m] = sum_kb scales[n, kb] * sum_{k in block kb} a[n, k] b[m, k]
// from a [64, K] and b [128, K] (bf16, K-major) with K-blocks of bk: each
// 64-wide slice of K comes in through cp.async into 128B-swizzled tiles,
// each k16 step is one m64n128k16 wgmma into a partial that starts at zero
// on a block's first step, and the block's float32 scale is applied to the
// partial on the accumulator. The tile is written straight from the
// accumulator fragment, so a wrong descriptor, swizzle or fragment layout
// shows here on one tile rather than inside a whole GEMM. Not on any
// model's path.

#include <stdint.h>
#include <cuda_bf16.h>

#include "wgmma.cuh"

namespace {

namespace wg = ptt::wg;

__global__ void __launch_bounds__(128)
    wgmma_tile(const __nv_bfloat16* __restrict__ a,
               const __nv_bfloat16* __restrict__ b,
               const float* __restrict__ scales, float* __restrict__ out,
               int K, int bk) {
  __shared__ __align__(1024) uint8_t sa[64 * 128];
  __shared__ __align__(1024) uint8_t sb[128 * 128];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int KB = K / bk;
  const int r0 = warp * 16 + lane / 4;
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  float s0 = 0.f, s1 = 0.f;
  for (int k0 = 0; k0 < K; k0 += 64) {
    for (int q = t; q < 64 * 8; q += 128) {
      const int r = q >> 3, c = q & 7;
      const bool ok = k0 + c * 8 < K;
      wg::cp_async16(wg::smem_addr(sa) + wg::sw128(r, c),
                     ok ? a + (size_t)r * K + k0 + c * 8 : a, ok);
    }
    for (int q = t; q < 128 * 8; q += 128) {
      const int r = q >> 3, c = q & 7;
      const bool ok = k0 + c * 8 < K;
      wg::cp_async16(wg::smem_addr(sb) + wg::sw128(r, c),
                     ok ? b + (size_t)r * K + k0 + c * 8 : b, ok);
    }
    wg::cp_async_commit();
    wg::cp_async_wait<0>();
    wg::fence_proxy_async();
    __syncthreads();
    wg::fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + 16 * j;
      if (k < K) {
        const int kin = k % bk;
        if (kin == 0) {
          s0 = scales[(size_t)r0 * KB + k / bk];
          s1 = scales[(size_t)(r0 + 8) * KB + k / bk];
        }
        wg::mma_m64n128k16(part, wg::desc_sw128(wg::smem_addr(sa) + 32 * j),
                           wg::desc_sw128(wg::smem_addr(sb) + 32 * j),
                           kin != 0);
        if (kin + 16 == bk) {
          wg::commit();
          wg::wait<0>();
          wg::fence_operand(part);
#pragma unroll
          for (int i = 0; i < 64; ++i)
            acc[i] = fmaf((i & 2) ? s1 : s0, part[i], acc[i]);
          wg::fence();
        }
      }
    }
    wg::commit();
    wg::wait<0>();
    wg::fence_operand(part);
    __syncthreads();  // the next slice overwrites the tiles
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int row = r0 + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    out[row * 128 + col] = acc[i];
  }
}

}  // namespace

// a [64, K] and b [128, K] bf16, scales [64, K / bk] float32, out [64, 128]
// float32, all contiguous with 16-byte aligned bases; K and bk multiples
// of 16, bk dividing K. Returns the CUDA error code of the launch.
extern "C" int wgmma_selftest(const void* a, const void* b,
                              const void* scales, void* out, int K, int bk,
                              void* stream) {
  if (K <= 0 || bk <= 0 || K % 16 || bk % 16 || K % bk ||
      (uintptr_t)a % 16 || (uintptr_t)b % 16)
    return (int)cudaErrorInvalidValue;
  wgmma_tile<<<1, 128, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (const float*)scales,
      (float*)out, K, bk);
  return (int)cudaGetLastError();
}
