// Tile helpers of the flash kernels on the tensor cores, built on
// wgmma.cuh's primitives. Included by flash_attention_fwd.cu (the forward,
// `flash_fwd_wgmma`), flash_attention_bwd.cu (the dq and dk/dv kernels)
// and flash_masked.cuh (the masked forward, `masked_fwd_wgmma`).
//
// What they assume, beyond wgmma.cuh's own rules:
// - Every tile has 64 rows (`kRows`): wgmma's M, one warpgroup of 128
//   threads a block, and the key step of the streamed loops.
// - A [64, HD] bf16 tile lives in shared memory as HD / 64 D-panels of 8 KB
//   each (64 rows x 128 bytes, 128B-swizzled), one after another, as
//   `wg::load_panels` writes it. One copy serves as a K-major operand over
//   D (`ss_over_d`: scores, dP) and, through an MN-major descriptor, as
//   the transposed B over its rows (`rs_hilo`: O += P V, dQ += dS K,
//   dK += dS^T Q, dV += P^T dO).
// - A [64, 64] float32 accumulator (32 registers a thread) is turned into
//   the A operand of an RS product as bf16 hi + lo fragments
//   (`split_all`), so that x reaches the product to about 2^-16 of itself.
// - HD is 64 or 128: a [64, HD] float32 accumulator takes HD / 2 registers
//   a thread, and D 256 would take 128.
#pragma once

#include <stdint.h>
#include <cuda_bf16.h>

#include "wgmma.cuh"

namespace ptt {
namespace flash {

constexpr int kRows = 64;  // rows of every tile: wgmma's M, one warpgroup
constexpr uint32_t kPanelBytes = kRows * 128;  // one D-panel of a tile
constexpr float kLog2e = 1.4426950408889634f;

// bytes of one [64, HD] bf16 tile of D-panels
template <int HD>
constexpr uint32_t kTileBytes = kPanelBytes * (HD / 64);

// acc = A . B^T over HD, both [64, HD] K-major D-panel tiles (A at sa, B
// at sb)
template <int HD>
__device__ __forceinline__ void ss_over_d(float (&acc)[32], uint32_t sa,
                                          uint32_t sb) {
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) {
    const uint32_t off = (j / 4) * kPanelBytes + 32 * (j % 4);
    wg::mma_m64n64k16(acc, wg::desc_sw128(sa + off), wg::desc_sw128(sb + off),
                      j > 0);
  }
}

// acc += A . B over B's rows: A's k16 slice j as hi and lo fragments, B a
// [64, HD] D-panel tile at sb read MN-major (N = HD)
template <int HD>
__device__ __forceinline__ void rs_hilo(float (&acc)[HD / 2],
                                        const uint32_t (&hi)[4],
                                        const uint32_t (&lo)[4], uint32_t sb,
                                        int j) {
  const uint64_t db = wg::desc_sw128_mn(sb + 2048 * j, kPanelBytes);
  if constexpr (HD == 128) {
    wg::mma_m64n128k16_rs_tb(acc, hi, db, 1);
    wg::mma_m64n128k16_rs_tb(acc, lo, db, 1);
  } else {
    wg::mma_m64n64k16_rs_tb(acc, hi, db, 1);
    wg::mma_m64n64k16_rs_tb(acc, lo, db, 1);
  }
}

// the hi/lo fragments of the four k16 slices of a [64, 64] accumulator
__device__ __forceinline__ void split_all(const float (&x)[32],
                                          uint32_t (&hi)[4][4],
                                          uint32_t (&lo)[4][4]) {
  wg::frag_a_hilo<0>(x, hi[0], lo[0]);
  wg::frag_a_hilo<1>(x, hi[1], lo[1]);
  wg::frag_a_hilo<2>(x, hi[2], lo[2]);
  wg::frag_a_hilo<3>(x, hi[3], lo[3]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wg::fence_operand(hi[j]);
    wg::fence_operand(lo[j]);
  }
}

// bf16 rows of a [64, HD] float32 accumulator into a matrix with a row
// stride (in elements, even): row `row` of the output at dst + row *
// row_stride, rows < end only
template <int HD>
__device__ __forceinline__ void store_rows_strided(__nv_bfloat16* dst,
                                                   const float (&acc)[HD / 2],
                                                   int row0, int end,
                                                   size_t row_stride) {
  const int lane = threadIdx.x & 31;
  const int r = row0 + (threadIdx.x >> 5) * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int row = r + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * (lane & 3);
    if (row < end)
      *reinterpret_cast<__nv_bfloat162*>(dst + row * row_stride + col) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
}

// the same rows of a row-major [S, HD] matrix, rows < S only
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           const float (&acc)[HD / 2],
                                           int row0, int S) {
  store_rows_strided<HD>(dst, acc, row0, S, HD);
}

}  // namespace flash
}  // namespace ptt
