// Warp-level tensor-core product (`mma.sync` m16n8k16, bf16 in, float32
// accumulators) on block-scaled one-byte weight codes, and the exact
// code -> bf16 conversion that the codes' tensor-core kernels share.
//
// What every helper here assumes:
// - `mma_m16n8k16` computes D[16, 8] += A[16, 16] . B[16, 8] for one warp
//   (all 32 lanes reach it). Lane l = 4 g + t (g = l / 4, t = l % 4) holds,
//   as bf16 pairs with the lower k in the low half, A rows g (registers 0
//   and 2) and g + 8 (1 and 3) at k 2t, 2t + 1 (registers 0 and 1) and 2t
//   + 8, 2t + 9 (2 and 3); B column g at k 2t, 2t + 1 (register 0) and 2t
//   + 8, 2t + 9 (1); D rows g (d[0], d[1]) and g + 8 (d[2], d[3]) at
//   columns 2t and 2t + 1.
// - The order of k inside one k16 step is free as long as A and B take the
//   same permutation. `frag_a_words` and `frag_b_rows` take physical k 4t
//   .. 4t + 3 of a 16-wide step for the lane's logical k 2t, 2t + 1, 2t + 8,
//   2t + 9: each lane reads 4 contiguous codes of each of its two A rows (one
//   32-bit word each) and 4 contiguous bf16 of its B row (one 64-bit word),
//   with no ldmatrix and no repacking. A step's 16 physical k are one aligned
//   16-wide slice, so a step never straddles a scale block whose size is a
//   multiple of 16.
// - `codes4_to_bf16<Q>` turns four codes (one 32-bit word, the first in the
//   low byte; Q 0 = int8, 1 = float8 e4m3) into four bf16, exactly: every
//   int8 code and every finite e4m3 value has at most 8 significant bits.
#pragma once

#include <stdint.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ptt {
namespace mma {

constexpr int kCodeInt8 = 0;  // code dtype codes (kernels/quant_matmul.py)
constexpr int kCodeFp8 = 1;

// Four codes -> four bf16 (two bf16x2 words), exactly, on the integer and
// float32 pipes: the hardware conversions (I2F, F2FP) issue at a fraction
// of their rate. Every result has at most 8 significant bits, so bf16 is
// float32's upper half (`kPackHi`).
constexpr uint32_t kPackHi = 0x7632;  // __byte_perm: the upper halves of a, b
template <int Q>
__device__ __forceinline__ uint2 codes4_to_bf16(uint32_t w);
// int8: c + 128 as the low byte of the float 2^23 + (c + 128), less 2^23 +
// 128, is c
template <>
__device__ __forceinline__ uint2 codes4_to_bf16<kCodeInt8>(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  const float bias = 8388736.f;  // 2^23 + 128
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) - bias;
  return make_uint2(
      __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), kPackHi),
      __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), kPackHi));
}
// e4m3: the code's sign, exponent and mantissa moved into float32's fields
// (bits 31, 26-23, 22-20) give 2^-120 of its value, normal or subnormal
// alike (no flush to zero here); times 2^120, exactly, is the value
template <>
__device__ __forceinline__ uint2 codes4_to_bf16<kCodeFp8>(uint32_t w) {
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int top = (int)__byte_perm(w, 0, 0x0444 + 0x1000 * i);  // code<<24
    f[i] = __uint_as_float((uint32_t)(top >> 4) & 0x87F00000u) * 0x1p120f;
  }
  return make_uint2(
      __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), kPackHi),
      __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), kPackHi));
}

__device__ __forceinline__ void mma_m16n8k16(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment of one k16 step from a lane's code words: w0 holds
// physical k 4t .. 4t + 3 of row g, w1 the same of row g + 8 (the first
// code in the low byte).
template <int Q>
__device__ __forceinline__ void frag_a_words(uint32_t w0, uint32_t w1,
                                             uint32_t (&a)[4]) {
  const uint2 c0 = codes4_to_bf16<Q>(w0), c1 = codes4_to_bf16<Q>(w1);
  a[0] = c0.x;  // row g, physical k 4t, 4t + 1 (logical 2t, 2t + 1)
  a[1] = c1.x;  // row g + 8
  a[2] = c0.y;  // row g, physical k 4t + 2, 4t + 3 (logical 2t + 8, 2t + 9)
  a[3] = c1.y;
}

// The B fragment of the same k16 step from 8 bf16 rows: `rows` points at
// the step's first value of row 0, `pitch` is the element step between
// rows (a multiple of 4). Each lane reads 4 values of row g.
__device__ __forceinline__ void frag_b_rows(const __nv_bfloat16* rows,
                                            int pitch, uint32_t (&b)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint2 v =
      *reinterpret_cast<const uint2*>(rows + g * pitch + 4 * t);
  b[0] = v.x;
  b[1] = v.y;
}

}  // namespace mma
}  // namespace ptt
