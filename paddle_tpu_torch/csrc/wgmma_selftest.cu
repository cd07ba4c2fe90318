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
// shows here on one tile rather than inside a whole GEMM.
//
// A second tile chains the products the way the flash backward's dk/dv
// kernel does: X = K Q^T [64 keys, 64 q] by SS m64n64k16 wgmmas over D
// (64 or 128, k16 steps across the D-panels), then 0.1 X turned into hi
// and lo bf16 A fragments in registers (`frag_a_hilo`), then C [64 keys,
// D] = (0.1 X) dO by RS wgmmas with B transposed: dO [64 q, D] read
// MN-major from the same kind of swizzled D-panels (`desc_sw128_mn`),
// hi then lo into one accumulator. A wrong MN-major descriptor, transpose
// flag or fragment rule shows here.
//
// A third tile checks mma.cuh as the tensor-core GEMV uses it: one warp
// computes out[n, m] = sum_kb scales[n, kb] * sum_{k in block kb} a[n, k]
// x[m, k] for 16 rows of int8 codes a [16, K] and 8 rows of bf16 x [8, K],
// each k16 step one m16n8k16 mma.sync whose A fragment is read straight
// from the contiguous code rows under the k permutation (one word of each
// of a lane's two rows, `frag_a_words`, exact conversion to bf16) and
// whose B fragment takes x at the same physical k (`frag_b_rows`); a float32 partial a K-block with the scale
// applied on the accumulator. A wrong fragment rule or permutation moves
// outputs by their own size.
//
// A fourth tile checks the float32 operand split as the grouped quantized
// kernel uses it: the first tile's product with b float32 [128, K], each
// 64-wide slice of b split by its threads into hi, mid and lo bf16 tiles
// (`split3_store8`), and each k16 step three chained m64n128k16 wgmmas
// (hi, mid, lo) into the block's partial. A wrong piece, pack order or
// panel offset moves outputs by far more than float32 rounding; a
// non-finite b row shows how inf and NaN pass the split.
//
// A fifth tile checks the SS product with B transposed as the grouped
// float32 kernel's forward uses it: out [64, 128] = a [64, K] . b [K, 128]
// with b row-major (the 128 columns contiguous), each 64-row slice of b
// copied 16 bytes at a time into two 64-column panels and read MN-major
// (`desc_sw128_mn`) by `mma_m64n128k16_ss_tb`. A wrong transpose flag,
// panel step or swizzle moves outputs by their own size.
//
// A sixth tile checks the SS product with A and B both transposed as the
// grouped weight gradient uses it: out [128, 128] = a^T . b with a [K,
// 128] and b [K, 128] row-major (the 128 columns contiguous: x and dy of
// one group, the rows the contraction), each 64-row slice of each copied
// into two 64-column panels; warpgroup g reads a's panel g MN-major as its
// A [K, M 64] and all of b as B (`mma_m64n128k16_ss_tatb`). A wrong
// transpose flag, panel or swizzle moves outputs by their own size. No
// tile here is on any model's path.

#include <stdint.h>
#include <cuda_bf16.h>

#include "mma.cuh"
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

template <int D>
__global__ void __launch_bounds__(128)
    wgmma_chain_tile(const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ dout,
                     float* __restrict__ out) {
  constexpr uint32_t kPanel = 64 * 128;
  constexpr uint32_t kTile = kPanel * (D / 64);
  extern __shared__ __align__(1024) uint8_t chain_smem[];
  const uint32_t sk = wg::smem_addr(chain_smem);
  if (sk & 1023) __trap();
  const uint32_t sq = sk + kTile, sd = sq + kTile;
  wg::load_panels<D>(sk, k, 0, 64);
  wg::load_panels<D>(sq, q, 0, 64);
  wg::load_panels<D>(sd, dout, 0, 64);
  wg::cp_async_commit();
  wg::cp_async_wait<0>();
  wg::fence_proxy_async();
  __syncthreads();

  float x[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = 0.f;
  wg::fence();
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    const uint32_t off = (j / 4) * kPanel + 32 * (j % 4);
    wg::mma_m64n64k16(x, wg::desc_sw128(sk + off), wg::desc_sw128(sq + off),
                      j > 0);
  }
  wg::commit();
  wg::wait<0>();
  wg::fence_operand(x);
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] *= 0.1f;

  float c[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) c[i] = 0.f;
  uint32_t hi[4][4], lo[4][4];
  wg::frag_a_hilo<0>(x, hi[0], lo[0]);
  wg::frag_a_hilo<1>(x, hi[1], lo[1]);
  wg::frag_a_hilo<2>(x, hi[2], lo[2]);
  wg::frag_a_hilo<3>(x, hi[3], lo[3]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wg::fence_operand(hi[j]);
    wg::fence_operand(lo[j]);
  }
  wg::fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint64_t db = wg::desc_sw128_mn(sd + 2048 * j, kPanel);
    if constexpr (D == 128) {
      wg::mma_m64n128k16_rs_tb(c, hi[j], db, 1);
      wg::mma_m64n128k16_rs_tb(c, lo[j], db, 1);
    } else {
      wg::mma_m64n64k16_rs_tb(c, hi[j], db, 1);
      wg::mma_m64n64k16_rs_tb(c, lo[j], db, 1);
    }
  }
  wg::commit();
  wg::wait<0>();
  wg::fence_operand(c);
  const int t = threadIdx.x, r0 = (t >> 5) * 16 + (t & 31) / 4;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    const int row = r0 + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * (t & 3) + (i & 1);
    out[row * D + col] = c[i];
  }
}

__global__ void __launch_bounds__(32)
    mma_codes_tile(const uint8_t* __restrict__ a,
                   const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ scales, float* __restrict__ out,
                   int K, int bk) {
  namespace mma = ptt::mma;
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const int KB = K / bk;
  float acc[4] = {0.f, 0.f, 0.f, 0.f}, part[4];
  for (int k = 0; k < K; k += 16) {
    if (k % bk == 0)
      for (int i = 0; i < 4; ++i) part[i] = 0.f;
    uint32_t fa[4], fb[2];
    const uint8_t* words = a + k + 4 * t;  // the lane's word of row 0
    mma::frag_a_words<mma::kCodeInt8>(
        *reinterpret_cast<const uint32_t*>(words + g * K),
        *reinterpret_cast<const uint32_t*>(words + (g + 8) * K), fa);
    mma::frag_b_rows(x + k, K, fb);
    mma::mma_m16n8k16(part, fa, fb);
    if ((k + 16) % bk == 0) {
      const float s0 = scales[g * KB + k / bk];
      const float s1 = scales[(g + 8) * KB + k / bk];
      acc[0] = fmaf(s0, part[0], acc[0]);
      acc[1] = fmaf(s0, part[1], acc[1]);
      acc[2] = fmaf(s1, part[2], acc[2]);
      acc[3] = fmaf(s1, part[3], acc[3]);
    }
  }
  out[g * 8 + 2 * t] = acc[0];
  out[g * 8 + 2 * t + 1] = acc[1];
  out[(g + 8) * 8 + 2 * t] = acc[2];
  out[(g + 8) * 8 + 2 * t + 1] = acc[3];
}

constexpr int kSplitPanel = 128 * 128;  // one bf16 [128, 64] tile of b

__global__ void __launch_bounds__(128)
    split3_tile(const __nv_bfloat16* __restrict__ a,
                const float* __restrict__ b,
                const float* __restrict__ scales, float* __restrict__ out,
                int K, int bk) {
  extern __shared__ __align__(1024) uint8_t split_smem[];
  uint8_t* sb = split_smem;                 // hi, mid, lo tiles of b
  uint8_t* sa = split_smem + 3 * kSplitPanel;
  if (wg::smem_addr(sb) & 1023) __trap();
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
      wg::cp_async16(wg::smem_addr(sa) + wg::sw128(r, c),
                     a + (size_t)r * K + k0 + c * 8, true);
    }
    for (int q = t; q < 128 * 8; q += 128) {
      const int r = q >> 3, c = q & 7;
      const float4* p =
          reinterpret_cast<const float4*>(b + (size_t)r * K + k0 + c * 8);
      wg::split3_store8(sb, wg::sw128(r, c), kSplitPanel, p[0], p[1]);
    }
    wg::cp_async_commit();
    wg::cp_async_wait<0>();
    wg::fence_proxy_async();
    __syncthreads();
    wg::fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + 16 * j;
      const int kin = k % bk;
      if (kin == 0) {
        s0 = scales[(size_t)r0 * KB + k / bk];
        s1 = scales[(size_t)(r0 + 8) * KB + k / bk];
      }
#pragma unroll
      for (int p = 0; p < 3; ++p)
        wg::mma_m64n128k16(
            part, wg::desc_sw128(wg::smem_addr(sa) + 32 * j),
            wg::desc_sw128(wg::smem_addr(sb) + p * kSplitPanel + 32 * j),
            kin != 0 || p > 0);
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

__global__ void __launch_bounds__(128)
    ss_tb_tile(const __nv_bfloat16* __restrict__ a,
               const __nv_bfloat16* __restrict__ b, float* __restrict__ out,
               int K) {
  constexpr uint32_t kPanel = 64 * 128;   // [64 k, 64 n] of bf16
  __shared__ __align__(1024) uint8_t sa[64 * 128];
  __shared__ __align__(1024) uint8_t sb[2 * kPanel];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < K; k0 += 64) {
    for (int q = t; q < 64 * 8; q += 128) {
      const int r = q >> 3, c = q & 7;
      wg::cp_async16(wg::smem_addr(sa) + wg::sw128(r, c),
                     a + (size_t)r * K + k0 + c * 8, true);
    }
    // row r of the slice is k0 + r; chunk c holds columns 8c .. 8c + 7
    for (int q = t; q < 64 * 16; q += 128) {
      const int r = q >> 4, c = q & 15;
      wg::cp_async16(wg::smem_addr(sb) + (c >> 3) * kPanel +
                         wg::sw128(r, c & 7),
                     b + (size_t)(k0 + r) * 128 + c * 8, true);
    }
    wg::cp_async_commit();
    wg::cp_async_wait<0>();
    wg::fence_proxy_async();
    __syncthreads();
    wg::fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wg::mma_m64n128k16_ss_tb(
          acc, wg::desc_sw128(wg::smem_addr(sa) + 32 * j),
          wg::desc_sw128_mn(wg::smem_addr(sb) + 2048 * j, kPanel), 1);
    wg::commit();
    wg::wait<0>();
    wg::fence_operand(acc);
    __syncthreads();  // the next slice overwrites the tiles
  }
  const int r0 = warp * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int row = r0 + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    out[row * 128 + col] = acc[i];
  }
}

__global__ void __launch_bounds__(256)
    ss_tatb_tile(const __nv_bfloat16* __restrict__ a,
                 const __nv_bfloat16* __restrict__ b, float* __restrict__ out,
                 int K) {
  constexpr uint32_t kPanel = 64 * 128;   // [64 k, 64 m or n] of bf16
  __shared__ __align__(1024) uint8_t sa[2 * kPanel];
  __shared__ __align__(1024) uint8_t sb[2 * kPanel];
  const int t = threadIdx.x, g = t >> 7, warp = (t >> 5) & 3, lane = t & 31;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < K; k0 += 64) {
    // row r of the slice is k0 + r; chunk c holds columns 8c .. 8c + 7
    for (int q = t; q < 64 * 16; q += 256) {
      const int r = q >> 4, c = q & 15;
      const uint32_t off = (c >> 3) * kPanel + wg::sw128(r, c & 7);
      wg::cp_async16(wg::smem_addr(sa) + off,
                     a + (size_t)(k0 + r) * 128 + c * 8, true);
      wg::cp_async16(wg::smem_addr(sb) + off,
                     b + (size_t)(k0 + r) * 128 + c * 8, true);
    }
    wg::cp_async_commit();
    wg::cp_async_wait<0>();
    wg::fence_proxy_async();
    __syncthreads();
    wg::fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wg::mma_m64n128k16_ss_tatb(
          acc,
          wg::desc_sw128_mn(wg::smem_addr(sa) + g * kPanel + 2048 * j,
                            kPanel),
          wg::desc_sw128_mn(wg::smem_addr(sb) + 2048 * j, kPanel), 1);
    wg::commit();
    wg::wait<0>();
    wg::fence_operand(acc);
    __syncthreads();  // the next slice overwrites the tiles
  }
  const int r0 = g * 64 + warp * 16 + lane / 4;
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

// k [64, D], q [64, D] and dout [64, D] bf16, out [64, D] float32, all
// contiguous with 16-byte aligned bases; D 64 or 128. out = (0.1 k q^T)
// dout through the chained tile above. Returns the CUDA error code of the
// launch.
extern "C" int wgmma_chain_selftest(const void* k, const void* q,
                                    const void* dout, void* out, int D,
                                    void* stream) {
  if ((D != 64 && D != 128) || (uintptr_t)k % 16 || (uintptr_t)q % 16 ||
      (uintptr_t)dout % 16)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 3 * 64 * 128 * (D / 64);  // 48 KB at D 128
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 128)
    wgmma_chain_tile<128><<<1, 128, smem, st>>>(
        (const __nv_bfloat16*)k, (const __nv_bfloat16*)q,
        (const __nv_bfloat16*)dout, (float*)out);
  else
    wgmma_chain_tile<64><<<1, 128, smem, st>>>(
        (const __nv_bfloat16*)k, (const __nv_bfloat16*)q,
        (const __nv_bfloat16*)dout, (float*)out);
  return (int)cudaGetLastError();
}

// a [16, K] int8 codes, x [8, K] bf16, scales [16, K / bk] float32, out
// [16, 8] float32, all contiguous; K and bk multiples of 16, bk dividing
// K. out = the scaled product through the mma.sync tile above. Returns
// the CUDA error code of the launch.
extern "C" int mma_codes_selftest(const void* a, const void* x,
                                  const void* scales, void* out, int K,
                                  int bk, void* stream) {
  if (K <= 0 || bk <= 0 || K % 16 || bk % 16 || K % bk ||
      (uintptr_t)a % 4 || (uintptr_t)x % 8)
    return (int)cudaErrorInvalidValue;
  mma_codes_tile<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)a, (const __nv_bfloat16*)x, (const float*)scales,
      (float*)out, K, bk);
  return (int)cudaGetLastError();
}

// a [64, K] bf16, b [128, K] float32, scales [64, K / bk] float32, out
// [64, 128] float32, all contiguous with 16-byte aligned bases; K a
// multiple of 64, bk of 16 dividing K. out = the scaled product with b
// split into three bf16 pieces, through the fourth tile above. Returns the
// CUDA error code of the launch.
extern "C" int split3_selftest(const void* a, const void* b,
                               const void* scales, void* out, int K, int bk,
                               void* stream) {
  if (K <= 0 || bk <= 0 || K % 64 || bk % 16 || K % bk ||
      (uintptr_t)a % 16 || (uintptr_t)b % 16)
    return (int)cudaErrorInvalidValue;
  constexpr int smem = 3 * kSplitPanel + 64 * 128;  // 56 KB
  cudaError_t e = cudaFuncSetAttribute(
      split3_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  split3_tile<<<1, 128, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)a, (const float*)b, (const float*)scales,
      (float*)out, K, bk);
  return (int)cudaGetLastError();
}

// a [64, K] bf16 (K contiguous), b [K, 128] bf16 (the 128 columns
// contiguous), out [64, 128] float32, all contiguous with 16-byte aligned
// bases; K a multiple of 64. out = a . b through the fifth tile above.
// Returns the CUDA error code of the launch.
extern "C" int ss_tb_selftest(const void* a, const void* b, void* out, int K,
                              void* stream) {
  if (K <= 0 || K % 64 || (uintptr_t)a % 16 || (uintptr_t)b % 16)
    return (int)cudaErrorInvalidValue;
  ss_tb_tile<<<1, 128, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (float*)out, K);
  return (int)cudaGetLastError();
}

// a [K, 128] and b [K, 128] bf16 (the 128 columns contiguous), out [128,
// 128] float32, all contiguous with 16-byte aligned bases; K a multiple of
// 64. out = a^T . b through the sixth tile above. Returns the CUDA error
// code of the launch.
extern "C" int ss_tatb_selftest(const void* a, const void* b, void* out,
                                int K, void* stream) {
  if (K <= 0 || K % 64 || (uintptr_t)a % 16 || (uintptr_t)b % 16)
    return (int)cudaErrorInvalidValue;
  ss_tatb_tile<<<1, 256, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (float*)out, K);
  return (int)cudaGetLastError();
}
