// Block-scaled int8 / fp8 weight matmul: out = x . dequant(codes, scales)^T.
//
// Replaces: paddle_tpu/kernels/pallas/quant_matmul.py, `_qmm_kernel`
// launched by `_qmm_call` (the pallas_call at line 177).
//
// Computes, for x [M, K] (float32 or bfloat16), codes [N, K] (int8 or
// float8 e4m3, the torch Linear layout) and scales [N, KB] float32 with
// block bk = K / KB (any divisor of K):
//   out[m, n] = sum_k x[m, k] * (codes[n, k] * scales[n, k / bk])
// accumulated in float32 and written in x's dtype. The full-width weight
// never exists in device memory: codes are dequantized (or converted) on
// chip after their load, as the TPU kernel does in VMEM.
//
// What bounds it on the H100. At decode (M = slots, 8 at most) the weight
// read is the work: one byte per code against 2 M flops, far below the
// card's balance point, so it is bound by device-memory bytes. At prefill
// (M in the hundreds or thousands) it is bound by operations: M 1024, K
// 4096, N 11008 is 9.2e10 flops against about 77 MB, so the lever is the
// tensor cores (989 TFLOP/s in bf16), not the bytes.
//
// Three kernels; the wrapper (kernels/quant_matmul.py, `qmm_route`) picks
// one and passes it in, and a kernel that cannot take the inputs is an
// error, never a silent switch to another:
// - "rows" (M <= 32, `qmm_rows`), the decode GEMV: one block of 4 warps
//   per 4 output columns and up to 8 rows of x (grid.y walks further
//   groups of 8 rows). The warps split K; each lane loads 8 codes of each
//   of the 4 columns at a time (one 8-byte load per column, neighbouring
//   lanes on neighbouring bytes), dequantizes them, and applies them to
//   every row of x, so each code tile is read from device memory once and
//   used M times. The partial sums meet through a warp reduction and
//   shared memory. Unchanged by the tensor-core kernel.
// - "wgmma" (bf16 x, M > 32, bk % 64 == 0, 16-byte aligned x and codes;
//   `qmm_wgmma`), the prefill product on the tensor cores. Every int8
//   code (-127..127) and every finite e4m3 value is exact in bf16, so the
//   tensor cores multiply the codes themselves against x: each product is
//   exact and sums in float32. The scale is NOT folded into the weight
//   (a bf16 code * scale would round each weight by up to 2^-9 and put a
//   K 4096 output about 1e-3 of its size off the float32 reference):
//   each K-block's bk / 16 k16 steps accumulate a float32 partial that
//   starts at zero on the block's first step, and the block's float32
//   scale is applied on the accumulator, acc += scale * partial. The
//   product is computed transposed, out^T tile = codes tile . x tile^T,
//   so that a scale belongs to an accumulator row: in the m64n128k16
//   layout a thread holds two rows, so two scales per block. A block of
//   two warpgroups owns a 128 (n) x 128 (m) tile, 64 codes rows each
//   against the one x tile they share; both operands sit K-major in
//   shared memory with the 128-byte swizzle (wgmma.cuh), 64 values of K a
//   stage, in a ring of 4 stages (160 KB of dynamic shared memory, one
//   block an SM). x arrives by cp.async (rows past M zero-filled, never
//   read); the codes arrive by cp.async into a byte staging buffer, and
//   each thread converts the chunks it copied to bf16 in the swizzled A
//   tile, exactly and without the slow hardware conversions
//   (`codes4_to_bf16`), while the previous stage's products run. One
//   barrier a stage publishes the conversion and frees the oldest stage.
//   A K-block is whole stages (bk % 64 == 0; the codec's default block
//   is 128), so a stage's four products issue back to back; a loop that
//   checked each k16 step for a block's start and end, which smaller
//   blocks would need, ran 20-26 % slower at bk 128 on an H100. The
//   partial is drained (wait_group 0) at each K-block's end, so the
//   tensor cores idle between two blocks. The epilogue moves the tile
//   through shared memory and writes out[M, N] in bf16 with 16-byte
//   stores.
// - "tiled" (everything else with M > 32: float32 x, or a block not a
//   multiple of 64, or unaligned data; `qmm_tiled`), a plain
//   shared-memory tiled product on CUDA cores, 64 x 64 output tiles,
//   32-deep K steps, 4 x 4 outputs per thread; the code tile is
//   dequantized to float32 on its way into shared memory. Float32 x stays
//   here: TF32 tensor cores would round x to 10 mantissa bits and change
//   the float32 results the parity checks compare token for token.
// No TMA, mbarrier ring or warp specialisation yet: those are the next
// steps for the wgmma kernel.

#include <stdint.h>
#include <type_traits>
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using ptt::from_float;
using ptt::to_float;
using ptt::warp_sum;

constexpr int kQInt8 = 0;  // code dtype codes (kernels/quant_matmul.py)
constexpr int kQFp8 = 1;

template <int Q>
__device__ __forceinline__ float code_to_float(unsigned b);
template <>
__device__ __forceinline__ float code_to_float<kQInt8>(unsigned b) {
  return (float)(int8_t)(uint8_t)b;
}
template <>
__device__ __forceinline__ float code_to_float<kQFp8>(unsigned b) {
  __half_raw h = __nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)(b & 0xffu),
                                         __NV_E4M3);
  return __half2float(__half(h));
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// -- small M: the decode GEMV ---------------------------------------------------

constexpr int kRowWarps = 4;
constexpr int kRowThreads = kRowWarps * 32;
constexpr int kCols = 4;  // output columns per block
constexpr int kVec = 8;   // codes a lane loads per column per pass

template <typename TX, int Q, int MT>
__global__ void __launch_bounds__(kRowThreads)
    qmm_rows(const TX* __restrict__ x, const uint8_t* __restrict__ codes,
             const float* __restrict__ scales, TX* __restrict__ out, int M,
             int N, int K, int KB, int bk, int vec) {
  __shared__ float red[kRowWarps][kCols][MT];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kCols;
  const int m0 = blockIdx.y * MT;
  const int rows = min(MT, M - m0);
  x += (size_t)m0 * K;
  out += (size_t)m0 * N;
  // an 8-code group lies in one scale block when bk is a multiple of 8
  const bool one_scale = vec && (bk % kVec) == 0;

  float acc[kCols][MT];
#pragma unroll
  for (int c = 0; c < kCols; ++c)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[c][m] = 0.f;

  const int kvec = vec ? K : 0;
  for (int k = (warp * 32 + lane) * kVec; k < kvec;
       k += kRowThreads * kVec) {
    float w[kCols][kVec];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int n = n0 + c;
      if (n < N) {
        const uint2 raw =
            *reinterpret_cast<const uint2*>(codes + (size_t)n * K + k);
        const float* srow = scales + (size_t)n * KB;
        const float s0 = one_scale ? srow[k / bk] : 0.f;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const unsigned b = (j < 4 ? raw.x : raw.y) >> (8 * (j & 3));
          const float s = one_scale ? s0 : srow[(k + j) / bk];
          w[c][j] = code_to_float<Q>(b) * s;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) w[c][j] = 0.f;
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < rows) {
        float xv[kVec];
        load8(x + (size_t)m * K + k, xv);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          float a = acc[c][m];
#pragma unroll
          for (int j = 0; j < kVec; ++j) a += xv[j] * w[c][j];
          acc[c][m] = a;
        }
      }
    }
  }
  // K not a multiple of 8, or unaligned pointers: one element at a time
  for (int k = kvec + warp * 32 + lane; k < K; k += kRowThreads) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int n = n0 + c;
      if (n >= N) continue;
      const float w = code_to_float<Q>(codes[(size_t)n * K + k]) *
                      scales[(size_t)n * KB + k / bk];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        if (m < rows) acc[c][m] += to_float(x[(size_t)m * K + k]) * w;
    }
  }

#pragma unroll
  for (int c = 0; c < kCols; ++c)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float v = warp_sum(acc[c][m]);
      if (lane == 0) red[warp][c][m] = v;
    }
  __syncthreads();
  for (int t = threadIdx.x; t < kCols * MT; t += kRowThreads) {
    const int c = t / MT, m = t % MT;
    if (m < rows && n0 + c < N) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kRowWarps; ++w) v += red[w][c][m];
      out[(size_t)m * N + n0 + c] = from_float<TX>(v);
    }
  }
}

// -- large M on CUDA cores: float32 x and what the tensor cores do not take --

constexpr int kTM = 64, kTN = 64, kTK = 32;
constexpr int kTileThreads = 256;

template <typename TX, int Q>
__global__ void __launch_bounds__(kTileThreads)
    qmm_tiled(const TX* __restrict__ x, const uint8_t* __restrict__ codes,
              const float* __restrict__ scales, TX* __restrict__ out, int M,
              int N, int K, int KB, int bk) {
  __shared__ __align__(16) float xs[kTK][kTM + 4];
  __shared__ __align__(16) float ws[kTK][kTN + 4];
  const int m0 = blockIdx.y * kTM;
  const int n0 = blockIdx.x * kTN;
  const int tx = threadIdx.x % 16;  // 4 output columns each
  const int ty = threadIdx.x / 16;  // 4 output rows each
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kTK) {
#pragma unroll
    for (int i = 0; i < (kTM * kTK) / kTileThreads; ++i) {
      const int e = threadIdx.x + i * kTileThreads;
      const int r = e / kTK, kk = e % kTK;
      const int gk = k0 + kk;
      const int gm = m0 + r, gn = n0 + r;
      xs[kk][r] = (gm < M && gk < K) ? to_float(x[(size_t)gm * K + gk]) : 0.f;
      ws[kk][r] = (gn < N && gk < K)
                      ? code_to_float<Q>(codes[(size_t)gn * K + gk]) *
                            scales[(size_t)gn * KB + gk / bk]
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) out[(size_t)gm * N + gn] = from_float<TX>(acc[i][j]);
    }
  }
}

// -- large M, bf16 x: the prefill product on the tensor cores ---------------

namespace wg = ptt::wg;

constexpr int kWGroups = 2;            // warpgroups a block, 64 codes rows each
constexpr int kWN = 64 * kWGroups;     // codes rows (output columns) a block
constexpr int kWM = 128;   // rows of x a block: wgmma's N, shared by the groups
constexpr int kWK = 64;    // K a stage: one 128-byte swizzled row of bf16
constexpr int kWStages = 4;
constexpr int kWThreads = 128 * kWGroups;
constexpr int kXBytes = kWM * kWK * 2;          // x tile, bf16
constexpr int kABytes = kWN * kWK * 2;          // converted codes, bf16
constexpr int kCBytes = kWN * kWK;              // raw codes, one byte each
constexpr int kStageBytes = kXBytes + kABytes + kCBytes;
constexpr int kWSmem = kWStages * kStageBytes;  // 160 KB
constexpr int kEpiPitch = kWN + 8;              // bf16 a row of the epilogue
static_assert(kStageBytes % 1024 == 0 && kXBytes % 1024 == 0,
              "swizzled tiles start on 1024-byte boundaries");
static_assert(kWM * kEpiPitch * 2 <= kWSmem, "epilogue tile fits");

// Four codes (one 32-bit word, the first in the low byte) -> four bf16 (two
// bf16x2 words), exactly, on the integer and float32 pipes: the hardware
// conversions (I2F, F2FP) issue at a fraction of their rate and made the
// conversion the kernel's largest cost. Every result has at most 8
// significant bits, so bf16 is float32's upper half (`kPackHi`).
constexpr uint32_t kPackHi = 0x7632;  // __byte_perm: the upper halves of a, b
template <int Q>
__device__ __forceinline__ uint2 codes4_to_bf16(uint32_t w);
// int8: c + 128 as the low byte of the float 2^23 + (c + 128), less 2^23 +
// 128, is c
template <>
__device__ __forceinline__ uint2 codes4_to_bf16<kQInt8>(uint32_t w) {
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
__device__ __forceinline__ uint2 codes4_to_bf16<kQFp8>(uint32_t w) {
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

// What one thread copies and converts each stage: x chunk xc (16 bytes, 8
// values) of rows xr + 32 i, and codes chunk cc (16 codes) of rows cr + 64 i.
// A thread converts exactly the code chunks it copied, so its own
// cp.async wait is enough before it reads them. Rows past M or N are
// zero-filled without a read, and so is K past its end.
constexpr int kXLoads = kWM * 8 / kWThreads;
constexpr int kCLoads = kWN * 4 / kWThreads;
constexpr int kXRowStep = kWThreads / 8;
constexpr int kCRowStep = kWThreads / 4;
static_assert(kXRowStep % 8 == 0, "the swizzle phase of a thread's x rows");

struct WgSlots {
  const __nv_bfloat16* xsrc[kXLoads];  // chunk xc of the thread's x rows
  const uint8_t* csrc[kCLoads];        // chunk cc of its codes rows
  bool xok[kXLoads], cok[kCLoads];
  uint32_t xoff, coff, aoff0, aoff1;   // byte offsets in a stage, row i = 0
  int xc, cc;
};

__device__ __forceinline__ void wg_slots(WgSlots& sl,
                                         const __nv_bfloat16* x,
                                         const uint8_t* codes, int m0, int n0,
                                         int M, int N, int K) {
  const int t = threadIdx.x;
  sl.xc = t & 7;
  sl.cc = t & 3;
  const int xr = t >> 3, cr = t >> 2;
#pragma unroll
  for (int i = 0; i < kXLoads; ++i) {
    const int gm = m0 + xr + i * kXRowStep;
    sl.xok[i] = gm < M;
    sl.xsrc[i] = x + (sl.xok[i] ? (size_t)gm * K : 0) + sl.xc * 8;
  }
#pragma unroll
  for (int i = 0; i < kCLoads; ++i) {
    const int gn = n0 + cr + i * kCRowStep;
    sl.cok[i] = gn < N;
    sl.csrc[i] = codes + (sl.cok[i] ? (size_t)gn * K : 0) + sl.cc * 16;
  }
  sl.xoff = wg::sw128(xr, sl.xc);
  sl.coff = kXBytes + kABytes + cr * kWK + sl.cc * 16;
  sl.aoff0 = kXBytes + wg::sw128(cr, 2 * sl.cc);
  sl.aoff1 = kXBytes + wg::sw128(cr, 2 * sl.cc + 1);
}

// cp.async of stage kt's x and codes into the stage at shared address st
__device__ __forceinline__ void wg_load(const WgSlots& sl, uint32_t st,
                                        const __nv_bfloat16* x,
                                        const uint8_t* codes, int K, int kt) {
  const int k0 = kt * kWK;
  const bool xk = k0 + sl.xc * 8 < K, ck = k0 + sl.cc * 16 < K;
#pragma unroll
  for (int i = 0; i < kXLoads; ++i) {
    const bool ok = sl.xok[i] && xk;
    wg::cp_async16(st + sl.xoff + i * kXRowStep * 128,
                   ok ? sl.xsrc[i] + k0 : x, ok);
  }
#pragma unroll
  for (int i = 0; i < kCLoads; ++i) {
    const bool ok = sl.cok[i] && ck;
    wg::cp_async16(st + sl.coff + i * kCRowStep * kWK,
                   ok ? sl.csrc[i] + k0 : codes, ok);
  }
}

// the thread's raw code chunks of a stage -> bf16 into its swizzled A tile
template <int Q>
__device__ __forceinline__ void wg_convert(const WgSlots& sl, uint8_t* st) {
#pragma unroll
  for (int i = 0; i < kCLoads; ++i) {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        st + sl.coff + i * kCRowStep * kWK);
    const uint2 o0 = codes4_to_bf16<Q>(raw.x), o1 = codes4_to_bf16<Q>(raw.y);
    const uint2 o2 = codes4_to_bf16<Q>(raw.z), o3 = codes4_to_bf16<Q>(raw.w);
    *reinterpret_cast<uint4*>(st + sl.aoff0 + i * kCRowStep * 128) =
        make_uint4(o0.x, o0.y, o1.x, o1.y);
    *reinterpret_cast<uint4*>(st + sl.aoff1 + i * kCRowStep * 128) =
        make_uint4(o2.x, o2.y, o3.x, o3.y);
  }
}

__device__ __forceinline__ void wg_scale_add(float (&acc)[64],
                                             float (&part)[64], float s0,
                                             float s1) {
#pragma unroll
  for (int i = 0; i < 64; ++i)
    acc[i] = fmaf((i & 2) ? s1 : s0, part[i], acc[i]);
}

// Every K-block is whole stages (bk % 64 == 0; the serve shapes' is 128):
// a stage's four k16 steps issue back to back, and each block's scales
// are loaded a block ahead.
template <int Q>
__global__ void __launch_bounds__(kWThreads)
    qmm_wgmma(const __nv_bfloat16* __restrict__ x,
              const uint8_t* __restrict__ codes,
              const float* __restrict__ scales,
              __nv_bfloat16* __restrict__ out, int M, int N, int K, int KB,
              int bk) {
  extern __shared__ __align__(1024) uint8_t qmm_smem[];
  uint8_t* smem = qmm_smem;
  const uint32_t sbase = wg::smem_addr(smem);
  if (sbase & 1023) __trap();  // the swizzle needs it
  const int t = threadIdx.x, lane = t & 31;
  const int g = t >> 7, warp = (t >> 5) & 3;  // warpgroup, warp within it
  const int m0 = blockIdx.x * kWM, n0 = blockIdx.y * kWN;
  const int KT = (K + kWK - 1) / kWK;
  // the two output columns (accumulator rows) this thread holds
  const int r0 = n0 + g * 64 + warp * 16 + lane / 4, r1 = r0 + 8;
  const float* srow0 = scales + (size_t)min(r0, N - 1) * KB;
  const float* srow1 = scales + (size_t)min(r1, N - 1) * KB;
  WgSlots sl;
  wg_slots(sl, x, codes, m0, n0, M, N, K);
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;

  for (int p = 0; p < kWStages - 1; ++p) {
    if (p < KT) wg_load(sl, sbase + p * kStageBytes, x, codes, K, p);
    wg::cp_async_commit();
  }
  wg::cp_async_wait<kWStages - 2>();
  wg_convert<Q>(sl, smem);
  wg::fence_proxy_async();
  __syncthreads();

  const int spb = bk / kWK;  // stages a K-block
  int sib = 0, kb = 0;  // stages into the current K-block, its index
  float s0 = 0.f, s1 = 0.f;
  float ns0 = r0 < N ? srow0[0] : 0.f, ns1 = r1 < N ? srow1[0] : 0.f;
  for (int kt = 0; kt < KT; ++kt) {
    const uint32_t st = sbase + (kt % kWStages) * kStageBytes;
    // this warpgroup's 64 codes rows: 8 KB into the stage's A tile
    const uint32_t aa = st + kXBytes + g * 64 * 128;
    if (sib == 0) {  // a K-block starts: its scales, a fresh partial
      s0 = ns0;
      s1 = ns1;
      if (kb + 1 < KB) {
        ns0 = r0 < N ? srow0[kb + 1] : 0.f;
        ns1 = r1 < N ? srow1[kb + 1] : 0.f;
      }
    }
    wg::fence();
#pragma unroll
    for (int j = 0; j < kWK / 16; ++j)
      wg::mma_m64n128k16(part, wg::desc_sw128(aa + 32 * j),
                         wg::desc_sw128(st + 32 * j), j > 0 || sib > 0);
    wg::commit();
    const bool drain = ++sib == spb;  // the K-block ends with this stage
    if (drain) {
      sib = 0;
      ++kb;
    }
    // while the products run: convert stage kt + 1's codes (this thread's
    // copies have landed), then wait for stage kt - 1's products, or for
    // all of them before the partial is read
    wg::cp_async_wait<kWStages - 3>();
    if (kt + 1 < KT)
      wg_convert<Q>(sl, smem + ((kt + 1) % kWStages) * kStageBytes);
    wg::fence_proxy_async();
    if (drain) {
      wg::wait<0>();
      wg::fence_operand(part);
      wg_scale_add(acc, part, s0, s1);
    } else {
      wg::wait<1>();
    }
    // one barrier publishes the conversion and frees stage kt - 1's
    // buffers, which then take stage kt + kWStages - 1
    __syncthreads();
    const int nt = kt + kWStages - 1;
    if (nt < KT)
      wg_load(sl, sbase + (nt % kWStages) * kStageBytes, x, codes, K, nt);
    wg::cp_async_commit();
  }
  wg::wait<0>();
  wg::cp_async_wait<0>();
  __syncthreads();

  // epilogue: the out^T tile through shared memory as out [kWM m][kWN n]
  __nv_bfloat16* ep = reinterpret_cast<__nv_bfloat16*>(smem);
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int n = g * 64 + warp * 16 + lane / 4 + 8 * ((i >> 1) & 1);
    const int m = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    ep[m * kEpiPitch + n] = __float2bfloat16_rn(acc[i]);
  }
  __syncthreads();
  const bool vec_out = (N % 8) == 0;  // every out row 16-byte aligned
  for (int q = t; q < kWM * (kWN / 8); q += kWThreads) {
    const int r = q / (kWN / 8), c = q % (kWN / 8);
    const int gm = m0 + r, gn = n0 + c * 8;
    if (gm >= M) continue;
    const __nv_bfloat16* src = ep + r * kEpiPitch + c * 8;
    __nv_bfloat16* dst = out + (size_t)gm * N + gn;
    if (vec_out && gn + 8 <= N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && gn + e < N; ++e) dst[e] = src[e];
    }
  }
}

// -- dispatch -----------------------------------------------------------------

constexpr int kRouteRows = 0;  // route codes (kernels/quant_matmul.py)
constexpr int kRouteTiled = 1;
constexpr int kRouteWgmma = 2;
constexpr int kMaxDevices = 64;

template <typename TX, int Q, int MT>
void launch_rows(const void* x, const void* c, const void* s, void* o, int M,
                 int N, int K, int KB, int bk, int vec, cudaStream_t st) {
  const dim3 grid((N + kCols - 1) / kCols, (M + MT - 1) / MT);
  qmm_rows<TX, Q, MT><<<grid, kRowThreads, 0, st>>>(
      (const TX*)x, (const uint8_t*)c, (const float*)s, (TX*)o, M, N, K, KB,
      bk, vec);
}

template <int Q>
int launch_wgmma(const void* x, const void* c, const void* s, void* o,
                 int M, int N, int K, int KB, int bk, cudaStream_t st) {
  auto kernel = qmm_wgmma<Q>;
  // the shared-memory limit is raised once per device, not every launch
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices || !smem_set[dev]) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWSmem);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) smem_set[dev] = true;
  }
  const dim3 grid((M + kWM - 1) / kWM, (N + kWN - 1) / kWN);
  kernel<<<grid, kWThreads, kWSmem, st>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)c, (const float*)s,
      (__nv_bfloat16*)o, M, N, K, KB, bk);
  return 0;
}

template <typename TX, int Q>
int launch(const void* x, const void* c, const void* s, void* o, int M,
           int N, int K, int KB, int bk, int route, cudaStream_t st) {
  if (route == kRouteWgmma) {
    // bf16 x only; whole stages in a block; 16-byte rows and bases
    if (!std::is_same<TX, __nv_bfloat16>::value || bk % kWK ||
        (uintptr_t)x % 16 || (uintptr_t)c % 16 ||
        (N + kWN - 1) / kWN > 65535)
      return (int)cudaErrorInvalidValue;
    return launch_wgmma<Q>(x, c, s, o, M, N, K, KB, bk, st);
  }
  if (route == kRouteTiled) {
    if ((M + kTM - 1) / kTM > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM);
    qmm_tiled<TX, Q><<<grid, kTileThreads, 0, st>>>(
        (const TX*)x, (const uint8_t*)c, (const float*)s, (TX*)o, M, N, K,
        KB, bk);
    return 0;
  }
  if (route != kRouteRows || (M + 7) / 8 > 65535)
    return (int)cudaErrorInvalidValue;
  // 8-byte code loads and 8-element x loads need K % 8 == 0 and aligned
  // bases (every row then starts aligned too)
  const int vec = (K % kVec == 0) && ((uintptr_t)c % 8 == 0) &&
                  ((uintptr_t)x % 16 == 0);
  if (M == 1)
    launch_rows<TX, Q, 1>(x, c, s, o, M, N, K, KB, bk, vec, st);
  else if (M == 2)
    launch_rows<TX, Q, 2>(x, c, s, o, M, N, K, KB, bk, vec, st);
  else if (M <= 4)
    launch_rows<TX, Q, 4>(x, c, s, o, M, N, K, KB, bk, vec, st);
  else
    launch_rows<TX, Q, 8>(x, c, s, o, M, N, K, KB, bk, vec, st);
  return 0;
}

}  // namespace

// x [M, K]; codes [N, K] (int8 or float8 e4m3); scales [N, KB] float32 with
// bk = K / KB; out [M, N] in x's dtype (0 = float32, 1 = bfloat16). All
// contiguous. q_dtype: 0 = int8, 1 = float8 e4m3. route: 0 = rows (the
// GEMV), 1 = tiled (CUDA cores), 2 = wgmma (tensor cores; bf16 x only).
// Returns the CUDA error code of the launch (0 on success);
// cudaErrorInvalidValue for inputs the chosen route does not take.
extern "C" int quant_matmul_fwd(const void* x, const void* codes,
                                const void* scales, void* out, int M, int N,
                                int K, int KB, int bk, int x_dtype,
                                int q_dtype, int route, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || KB <= 0 || bk <= 0 || bk * KB != K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  if (x_dtype == ptt::kFloat32 && q_dtype == kQInt8)
    rc = launch<float, kQInt8>(x, codes, scales, out, M, N, K, KB, bk, route,
                               st);
  else if (x_dtype == ptt::kFloat32 && q_dtype == kQFp8)
    rc = launch<float, kQFp8>(x, codes, scales, out, M, N, K, KB, bk, route,
                              st);
  else if (x_dtype == ptt::kBFloat16 && q_dtype == kQInt8)
    rc = launch<__nv_bfloat16, kQInt8>(x, codes, scales, out, M, N, K, KB,
                                       bk, route, st);
  else if (x_dtype == ptt::kBFloat16 && q_dtype == kQFp8)
    rc = launch<__nv_bfloat16, kQFp8>(x, codes, scales, out, M, N, K, KB, bk,
                                      route, st);
  else
    return (int)cudaErrorInvalidValue;
  if (rc) return rc;
  return (int)cudaGetLastError();
}
