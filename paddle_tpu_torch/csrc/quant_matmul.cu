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
// card's balance point, so it is bound by device-memory bytes: 46.5 MB of
// codes and scales at K 4096, N 11008 take 13.9 us at 3.35 TB/s. At
// prefill (M in the hundreds or thousands) it is bound by operations: M
// 1024, K 4096, N 11008 is 9.2e10 flops against about 77 MB, so the lever
// is the tensor cores (989 TFLOP/s in bf16), not the bytes.
//
// Every int8 code (-127..127) and every finite e4m3 value is exact in bf16,
// so both tensor-core kernels multiply the codes themselves against bf16
// x: each product is exact and sums in float32. The scale is NOT folded
// into the weight (a bf16 code * scale would round each weight by up to
// 2^-9 and put a K 4096 output about 1e-3 of its size off the float32
// reference): each K-block's k16 steps accumulate a float32 partial that
// starts at zero on the block's first step, and the block's float32 scale
// is applied on the accumulator, acc += scale * partial. Both compute the
// product transposed, out^T = codes . x^T, so that a scale belongs to an
// accumulator row. The codes become bf16 without the slow hardware
// conversions (`codes4_to_bf16`, mma.cuh).
//
// Four kernels; the wrapper (kernels/quant_matmul.py, `qmm_route`) picks
// one and passes it in, and a kernel that cannot take the inputs is an
// error, never a silent switch to another:
// - "gemv_tc" (bf16 x, M <= 32, bk % 16 == 0, 16-byte aligned x and codes;
//   `qmm_gemv_tc`), the decode GEMV on the tensor cores. The CUDA-core
//   GEMV ("rows") ran at 13-18 % of the byte bound: a block owned 4
//   columns, so x was pulled through L2 for every 4 columns (about 4x the
//   code bytes), every code went through a quarter-rate I2F, a multiply
//   by its scale and M FMAs, and each lane had one 8-byte code load in
//   flight. Here:
//   * a block of 8 warps owns 128 output columns, 16 a warp, and a
//     K-slice. Codes, x and the scales come through a ring of 3 stages of
//     128 k by cp.async (16 bytes a copy for codes and x, codes rows past
//     N and x rows past M zero-filled without a read; 4 bytes for a
//     column's scale of each K-block the stage touches), so each x value
//     crosses L2 once per 128 columns (1/8 of the code bytes at M 8), a
//     codes row is read 128 contiguous bytes at a time, two stages (about
//     50 KB) a block are in flight, and no scale is read from device
//     memory inside the loop;
//   * each warp's k16 step is one `mma.sync` m16n8k16 per 8 rows of x
//     (mma.cuh): 16 columns of codes are A, x supplies one n8 B tile per 8
//     rows (M <= 8 one, M <= 32 four). Inside a step a lane takes 4
//     contiguous codes of each of its two rows and 4 contiguous values of
//     its x row (the same k permutation for A and B), so no ldmatrix or
//     repack is needed, and a step never straddles a K-block. A stage that
//     lies in one K-block (every stage at bk 128) runs its 8 steps back to
//     back; smaller blocks and a slice's last stage check each step;
//   * the column tiles alone do not fill 132 SMs (N 4096 is 32 tiles), so
//     K is cut into slices of whole K-blocks: the most, at most 7, whose
//     thread-block clusters all fit on the card at once (asked of the
//     occupancy calculator once per device). The slices of a column tile
//     are one cluster:
//     after the loop each block leaves its float32 partial tile in shared
//     memory, and each block sums its share of the tile over the cluster's
//     blocks in rank order (slice order) through distributed shared memory
//     and writes it in bf16. One launch, no float atomics, the same bits
//     every run.
//   It reaches about half the byte bound on an H100, and both halves of
//   its work hold it (`chip_smoke.py --gemv-cost`): the ring's loads
//   alone (no products) and the products alone (no code reads) each take
//   about four fifths of its time. The products are instruction issue:
//   converting 4 int8 codes takes 11 integer and float32 instructions
//   (18 for e4m3), most of what a step issues.
// - "rows" (every other M <= 32: float32 x, blocks not a multiple of 16,
//   unaligned data; `qmm_rows`), the CUDA-core GEMV: one block of 4 warps
//   per 4 output columns and up to 8 rows of x (grid.y walks further
//   groups of 8 rows). The warps split K; each lane loads 8 codes of each
//   of the 4 columns at a time (one 8-byte load per column, neighbouring
//   lanes on neighbouring bytes), dequantizes them, and applies them to
//   every row of x, so each code tile is read from device memory once and
//   used M times. The partial sums meet through a warp reduction and
//   shared memory. Float32 x (the head, the float32 engines) stays here:
//   the tensor cores would round x to bf16, and the float32 serves are
//   compared token for token.
// - "wgmma" (bf16 x, M > 32, bk % 64 == 0, 16-byte aligned x and codes;
//   `qmm_wgmma`), the prefill product on the tensor cores. In the
//   m64n128k16 layout a thread holds two accumulator rows, so two scales
//   per block. A block of two warpgroups owns a 128 (n) x 128 (m) tile,
//   64 codes rows each against the one x tile they share; both operands
//   sit K-major in shared memory with the 128-byte swizzle (wgmma.cuh), 64
//   values of K a stage, in a ring of 4 stages (160 KB of dynamic shared
//   memory, one block an SM). x arrives by cp.async (rows past M
//   zero-filled, never read); the codes arrive by cp.async into a byte
//   staging buffer, and each thread converts the chunks it copied to bf16
//   in the swizzled A tile while the previous stage's products run. One
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
//   dequantized to float32 on its way into shared memory. TF32 tensor
//   cores would round float32 x to 10 mantissa bits.
// No TMA, mbarrier ring or warp specialisation yet: those are the next
// steps for both tensor-core kernels.

#include <stdint.h>
#include <type_traits>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace {

using ptt::from_float;
using ptt::to_float;
using ptt::warp_sum;
using ptt::mma::codes4_to_bf16;

constexpr int kQInt8 = ptt::mma::kCodeInt8;  // kernels/quant_matmul.py
constexpr int kQFp8 = ptt::mma::kCodeFp8;

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

// -- small M on CUDA cores: float32 x and what the tensor cores do not take --

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

// -- small M, bf16 x: the decode GEMV on the tensor cores --------------------

namespace cg = cooperative_groups;

constexpr int kGWarps = 8;               // warps a block, 16 columns each
constexpr int kGThreads = 32 * kGWarps;
constexpr int kGCols = 16 * kGWarps;     // output columns a block
constexpr int kGK = 128;                 // K a stage
constexpr int kGStages = 3;
constexpr int kGSteps = kGK / 16;        // k16 steps a stage
// padded rows keep a step's fragment reads free of bank conflicts: a
// lane's codes word at 4 g + t (mod 32 words), its x pair at 8 g + 2 t
constexpr int kGCPitch = kGK + 16;       // bytes a codes row of a stage
constexpr int kGXPitch = kGK + 16;       // bf16 an x row of a stage
constexpr int kGCBytes = kGCols * kGCPitch;
// a stage touches at most kGSteps K-blocks (bk >= 16, stages start on k16
// steps): their scales, kGCols a block
constexpr int kGSBytes = kGSteps * kGCols * 4;
constexpr int kGRedPitch = kGCols + 4;   // floats a row of the partial tile
// K-slices a column tile at most: clusters of 8 ran slower than of 7 at
// N 4096 in trials on an H100
constexpr int kGMaxSplits = 7;
static_assert(kGThreads % kGSteps == 0 && kGCols % (kGThreads / kGSteps) == 0,
              "whole codes chunks a thread");
static_assert(kGThreads % kGCols == 0, "whole scale columns a thread");
static_assert(4 * 8 * (kGK / 8) <= 2 * kGThreads, "two x chunks a thread");

template <int MT>  // MT n8 tiles of x: M <= 8 MT
__host__ __device__ constexpr int gemv_stage_bytes() {
  return kGCBytes + kGSBytes + MT * 8 * kGXPitch * 2;
}
template <int MT>
__host__ __device__ constexpr int gemv_smem() {
  return kGStages * gemv_stage_bytes<MT>();
}
static_assert(32 * kGRedPitch * 4 <= gemv_smem<1>(),
              "the partial tile fits in the ring");
// blocks an SM that the ring leaves room for (228 KB of shared memory an
// SM, 1 KB of it reserved a block): 3 at MT 1 (74.5 KB), 2 at MT 2 (81.4
// KB) and MT 4 (95.2 KB); the register budget of __launch_bounds__
template <int MT>
__host__ __device__ constexpr int gemv_blocks_per_sm() {
  return (228 * 1024) / (gemv_smem<MT>() + 1024);
}

// What one thread copies each stage, fixed for the kernel: 16 codes
// (chunk c) of kGCols / kCRows codes rows, 8 values of up to kXLoads x
// rows, and the scales of column t % kGCols for the stage's K-blocks of
// parity t / kGCols. A chunk past N, M or the slice's end is zero-filled
// without a read.
constexpr int kGCRowStep = kGThreads / kGSteps;  // a thread's codes rows
constexpr int kGCLoads = kGCols / kGCRowStep;     // codes chunks a thread
constexpr int kGXChunks = kGK / 8;                // 16-byte chunks an x row
struct GemvSlots {
  const uint8_t* c;       // the first codes chunk, at k = 0
  const __nv_bfloat16* x[2];
  const float* s;         // the column's scale row
  uint32_t coff, xoff[2];
  unsigned cok;           // bit i: codes row i of the thread lies below N
  bool xok[2], sok;
  int ck, xk;             // the chunks' first k in a stage
};

template <int MT>
__device__ __forceinline__ void gemv_slots(GemvSlots& sl,
                                           const __nv_bfloat16* x,
                                           const uint8_t* codes,
                                           const float* scales, int n0,
                                           int M, int N, int K, int KB) {
  const int t = threadIdx.x;
  const int r = t / kGSteps, c = t % kGSteps;
  sl.ck = 16 * c;
  sl.cok = 0;
#pragma unroll
  for (int i = 0; i < kGCLoads; ++i)
    sl.cok |= (unsigned)(n0 + r + i * kGCRowStep < N) << i;
  sl.c = codes + (sl.cok ? (size_t)(n0 + r) * K : 0) + sl.ck;
  sl.coff = r * kGCPitch + sl.ck;
  sl.xk = 8 * (t % kGXChunks);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int xr = (t + i * kGThreads) / kGXChunks;
    sl.xok[i] = xr < M && xr < 8 * MT;
    sl.x[i] = x + (sl.xok[i] ? (size_t)xr * K : 0) + sl.xk;
    sl.xoff[i] = kGCBytes + kGSBytes + xr * kGXPitch * 2 + 2 * sl.xk;
  }
  const int sn = n0 + t % kGCols;
  sl.sok = sn < N;
  sl.s = scales + (sl.sok ? (size_t)sn * KB : 0);
}

// cp.async of the stage that starts at k = ks into the stage at shared
// address st: the 128 columns' codes [ks, ks + kGK), x's rows, and the
// scales of the K-blocks the stage touches (the first, ks / bk, in slot 0)
template <int MT>
__device__ __forceinline__ void gemv_load(const GemvSlots& sl, uint32_t st,
                                          const __nv_bfloat16* x,
                                          const uint8_t* codes,
                                          const float* scales, int K, int bk,
                                          int ks, int kend) {
  const bool ck = ks + sl.ck < kend;
#pragma unroll
  for (int i = 0; i < kGCLoads; ++i) {
    const bool ok = ((sl.cok >> i) & 1) && ck;
    wg::cp_async16(st + sl.coff + i * kGCRowStep * kGCPitch,
                   ok ? sl.c + (size_t)i * kGCRowStep * K + ks : codes, ok);
  }
  const bool xk = ks + sl.xk < kend;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (threadIdx.x + i * kGThreads < MT * 8 * kGXChunks) {
      const bool ok = sl.xok[i] && xk;
      wg::cp_async16(st + sl.xoff[i], ok ? sl.x[i] + ks : x, ok);
    }
  const int bs = ks / bk;
  const int nb = (min(ks + kGK, kend) - 1) / bk + 1 - bs;
  for (int j = threadIdx.x / kGCols; j < nb; j += kGThreads / kGCols)
    wg::cp_async4(st + kGCBytes + 4 * (j * kGCols + threadIdx.x % kGCols),
                  sl.sok ? sl.s + bs + j : scales, sl.sok);
}

// one k16 step of a warp: its 16 columns' code words (rows g and g + 8)
// against the stage's x rows at the step's first value
template <int Q, int MT>
__device__ __forceinline__ void gemv_step(float (&part)[MT][4],
                                          const uint32_t (&w)[2],
                                          const __nv_bfloat16* xrows) {
  uint32_t a[4];
  ptt::mma::frag_a_words<Q>(w[0], w[1], a);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    uint32_t b[2];
    ptt::mma::frag_b_rows(xrows + i * 8 * kGXPitch, kGXPitch, b);
    ptt::mma::mma_m16n8k16(part[i], a, b);
  }
}

template <int MT>
__device__ __forceinline__ void gemv_zero(float (&part)[MT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) part[i][r] = 0.f;
}

// a K-block's scales on its partial: s0 for column g, s1 for g + 8
template <int MT>
__device__ __forceinline__ void gemv_scale_add(float (&acc)[MT][4],
                                               const float (&part)[MT][4],
                                               float s0, float s1) {
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    acc[i][0] = fmaf(s0, part[i][0], acc[i][0]);
    acc[i][1] = fmaf(s0, part[i][1], acc[i][1]);
    acc[i][2] = fmaf(s1, part[i][2], acc[i][2]);
    acc[i][3] = fmaf(s1, part[i][3], acc[i][3]);
  }
}

// Launched as clusters of (1, splits, 1) blocks: cluster rank r owns
// K-blocks [r KB / splits, (r + 1) KB / splits) of column tile blockIdx.x.
template <int Q, int MT>
__global__ void __launch_bounds__(kGThreads, gemv_blocks_per_sm<MT>())
    qmm_gemv_tc(const __nv_bfloat16* __restrict__ x,
                const uint8_t* __restrict__ codes,
                const float* __restrict__ scales,
                __nv_bfloat16* __restrict__ out, int M, int N, int K, int KB,
                int bk) {
  extern __shared__ __align__(16) uint8_t gemv_buf[];
  constexpr int kStage = gemv_stage_bytes<MT>();
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, q = lane & 3;
  const int n0 = blockIdx.x * kGCols;
  const int kb0 = (int)((long long)rank * KB / S);
  const int kb1 = (int)((long long)(rank + 1) * KB / S);
  const int k0 = kb0 * bk, kend = kb1 * bk;
  const int nstages = (kend - k0 + kGK - 1) / kGK;
  const uint32_t sbase = wg::smem_addr(gemv_buf);

  GemvSlots sl;
  gemv_slots<MT>(sl, x, codes, scales, n0, M, N, K, KB);
  for (int p = 0; p < kGStages - 1; ++p) {
    if (p < nstages)
      gemv_load<MT>(sl, sbase + p * kStage, x, codes, scales, K, bk,
                    k0 + p * kGK, kend);
    wg::cp_async_commit();
  }

  // this lane's two output columns are accumulator rows g and g + 8 of its
  // warp's 16; a column past N has zero codes and no output
  float acc[MT][4], part[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = part[i][j] = 0.f;
  const int spb = bk / 16;  // k16 steps a K-block
  int kin = 0, kb = kb0;    // steps into the current K-block, its index
  float s0 = 0.f, s1 = 0.f;

  for (int st = 0; st < nstages; ++st) {
    wg::cp_async_wait<kGStages - 2>();
    // publishes stage st and frees stage st - 1's buffer for the next load
    __syncthreads();
    const int nt = st + kGStages - 1;
    if (nt < nstages)
      gemv_load<MT>(sl, sbase + (nt % kGStages) * kStage, x, codes, scales,
                    K, bk, k0 + nt * kGK, kend);
    wg::cp_async_commit();
    const int ks = k0 + st * kGK;
    const uint8_t* stage = gemv_buf + (st % kGStages) * kStage;
    const uint8_t* arows = stage + (warp * 16 + g) * kGCPitch + 4 * q;
    // the scales of the stage's K-blocks, from block ks / bk in slot 0
    const float* sc = reinterpret_cast<const float*>(stage + kGCBytes) +
                      warp * 16 + g;
    const int bs = ks / bk;
    const __nv_bfloat16* xrows =
        reinterpret_cast<const __nv_bfloat16*>(stage + kGCBytes + kGSBytes);
    const int steps = min(kGSteps, (kend - ks) / 16);
    // every code word of the stage first, then the products
    uint32_t w[kGSteps][2];
#pragma unroll
    for (int j = 0; j < kGSteps; ++j)
      if (j < steps) {
        w[j][0] = *reinterpret_cast<const uint32_t*>(arows + 16 * j);
        w[j][1] = *reinterpret_cast<const uint32_t*>(arows + 8 * kGCPitch +
                                                     16 * j);
      }
    if (steps == kGSteps && kin + kGSteps <= spb) {
      // the whole stage lies in one K-block (every stage of the codec's
      // bk 128): its steps back to back, the scale at the block's end
      if (kin == 0) {
        s0 = sc[(kb - bs) * kGCols];
        s1 = sc[(kb - bs) * kGCols + 8];
        gemv_zero<MT>(part);
      }
#pragma unroll
      for (int j = 0; j < kGSteps; ++j)
        gemv_step<Q, MT>(part, w[j], xrows + 16 * j);
      kin += kGSteps;
      if (kin == spb) {
        kin = 0;
        ++kb;
        gemv_scale_add<MT>(acc, part, s0, s1);
      }
    } else {
      // blocks of fewer steps than a stage, or the slice's last stage
#pragma unroll
      for (int j = 0; j < kGSteps; ++j) {
        if (j >= steps) break;
        if (kin == 0) {  // a K-block starts: its scales, a fresh partial
          s0 = sc[(kb - bs) * kGCols];
          s1 = sc[(kb - bs) * kGCols + 8];
          gemv_zero<MT>(part);
        }
        gemv_step<Q, MT>(part, w[j], xrows + 16 * j);
        if (++kin == spb) {  // the K-block ends: its scale on the partial
          kin = 0;
          ++kb;
          gemv_scale_add<MT>(acc, part, s0, s1);
        }
      }
    }
  }
  wg::cp_async_wait<0>();
  __syncthreads();  // the ring is free: it takes the partial tile

  // the slice's partial tile [8 MT rows of x][128 columns], float32
  float* red = reinterpret_cast<float*>(gemv_buf);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int m = 8 * i + 2 * q, c = warp * 16 + g;
    red[m * kGRedPitch + c] = acc[i][0];
    red[(m + 1) * kGRedPitch + c] = acc[i][1];
    red[m * kGRedPitch + c + 8] = acc[i][2];
    red[(m + 1) * kGRedPitch + c + 8] = acc[i][3];
  }
  cluster.sync();
  // this block's share of the tile's M x 128 outputs, each the sum of the
  // cluster's partials in rank (slice) order
  const int E = M * kGCols;
  const int lo = (int)((long long)rank * E / S);
  const int hi = (int)((long long)(rank + 1) * E / S);
  for (int e = lo + t; e < hi; e += kGThreads) {
    const int m = e / kGCols, c = e % kGCols;
    if (n0 + c >= N) continue;
    float v = 0.f;
    for (int r = 0; r < S; ++r)
      v += cluster.map_shared_rank(red, r)[m * kGRedPitch + c];
    out[(size_t)m * N + n0 + c] = __float2bfloat16_rn(v);
  }
  cluster.sync();  // no block leaves while another reads its tile
}

// -- dispatch -----------------------------------------------------------------

constexpr int kRouteRows = 0;  // route codes (kernels/quant_matmul.py)
constexpr int kRouteTiled = 1;
constexpr int kRouteWgmma = 2;
constexpr int kRouteGemvTc = 3;
using ptt::kMaxDevices;
using ptt::raise_smem;

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
  static bool smem_set[kMaxDevices] = {};
  if (int e = raise_smem(kernel, kWSmem, smem_set)) return e;
  const dim3 grid((M + kWM - 1) / kWM, (N + kWN - 1) / kWN);
  kernel<<<grid, kWThreads, kWSmem, st>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)c, (const float*)s,
      (__nv_bfloat16*)o, M, N, K, KB, bk);
  return 0;
}

// One cluster of `splits` blocks (the K-slices) per 128-column tile. The
// split is the largest (at most kGMaxSplits, at most one a K-block) whose
// clusters all fit on the card at once: a second wave of clusters
// repeats the ring's ramp and the exchange, and cost more than the
// blocks it adds in trials on an H100.
template <int Q, int MT>
int launch_gemv_tc(const void* x, const void* c, const void* s, void* o,
                   int M, int N, int K, int KB, int bk, cudaStream_t st) {
  auto kernel = qmm_gemv_tc<Q, MT>;
  constexpr int smem = gemv_smem<MT>();
  static bool smem_set[kMaxDevices] = {};
  if (int e = raise_smem(kernel, smem, smem_set)) return e;
  // 1 + the clusters of each size that fit at once, asked once per device
  static int fit[kMaxDevices][kGMaxSplits + 1] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (N + kGCols - 1) / kGCols;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kGThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int splits = min(kGMaxSplits, KB);
  for (; splits > 1; --splits) {
    cfg.gridDim = dim3(tiles, splits, 1);
    attr[0].val.clusterDim.y = splits;
    int n = dev < kMaxDevices ? fit[dev][splits] - 1 : -1;
    if (n < 0) {
      e = cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg);
      if (e != cudaSuccess) return (int)e;
      if (dev < kMaxDevices) fit[dev][splits] = n + 1;
    }
    if (n >= tiles) break;
  }
  cfg.gridDim = dim3(tiles, splits, 1);
  attr[0].val.clusterDim.y = splits;
  return (int)cudaLaunchKernelEx(&cfg, kernel, (const __nv_bfloat16*)x,
                                 (const uint8_t*)c, (const float*)s,
                                 (__nv_bfloat16*)o, M, N, K, KB, bk);
}

template <typename TX, int Q>
int launch(const void* x, const void* c, const void* s, void* o, int M,
           int N, int K, int KB, int bk, int route, cudaStream_t st) {
  if (route == kRouteGemvTc) {
    // bf16 x, at most 32 rows; k16 steps inside K-blocks; 16-byte rows and
    // bases
    if (!std::is_same<TX, __nv_bfloat16>::value || M > 32 || bk % 16 ||
        (uintptr_t)x % 16 || (uintptr_t)c % 16)
      return (int)cudaErrorInvalidValue;
    if (M <= 8) return launch_gemv_tc<Q, 1>(x, c, s, o, M, N, K, KB, bk, st);
    if (M <= 16)
      return launch_gemv_tc<Q, 2>(x, c, s, o, M, N, K, KB, bk, st);
    return launch_gemv_tc<Q, 4>(x, c, s, o, M, N, K, KB, bk, st);
  }
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
// CUDA-core GEMV), 1 = tiled (CUDA cores), 2 = wgmma (tensor cores; bf16 x
// only), 3 = gemv_tc (the tensor-core GEMV; bf16 x, M <= 32). Returns the CUDA error code of the launch (0 on success);
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
