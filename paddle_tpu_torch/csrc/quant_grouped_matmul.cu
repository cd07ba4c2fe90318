// Grouped matmul over block-scaled int8 / fp8 expert weights.
//
// Replaces: paddle_tpu/kernels/pallas/quant_matmul.py, `_gq_kernel`
// launched by `_gq_call` (the pallas_call at line 263).
//
// Computes, for x [Tp, K] (float32 or bfloat16) sorted by expert as
// grouped_matmul.cu reads it (group e at the tile-aligned row offsets[e],
// counts[e] rows), codes [E, N, K] (int8 or float8 e4m3, each expert in
// the torch Linear layout of kernels/quant_matmul.py) and scales [E, N,
// KB] float32 with block bk = K / KB:
//   out[r, n] = sum_k x[r, k] * codes[e(r), n, k] * scales[e(r), n, k / bk]
// over each group's live tiles, accumulated in float32 and written in x's
// dtype. The full-width expert weights never exist in device memory, as
// the TPU kernel keeps them in VMEM. Rows past a group's live tiles are
// not written. The routing stays on the card: each block reads its
// group's offset and count and returns at once past the live tiles.
//
// What bounds it on the H100: the MoE layer's shapes (16,384 routes, K
// and N 768 and 3072) do 77.3 GFLOP a launch on about 0.1 GB, so
// operations bound it, and only the tensor cores come near that bound:
// the CUDA cores' float32 peak (67 TFLOP/s) holds any design on them, and
// one PyTorch call (per-expert float32 matmul) with them.
//
// Two kernels; the wrapper (kernels/quant_matmul.py, `gq_route`) picks one
// and passes it in, and a kernel that cannot take the inputs is an error,
// never a silent switch to another:
// - "wgmma" (`quant_grouped_wgmma`: float32 or bf16 x, bk % 64 == 0, bm %
//   128 == 0, 16-byte aligned x and codes), the product on the tensor
//   cores, `qmm_wgmma`'s design (quant_matmul.cu) made grouped. Every int8
//   code and every finite e4m3 value is exact in bf16, so the kernel
//   multiplies the codes themselves, converted exactly (`codes4_to_bf16`,
//   mma.cuh), and computes out^T = codes . x^T, so that a scale belongs
//   to an accumulator row. The grid is (N / 128, Tp / 128, E); since bm
//   is a multiple of 128, a 128-row token tile never straddles two
//   experts. A block of two warpgroups owns a 128 (n) x 128 (token) tile,
//   64 codes rows each against the token tile they share; both operands
//   sit K-major in shared memory with the 128-byte swizzle (wgmma.cuh), 64
//   values of K a stage. The codes arrive by cp.async into a byte staging
//   buffer and each thread converts the chunks it copied while the
//   previous stage's products run. bf16 x arrives by cp.async, one
//   product a k16 step, in a ring of 4 stages (160 KB). float32 x is split
//   exactly into three bf16 panels, hi + mid + lo (`split3`, wgmma.cuh):
//   each piece times a code is exact in float32, so three chained
//   products a k16 step give the float32 products, differing from the
//   plain version only in summation order. Two truncated pieces leave up
//   to 2^-16 of each x, all of one sign: on unit normal x at K 768 and
//   3072 that alone takes 0.93 of the float32 rule (1e-6 |ref| + 1e-5
//   max|ref|) before any summation-order error, one piece 310 times it
//   (tests/test_torch_quant_grouped_matmul.py); TF32 keeps 10 bits of x.
//   x goes through registers: each thread issues its 16-byte loads of
//   stage kt + 2 after the barrier of stage kt and splits them into the
//   panels of stage kt + 2 while stage kt + 1's products run, so a stage
//   is 8 KB of codes bytes, the 16 KB A tile and three 16 KB panels, and
//   three stages fit (216 KB; a float32 staging buffer in shared memory
//   would leave room for two).
//   Each K-block's float32 partial starts at zero on its first k16 step,
//   and the block's float32 scale goes on the accumulator, acc += s[n,
//   kb] * partial, two scales a thread, loaded a block ahead: a scale
//   folded into a bf16 weight would round each weight by up to 2^-9. The
//   partial is drained (wait_group 0) at each K-block's end. Rows past
//   the group's live rows and codes rows past N are zero-filled and never
//   read. The epilogue moves the tile through shared memory and writes
//   the group's live rows in x's dtype with 16-byte stores. No atomics: a
//   second launch gives the same bits.
// - "cuda_core" (`quant_grouped_fwd`: everything else, a block not a
//   multiple of 64, bm not a multiple of 128, unaligned data), the
//   forward grouped kernel's CUDA-core tile (grouped_gemm.cuh) with the
//   weight tile's loader swapped for one that reads 4 codes of an output
//   column (one 4-byte load) and dequantizes them in registers.
// No TMA, mbarrier ring or warp specialisation yet.

#include <type_traits>
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "common.cuh"
#include "grouped_gemm.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace {

using namespace ptt::gg;

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

// Bs[c][j] = codes[n0 + j, k0 + c] * scales[n0 + j, (k0 + c) / bk] of one
// expert's [N, K] codes. Thread t reads output column t / 2, four
// consecutive codes (one 4-byte load when vec).
template <int Q>
struct QuantB {
  const uint8_t* codes;
  const float* scales;
  int K, N, KB, bk, n0;
  bool vec;
  int j, c4;

  __device__ QuantB(const uint8_t* codes_, const float* scales_, int K_,
                    int N_, int KB_, int bk_, int n0_, bool vec_)
      : codes(codes_), scales(scales_), K(K_), N(N_), KB(KB_), bk(bk_),
        n0(n0_), vec(vec_), j(threadIdx.x >> 1),
        c4((threadIdx.x & 1) * 4) {}

  __device__ __forceinline__ void load(int k0, float* r) const {
    const int n = n0 + j;
    const int k = k0 + c4;
    const int nv = n < N ? clamp4(K - k) : 0;
    const uint8_t* p = codes + (size_t)n * K + k;
    const float* s = scales + (size_t)n * KB;
    if (vec && nv == 4) {
      const unsigned raw = *reinterpret_cast<const unsigned*>(p);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = code_to_float<Q>(raw >> (8 * i)) * s[(k + i) / bk];
      return;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = i < nv ? code_to_float<Q>(p[i]) * s[(k + i) / bk] : 0.f;
  }
  __device__ __forceinline__ void store(float (*bs)[kBN + kPad],
                                        const float* r) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) bs[c4 + i][j] = r[i];
  }
};

template <typename T, int Q>
__global__ void __launch_bounds__(kThreads, 2)
    quant_grouped_fwd(const T* __restrict__ x,
                      const uint8_t* __restrict__ codes,
                      const float* __restrict__ scales, T* __restrict__ out,
                      const int* __restrict__ offsets,
                      const int* __restrict__ counts, int Tp, int K, int N,
                      int KB, int bk, int bm, int vec_a, int vec_b) {
  __shared__ __align__(16) Smem sm;
  const int e = blockIdx.z;
  const int live = live_rows(counts, e, bm);
  const int t0 = blockIdx.y * kBM;
  if (t0 >= live) return;               // past the group's live tiles
  const int row0 = offsets[e] + t0;
  const int row_end = min(offsets[e] + live, Tp);
  if (row0 >= row_end) return;
  const int n0 = blockIdx.x * kBN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[8][8];
  zero_acc(acc);
  const RowsA<T> la(x, K, row0, row_end, vec_a);
  const QuantB<Q> lb(codes + (size_t)e * N * K, scales + (size_t)e * N * KB,
                     K, N, KB, bk, n0, vec_b);
  mainloop(la, lb, K, sm, acc, tx, ty);
  store_tile<T, T>(out, N, row0, row_end, n0, nullptr, acc, tx, ty);
}

template <typename T, int Q>
int launch_cuda_core(const void* x, const void* codes, const void* scales,
                     void* out, const int* offsets, const int* counts, int E,
                     int Tp, int K, int N, int KB, int bk, int bm,
                     cudaStream_t st) {
  const int vec_a = (K % 4 == 0) && ((uintptr_t)x % (sizeof(T) * 4) == 0);
  const int vec_b = (K % 4 == 0) && ((uintptr_t)codes % 4 == 0);
  const dim3 grid((N + kBN - 1) / kBN, (Tp + kBM - 1) / kBM, E);
  quant_grouped_fwd<T, Q><<<grid, kThreads, 0, st>>>(
      (const T*)x, (const uint8_t*)codes, (const float*)scales, (T*)out,
      offsets, counts, Tp, K, N, KB, bk, bm, vec_a, vec_b);
  return (int)cudaGetLastError();
}

// -- the tensor-core kernel -------------------------------------------------

namespace wg = ptt::wg;
using ptt::mma::codes4_to_bf16;

constexpr int kWN = 128;   // codes rows (output columns) a block, 64 a group
constexpr int kWM = 128;   // token rows a block: wgmma's N
constexpr int kWK = 64;    // K a stage: one 128-byte swizzled row of bf16
constexpr int kWThreads = 256;
constexpr int kPanel = kWM * kWK * 2;  // one bf16 x tile (a piece), 16 KB
constexpr int kATile = kWN * kWK * 2;  // converted codes, 16 KB
constexpr int kCBuf = kWN * kWK;       // raw codes, one byte each, 8 KB
constexpr int kXRows = kWThreads / 8;  // rows apart of a thread's x chunks
constexpr int kXLoads = kWM / kXRows;  // x chunks a thread a stage
constexpr int kCRows = kWThreads / 4;  // rows apart of its codes chunks
constexpr int kCLoads = kWN / kCRows;  // codes chunks a thread a stage

// A stage holds x (one bf16 tile, or the three pieces of float32 x), then
// the converted codes, then the raw codes; every tile starts on a
// 1024-byte boundary, as the swizzle needs.
template <typename T>
struct GqLayout {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kPieces = kF32 ? 3 : 1;  // hi, mid, lo
  static constexpr int kStages = kF32 ? 3 : 4;
  static constexpr int kA = kPieces * kPanel;
  static constexpr int kC = kA + kATile;
  static constexpr int kStage = kC + kCBuf;
  static constexpr int kSmem = kStages * kStage;  // 216 KB, 160 KB
  static constexpr int kEpiPitch = kWN + 16 / (int)sizeof(T);
};
static_assert(GqLayout<float>::kSmem <= 232448, "the float32 ring fits");
static_assert(GqLayout<float>::kStage % 1024 == 0 &&
                  GqLayout<__nv_bfloat16>::kStage % 1024 == 0,
              "stages start on 1024-byte boundaries");
static_assert(kWM * GqLayout<float>::kEpiPitch * 4 <=
                  GqLayout<float>::kSmem,
              "the epilogue tile fits");

// What one thread copies each stage: x chunk xc (8 values) of token rows
// xr + kXRows i, and codes chunk cc (16 codes) of codes rows cr + kCRows
// i. A thread converts exactly the code chunks it copied, so its own
// cp.async wait is enough before it reads them.
template <typename T>
struct GqSlots {
  const T* xs;            // chunk xc of the thread's first x row
  const uint8_t* cs;      // chunk cc of its first codes row
  int xrows, crows;       // how many of its x / codes rows exist
  uint32_t xoff, coff, aoff0, aoff1;  // byte offsets in a stage, i = 0
  long long xstep, cstep;  // elements between its rows i and i + 1
};

template <typename T>
__device__ __forceinline__ GqSlots<T> gq_slots(const T* x,
                                               const uint8_t* codes, int row0,
                                               int row_end, int n0, int N,
                                               int K) {
  using L = GqLayout<T>;
  const int t = threadIdx.x;
  const int xc = t & 7, xr = t >> 3, cc = t & 3, cr = t >> 2;
  GqSlots<T> sl;
  sl.xs = x + (size_t)(row0 + xr) * K + xc * 8;
  sl.cs = codes + (size_t)(n0 + cr) * K + cc * 16;
  sl.xrows = (row_end - row0 - xr + kXRows - 1) / kXRows;  // may be <= 0
  sl.crows = (N - n0 - cr + kCRows - 1) / kCRows;
  sl.xoff = wg::sw128(xr, xc);
  sl.coff = L::kC + cr * kWK + cc * 16;
  sl.aoff0 = L::kA + wg::sw128(cr, 2 * cc);
  sl.aoff1 = L::kA + wg::sw128(cr, 2 * cc + 1);
  sl.xstep = (long long)kXRows * K;
  sl.cstep = (long long)kCRows * K;
  return sl;
}

// cp.async of stage kt's codes (and bf16 x) into the stage at shared
// address st; rows past the live ones are zero-filled without a read
template <typename T>
__device__ __forceinline__ void gq_copy(const GqSlots<T>& sl, uint32_t st,
                                        int kt) {
  const int k0 = kt * kWK;
  if constexpr (!GqLayout<T>::kF32) {
#pragma unroll
    for (int i = 0; i < kXLoads; ++i) {
      const bool ok = i < sl.xrows;
      wg::cp_async16(st + sl.xoff + i * kXRows * 128,
                     ok ? sl.xs + i * sl.xstep + k0 : sl.xs, ok);
    }
  }
#pragma unroll
  for (int i = 0; i < kCLoads; ++i) {
    const bool ok = i < sl.crows;
    wg::cp_async16(st + sl.coff + i * kCRows * kWK,
                   ok ? sl.cs + i * sl.cstep + k0 : sl.cs, ok);
  }
}

// float32 x of stage kt into registers: two 16-byte loads a chunk
__device__ __forceinline__ void gq_load_x(const GqSlots<float>& sl, int kt,
                                          float4 (&v)[kXLoads][2]) {
  const int k0 = kt * kWK;
#pragma unroll
  for (int i = 0; i < kXLoads; ++i) {
    if (i < sl.xrows) {
      const float4* p =
          reinterpret_cast<const float4*>(sl.xs + i * sl.xstep + k0);
      v[i][0] = p[0];
      v[i][1] = p[1];
    } else {
      v[i][0] = v[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// the registers' x chunks split into the stage's hi, mid and lo panels
__device__ __forceinline__ void gq_split_x(const GqSlots<float>& sl,
                                           uint8_t* st,
                                           const float4 (&v)[kXLoads][2]) {
#pragma unroll
  for (int i = 0; i < kXLoads; ++i)
    wg::split3_store8(st, sl.xoff + i * kXRows * 128, kPanel, v[i][0],
                      v[i][1]);
}

// the thread's raw code chunks of a stage -> bf16 into its swizzled A tile
template <int Q, typename T>
__device__ __forceinline__ void gq_convert(const GqSlots<T>& sl,
                                           uint8_t* st) {
#pragma unroll
  for (int i = 0; i < kCLoads; ++i) {
    const uint4 raw =
        *reinterpret_cast<const uint4*>(st + sl.coff + i * kCRows * kWK);
    const uint2 o0 = codes4_to_bf16<Q>(raw.x), o1 = codes4_to_bf16<Q>(raw.y);
    const uint2 o2 = codes4_to_bf16<Q>(raw.z), o3 = codes4_to_bf16<Q>(raw.w);
    *reinterpret_cast<uint4*>(st + sl.aoff0 + i * kCRows * 128) =
        make_uint4(o0.x, o0.y, o1.x, o1.y);
    *reinterpret_cast<uint4*>(st + sl.aoff1 + i * kCRows * 128) =
        make_uint4(o2.x, o2.y, o3.x, o3.y);
  }
}

// Every K-block is whole stages (bk % 64 == 0; the codec's default is
// 128): a stage's k16 steps issue back to back, P products each.
template <typename T, int Q>
__global__ void __launch_bounds__(kWThreads, 1)
    quant_grouped_wgmma(const T* __restrict__ x,
                        const uint8_t* __restrict__ codes,
                        const float* __restrict__ scales, T* __restrict__ out,
                        const int* __restrict__ offsets,
                        const int* __restrict__ counts, int Tp, int K, int N,
                        int KB, int bk, int bm) {
  using L = GqLayout<T>;
  constexpr int P = L::kPieces, S = L::kStages;
  static_assert(P == 1 || S == 3, "float32 x is loaded one stage ahead");
  extern __shared__ __align__(1024) uint8_t gq_smem[];
  uint8_t* smem = gq_smem;
  const uint32_t sbase = wg::smem_addr(smem);
  if (sbase & 1023) __trap();  // the swizzle needs it
  const int e = blockIdx.z;
  const int live = live_rows(counts, e, bm);
  const int t0 = blockIdx.y * kWM;
  if (t0 >= live) return;               // past the group's live tiles
  const int row0 = offsets[e] + t0;
  const int row_end = min(offsets[e] + live, Tp);
  if (row0 >= row_end) return;
  const int n0 = blockIdx.x * kWN;
  const int t = threadIdx.x, lane = t & 31;
  const int g = t >> 7, warp = (t >> 5) & 3;  // warpgroup, warp within it
  const int KT = K / kWK;
  const uint8_t* ce = codes + (size_t)e * N * K;
  const float* se = scales + (size_t)e * N * KB;
  // the two output columns (accumulator rows) this thread holds
  const int r0 = n0 + g * 64 + warp * 16 + lane / 4, r1 = r0 + 8;
  const float* srow0 = se + (size_t)min(r0, N - 1) * KB;
  const float* srow1 = se + (size_t)min(r1, N - 1) * KB;
  const GqSlots<T> sl = gq_slots(x, ce, row0, row_end, n0, N, K);
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  float4 xv[kXLoads][2];  // float32 x of the stage after next

  for (int p = 0; p < S - 1; ++p) {
    if (p < KT) gq_copy(sl, sbase + p * L::kStage, p);
    wg::cp_async_commit();
  }
  if constexpr (P == 3) {
    gq_load_x(sl, 0, xv);
    gq_split_x(sl, smem, xv);
    if (KT > 1) gq_load_x(sl, 1, xv);
  }
  wg::cp_async_wait<S - 2>();
  gq_convert<Q>(sl, smem);
  wg::fence_proxy_async();
  __syncthreads();

  const int spb = bk / kWK;  // stages a K-block
  int sib = 0, kb = 0;       // stages into the current K-block, its index
  float s0 = 0.f, s1 = 0.f;
  float ns0 = r0 < N ? srow0[0] : 0.f, ns1 = r1 < N ? srow1[0] : 0.f;
  for (int kt = 0; kt < KT; ++kt) {
    const uint32_t st = sbase + (kt % S) * L::kStage;
    // this warpgroup's 64 codes rows: 8 KB into the stage's A tile
    const uint32_t aa = st + L::kA + g * 64 * 128;
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
#pragma unroll
      for (int p = 0; p < P; ++p)  // hi, mid, lo: exact products
        wg::mma_m64n128k16(part, wg::desc_sw128(aa + 32 * j),
                           wg::desc_sw128(st + p * kPanel + 32 * j),
                           j > 0 || p > 0 || sib > 0);
    wg::commit();
    const bool drain = ++sib == spb;  // the K-block ends with this stage
    if (drain) {
      sib = 0;
      ++kb;
    }
    // while the products run: stage kt + 1's codes (this thread's copies
    // have landed) and float32 x into its tiles, then wait for stage kt -
    // 1's products, or for all of them before the partial is read
    wg::cp_async_wait<S - 3>();
    if (kt + 1 < KT) {
      uint8_t* nx = smem + ((kt + 1) % S) * L::kStage;
      gq_convert<Q>(sl, nx);
      if constexpr (P == 3) gq_split_x(sl, nx, xv);
    }
    wg::fence_proxy_async();
    if (drain) {
      wg::wait<0>();
      wg::fence_operand(part);
#pragma unroll
      for (int i = 0; i < 64; ++i)
        acc[i] = fmaf((i & 2) ? s1 : s0, part[i], acc[i]);
    } else {
      wg::wait<1>();
    }
    // one barrier publishes stage kt + 1 and frees stage kt - 1's
    // buffers, which then take stage kt + S - 1
    __syncthreads();
    const int nt = kt + S - 1;
    if (nt < KT) {
      gq_copy(sl, sbase + (nt % S) * L::kStage, nt);
      if constexpr (P == 3) gq_load_x(sl, nt, xv);
    }
    wg::cp_async_commit();
  }
  wg::wait<0>();
  wg::cp_async_wait<0>();
  __syncthreads();

  // epilogue: the out^T tile through shared memory as out [kWM m][kWN n]
  constexpr int pitch = L::kEpiPitch;
  T* ep = reinterpret_cast<T*>(smem);
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int n = g * 64 + warp * 16 + lane / 4 + 8 * ((i >> 1) & 1);
    const int m = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    ep[m * pitch + n] = ptt::from_float<T>(acc[i]);
  }
  __syncthreads();
  constexpr int V = 16 / (int)sizeof(T);  // values a 16-byte store
  const bool vec_out = N % V == 0;        // every out row 16-byte aligned
  for (int q = t; q < kWM * (kWN / V); q += kWThreads) {
    const int r = q / (kWN / V), c = q % (kWN / V);
    const int gm = row0 + r, gn = n0 + c * V;
    if (gm >= row_end) continue;
    const T* src = ep + r * pitch + c * V;
    T* dst = out + (size_t)gm * N + gn;
    if (vec_out && gn + V <= N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int i = 0; i < V && gn + i < N; ++i) dst[i] = src[i];
    }
  }
}

constexpr int kRouteCudaCore = 0;  // route codes (kernels/quant_matmul.py)
constexpr int kRouteWgmma = 1;

template <typename T, int Q>
int launch_wgmma(const void* x, const void* codes, const void* scales,
                 void* out, const int* offsets, const int* counts, int E,
                 int Tp, int K, int N, int KB, int bk, int bm,
                 cudaStream_t st) {
  auto kernel = quant_grouped_wgmma<T, Q>;
  constexpr int smem = GqLayout<T>::kSmem;
  static bool smem_set[ptt::kMaxDevices] = {};
  if (int e = ptt::raise_smem(kernel, smem, smem_set)) return e;
  const dim3 grid((N + kWN - 1) / kWN, (Tp + kWM - 1) / kWM, E);
  kernel<<<grid, kWThreads, smem, st>>>(
      (const T*)x, (const uint8_t*)codes, (const float*)scales, (T*)out,
      offsets, counts, Tp, K, N, KB, bk, bm);
  return (int)cudaGetLastError();
}

template <typename T, int Q>
int launch(const void* x, const void* codes, const void* scales, void* out,
           const int* offsets, const int* counts, int E, int Tp, int K,
           int N, int KB, int bk, int bm, int route, cudaStream_t st) {
  if (route == kRouteWgmma) {
    // whole stages in a K-block, token tiles inside one group, 16-byte
    // rows and bases
    if (bk % kWK || bm % kWM || (uintptr_t)x % 16 || (uintptr_t)codes % 16)
      return (int)cudaErrorInvalidValue;
    return launch_wgmma<T, Q>(x, codes, scales, out, offsets, counts, E, Tp,
                              K, N, KB, bk, bm, st);
  }
  if (route != kRouteCudaCore) return (int)cudaErrorInvalidValue;
  return launch_cuda_core<T, Q>(x, codes, scales, out, offsets, counts, E,
                                Tp, K, N, KB, bk, bm, st);
}

}  // namespace

// x [Tp, K] (x_dtype 0 = float32, 1 = bfloat16); codes [E, N, K] (q_dtype
// 0 = int8, 1 = float8 e4m3); scales [E, N, KB] float32 with bk = K / KB;
// out [Tp, N] in x's dtype; offsets, counts [E] int32 on the card. All
// contiguous. route: 0 = cuda_core (`quant_grouped_fwd`), 1 = wgmma
// (`quant_grouped_wgmma`: bk % 64 == 0, bm % 128 == 0, 16-byte aligned x
// and codes). Returns the CUDA error code of the launch (0 on success);
// cudaErrorInvalidValue for inputs the chosen route does not take.
extern "C" int quant_grouped_matmul_fwd(const void* x, const void* codes,
                                        const void* scales, void* out,
                                        const void* offsets,
                                        const void* counts, int E, int Tp,
                                        int K, int N, int KB, int bk, int bm,
                                        int x_dtype, int q_dtype,
                                        int route, void* stream) {
  if (E <= 0 || Tp <= 0 || K <= 0 || N <= 0 || KB <= 0 || bk <= 0 ||
      bk * KB != K || bm <= 0 || (Tp + kBM - 1) / kBM > 65535 || E > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* off = (const int*)offsets;
  const int* cnt = (const int*)counts;
  if (x_dtype == ptt::kFloat32 && q_dtype == kQInt8)
    return launch<float, kQInt8>(x, codes, scales, out, off, cnt, E, Tp, K,
                                 N, KB, bk, bm, route, st);
  if (x_dtype == ptt::kFloat32 && q_dtype == kQFp8)
    return launch<float, kQFp8>(x, codes, scales, out, off, cnt, E, Tp, K,
                                N, KB, bk, bm, route, st);
  if (x_dtype == ptt::kBFloat16 && q_dtype == kQInt8)
    return launch<__nv_bfloat16, kQInt8>(x, codes, scales, out, off, cnt, E,
                                         Tp, K, N, KB, bk, bm, route, st);
  if (x_dtype == ptt::kBFloat16 && q_dtype == kQFp8)
    return launch<__nv_bfloat16, kQFp8>(x, codes, scales, out, off, cnt, E,
                                        Tp, K, N, KB, bk, bm, route, st);
  return (int)cudaErrorInvalidValue;
}
