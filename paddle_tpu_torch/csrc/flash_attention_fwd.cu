// Flash attention forward: o and the float32 log-sum-exp on [BH, S, D].
//
// Replaces: paddle_tpu/kernels/pallas/flash_attention.py, `_fwd_kernel`
// launched by `_mha_fwd` (pallas_call at line 135) and its K/V-streaming
// twin `_fwd_kernel_stream` / `_mha_fwd_stream` (line 220). On the TPU the
// two exist because a whole [S, D] K/V block stops fitting VMEM past
// S*D = 8192*128; here K/V always stream through shared memory in tiles,
// so one kernel serves both.
//
// Computes o = softmax(q k^T * scale [causal mask]) v per (bh) with the
// online softmax in float32, and lse = m + log(l) per row. Masked scores
// use -1e30 as the TPU kernel does.
//
// What bounds it on the H100: the work is 4*S*S*D flops (about half that
// causal) on 4*S*D bf16 elements read or written, so S/2 flops per byte
// (about S/4 causal) against the card's 295 flops/byte balance point. Full
// attention is bound by operations from S = 590, causal from S = 1180; the
// generate prefill's causal S = 1024 (about 255 flops/byte) is just bound
// by bytes. At the train shape (BH 192, S 2048, D 128, causal, bf16) that
// is 0.21 ms of tensor-core work against 0.12 ms of traffic.
//
// Two kernels; the caller names one (`route`), C refuses a route that
// cannot take the inputs and never picks one itself.
//
// The tensor-core kernel (`flash_fwd_wgmma`; bf16, D 64 or 128, 16-byte
// aligned q, k and v), the dq kernel of flash_attention_bwd.cu with one
// product fewer and the online softmax: one warpgroup a block owns 64 q
// rows (the longest causal rows launch first); Q sits in shared memory
// once and K, V tiles of 64 keys stream through a 2-stage cp.async ring up
// to the causal diagonal, all as D-panels (flash_wgmma.cuh). 80 KB of
// shared memory at D 128, so two blocks fit an SM. Per key tile:
// - S = Q K^T by SS m64n64k16 into 32 float32 registers a thread;
// - the online softmax in the accumulator layout, in the exp2 domain
//   (x = S * scale * log2e): a thread holds two rows, so a row's tile max
//   is its 16 values then two shuffles over the quad of lanes that shares
//   it; alpha = exp2(m - m_new) rescales O and the thread's partial sum l,
//   which is summed over the quad once, at the end. m starts at -1e30, so
//   a row that sees no key in a tile keeps alpha 1 and p 0, never NaN.
//   The causal mask and the tail (columns >= S) set p = 0 by an explicit
//   test and stay out of the max, on the diagonal and tail tiles only (a
//   zero-filled K row scores 0, so zero-filling never masks);
// - O += P V by the RS form with V's tile read MN-major as B[N = D,
//   K = keys], P entering as two bf16 fragments, hi = bf16(p) and
//   lo = bf16(p - hi), into the float32 accumulator. P rounded once to
//   bf16 (FlashAttention's choice) misses the forward's tolerance, one
//   bf16 ulp of o plus 1e-4, by 4-17x in the CPU emulation of
//   tests/test_torch_flash_attention.py (worst on causal rows, where a
//   few large p carry the output), while hi + lo stays within it, at the
//   float32 arithmetic's level.
//   That is 3 S x S x D product-units where the function has 2: the
//   design's own floor at the train shape is 0.31 ms.
// The epilogue divides O by l, stores bf16 rows < S, and writes
// lse = (m + log2 l) ln 2 from one lane of each quad, rows < S only: a
// row past S of this head is the next head's.
// Left for later: issuing the next tile's S = Q K^T before this tile's
// softmax (wait<1>, FlashAttention-3's overlap within a warpgroup), two
// consumer warpgroups sharing each K/V tile, 128-key tiles, TMA with a
// producer warp, a persistent grid, and D 256 on the tensor cores (O
// would take 128 accumulator registers a thread).
//
// The CUDA-core kernel (`flash_fwd_kernel`) keeps float32 inputs, which
// the float32 parity runs compare bit-closely with plain attention and
// which TF32 would round, and D 256. One thread block per (bh, 64-row q
// tile), 8 warps; each warp owns 8 q rows. The q tile is loaded once into
// shared memory (pre-scaled, float32). K and V stream in 32-row tiles
// through shared memory; the loop stops at the causal diagonal (the TPU
// kernel's block pruning). For the scores a lane owns one key column, so
// a row's max and sum are warp reductions and the softmax state (m, l) of
// a row lives in registers of its warp. For p.v a lane owns D/32 output
// columns of its warp's 8 rows and gets p by shuffle. Everything computes
// in float32 on the CUDA cores, far below the tensor-core peak.

#include <stdint.h>

#include "common.cuh"
#include "flash_wgmma.cuh"
#include "wgmma.cuh"

namespace {

using ptt::from_float;
using ptt::kNegInf;
using ptt::to_float;
using ptt::warp_max;
using ptt::warp_sum;

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kBQ = kWarps * kRowsPerWarp;  // 64 q rows per block
constexpr int kBK = 32;                     // key rows per tile (= lanes)

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * HD + (size_t)kBK * (HD + 1) +
                          (size_t)kBK * HD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int S, float scale, int causal) {
  constexpr int KC = HD / 32;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kBQ][HD]
  float* Ks = Qs + kBQ * HD;                    // [kBK][HD + 1]
  float* Vs = Ks + kBK * (HD + 1);              // [kBK][HD]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t base = (size_t)bh * S * HD;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;

  for (int i = tid; i < kBQ * HD; i += kWarps * 32) {
    const int r = i / HD, d = i % HD;
    const int row = q0 + r;
    Qs[i] = row < S ? to_float(qb[(size_t)row * HD + d]) * scale : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][KC];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[i][c] = 0.f;
  }

  const int row0 = q0 + warp * kRowsPerWarp;  // this warp's first row
  int n_tiles = (S + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kBQ, S) + kBK - 1) / kBK);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile is consumed (and Q is stored)
    for (int i = tid; i < kBK * HD; i += kWarps * 32) {
      const int c = i / HD, d = i % HD;
      const int col = k0 + c;
      float kk = 0.f, vv = 0.f;
      if (col < S) {
        kk = to_float(kb[(size_t)col * HD + d]);
        vv = to_float(vb[(size_t)col * HD + d]);
      }
      Ks[c * (HD + 1) + d] = kk;
      Vs[c * HD + d] = vv;
    }
    __syncthreads();

    // scores: lane = key column, 8 rows per warp
    float sc[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) sc[i] = 0.f;
    const float* krow = Ks + lane * (HD + 1);
    const float* qw = Qs + (size_t)warp * kRowsPerWarp * HD;
    for (int d = 0; d < HD; d += 4) {
      const float k_0 = krow[d], k_1 = krow[d + 1], k_2 = krow[d + 2],
                  k_3 = krow[d + 3];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + i * HD + d);
        sc[i] += qv.x * k_0 + qv.y * k_1 + qv.z * k_2 + qv.w * k_3;
      }
    }
    const int col = k0 + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int row = row0 + i;
      const bool ok = col < S && (!causal || col <= row);
      const float s_ = ok ? sc[i] : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(s_));
      const float alpha = expf(m[i] - m_new);
      p[i] = expf(s_ - m_new);
      l[i] = l[i] * alpha + warp_sum(p[i]);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < KC; ++c) acc[i][c] *= alpha;
    }
    // o += p v: lane owns output columns lane + 32 c
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vv[KC];
#pragma unroll
      for (int c = 0; c < KC; ++c) vv[c] = Vs[j * HD + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p[i], j);
#pragma unroll
        for (int c = 0; c < KC; ++c) acc[i][c] += pj * vv[c];
      }
    }
  }

  T* ob = o + base;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = row0 + i;
    if (row >= S) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < KC; ++c)
      ob[(size_t)row * HD + lane + 32 * c] = from_float<T>(acc[i][c] * inv);
    if (lane == 0) lse[(size_t)bh * S + row] = m[i] + logf(l[i]);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int BH, int S, float scale, int causal, cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(BH, (S + kBQ - 1) / kBQ);
  flash_fwd_kernel<T, HD><<<grid, kWarps * 32, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, S, scale, causal);
  return 0;
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                float* lse, int BH, int S, float scale, int causal,
                cudaStream_t st) {
  switch (hd) {
    case 64: return launch<T, 64>(q, k, v, o, lse, BH, S, scale, causal, st);
    case 128: return launch<T, 128>(q, k, v, o, lse, BH, S, scale, causal, st);
    case 256: return launch<T, 256>(q, k, v, o, lse, BH, S, scale, causal, st);
  }
  return (int)cudaErrorInvalidValue;
}

// -- bf16, D 64 and 128: the tensor-core kernel ------------------------------

namespace wg = ptt::wg;

using namespace ptt::flash;  // the 64-row tile helpers

constexpr float kLn2 = 0.6931471805599453f;

template <int HD>
constexpr size_t fwd_wgmma_smem() {
  // Q, and two stages of K, V
  return 5 * (size_t)kTileBytes<HD>;
}

// the largest of a row's values over the four lanes of its quad
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// one block per (bh, 64-row q tile), one warpgroup. Q stays in shared
// memory; K and V tiles of 64 keys stream through a 2-stage cp.async ring.
// Per key tile: S = Q K^T (SS), the online softmax in registers, O += P V
// (RS, V read MN-major) with P as hi + lo.
template <int HD>
__global__ void __launch_bounds__(128)
    flash_fwd_wgmma(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int S, float scale, int causal) {
  constexpr uint32_t kT = kTileBytes<HD>;
  extern __shared__ __align__(1024) uint8_t fwd_smem[];
  const uint32_t sQ = wg::smem_addr(fwd_smem);
  if (sQ & 1023) __trap();  // the swizzle needs it
  const uint32_t sKV = sQ + kT;  // stage s: K, V at +2kT s
  const int t = threadIdx.x, lane = t & 31;
  // causal: the longest rows first
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int bh = blockIdx.x, q0 = qt * kRows;
  const size_t base = (size_t)bh * S * HD;
  const int r_lo = q0 + (t >> 5) * 16 + lane / 4, r_hi = r_lo + 8;
  const float sl2 = scale * kLog2e;

  const int n_kt = causal ? qt + 1 : (S + kRows - 1) / kRows;
  wg::load_panels<HD>(sQ, q + base, q0, S);
  for (int p = 0; p < 2; ++p) {
    if (p < n_kt) {
      wg::load_panels<HD>(sKV + 2 * kT * p, k + base, p * kRows, S);
      wg::load_panels<HD>(sKV + 2 * kT * p + kT, v + base, p * kRows, S);
    }
    wg::cp_async_commit();
  }

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  // the running max (exp2 domain) and this thread's partial sum of rows
  // r_lo and r_hi
  float m_lo = ptt::kNegInf, m_hi = ptt::kNegInf, l_lo = 0.f, l_hi = 0.f;

  for (int it = 0; it < n_kt; ++it) {
    wg::cp_async_wait<1>();  // this tile's copies (the next may fly)
    wg::fence_proxy_async();
    __syncthreads();
    const uint32_t sK = sKV + 2 * kT * (it & 1), sV = sK + kT;
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wg::fence();
    ss_over_d<HD>(sc, sQ, sK);
    wg::commit();
    wg::wait<0>();
    wg::fence_operand(sc);

    const int k0 = it * kRows;
    const bool edge = (causal && it == qt) || k0 + kRows > S;
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool hi_row = (i & 2) != 0;
      const int row = hi_row ? r_hi : r_lo;
      const int col = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      sc[i] *= sl2;
      if (edge && !(col < S && (!causal || col <= row))) continue;
      if (hi_row)
        mx_hi = fmaxf(mx_hi, sc[i]);
      else
        mx_lo = fmaxf(mx_lo, sc[i]);
    }
    mx_lo = quad_max(mx_lo);
    mx_hi = quad_max(mx_hi);
    const float a_lo = exp2f(m_lo - mx_lo), a_hi = exp2f(m_hi - mx_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;
    float s_lo = 0.f, s_hi = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool hi_row = (i & 2) != 0;
      const int row = hi_row ? r_hi : r_lo;
      const int col = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      float p = exp2f(sc[i] - (hi_row ? m_hi : m_lo));
      if (edge && !(col < S && (!causal || col <= row))) p = 0.f;
      sc[i] = p;
      if (hi_row)
        s_hi += p;
      else
        s_lo += p;
    }
    l_lo = l_lo * a_lo + s_lo;
    l_hi = l_hi * a_hi + s_hi;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= (i & 2) ? a_hi : a_lo;
    uint32_t ph[4][4], pl[4][4];
    split_all(sc, ph, pl);
    wg::fence_operand(acc);
    wg::fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) rs_hilo<HD>(acc, ph[j], pl[j], sV, j);
    wg::commit();
    wg::wait<0>();
    wg::fence_operand(acc);
    __syncthreads();  // every warp is done with this stage
    if (it + 2 < n_kt) {
      wg::load_panels<HD>(sK, k + base, (it + 2) * kRows, S);
      wg::load_panels<HD>(sV, v + base, (it + 2) * kRows, S);
    }
    wg::cp_async_commit();
  }
  wg::cp_async_wait<0>();
  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] *= (i & 2) ? inv_hi : inv_lo;
  store_rows<HD>(o + base, acc, q0, S);
  if ((lane & 3) == 0) {
    float* lb = lse + (size_t)bh * S;
    if (r_lo < S) lb[r_lo] = (m_lo + log2f(l_lo)) * kLn2;
    if (r_hi < S) lb[r_hi] = (m_hi + log2f(l_hi)) * kLn2;
  }
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int BH, int S, float scale, int causal,
                 cudaStream_t st) {
  constexpr size_t bytes = fwd_wgmma_smem<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  using bf = __nv_bfloat16;
  const dim3 grid(BH, (S + kRows - 1) / kRows);
  flash_fwd_wgmma<HD><<<grid, 128, bytes, st>>>(
      (const bf*)q, (const bf*)k, (const bf*)v, (bf*)o, lse, S, scale,
      causal);
  return 0;
}

}  // namespace

// route codes (kernels/flash_attention.py keeps the same table, shared
// with the backward's)
constexpr int kRouteCudaCore = 0;
constexpr int kRouteWgmma = 1;

// q, k, v, o [BH, S, hd] contiguous, one dtype (0 = float32,
// 1 = bfloat16); lse [BH, S] float32. route: 0 = the CUDA-core kernel (any
// dtype, hd 64, 128 or 256), 1 = the tensor-core kernel (bf16, hd 64 or
// 128, 16-byte aligned q, k and v). Returns the CUDA error code of the
// launch (0 on success); cudaErrorInvalidValue for inputs the chosen route
// does not take.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int BH,
                                   int S, int hd, float scale, int causal,
                                   int dtype, int route, void* stream) {
  if (BH <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* l = (float*)lse;
  int rc;
  if (route == kRouteWgmma) {
    if (dtype != ptt::kBFloat16 || (uintptr_t)q % 16 || (uintptr_t)k % 16 ||
        (uintptr_t)v % 16 || (S + kRows - 1) / kRows > 65535)
      return (int)cudaErrorInvalidValue;
    if (hd == 64)
      rc = launch_wgmma<64>(q, k, v, o, l, BH, S, scale, causal, st);
    else if (hd == 128)
      rc = launch_wgmma<128>(q, k, v, o, l, BH, S, scale, causal, st);
    else
      return (int)cudaErrorInvalidValue;
  } else if (route != kRouteCudaCore) {
    return (int)cudaErrorInvalidValue;
  } else if (dtype == ptt::kFloat32) {
    rc = dispatch_hd<float>(hd, q, k, v, o, l, BH, S, scale, causal, st);
  } else if (dtype == ptt::kBFloat16) {
    rc = dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, l, BH, S, scale, causal,
                                    st);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
