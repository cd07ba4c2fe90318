// Block-scaled int8 / fp8 weight matmul: out = x . dequant(codes, scales)^T.
//
// Replaces: paddle_tpu/kernels/pallas/quant_matmul.py, `_qmm_kernel`
// launched by `_qmm_call` (the pallas_call at line 177).
//
// Computes, for x [M, K] (float32 or bfloat16), codes [N, K] (int8 or
// float8 e4m3, the torch Linear layout) and scales [N, KB] float32 with
// block bk = K / KB (any divisor of K):
//   out[m, n] = sum_k x[m, k] * (codes[n, k] * scales[n, k / bk])
// accumulated in float32 and written in x's dtype. Each code is
// dequantized in registers right after its load, as the TPU kernel does in
// VMEM: the full-width weight never exists in device memory.
//
// What bounds it on the H100. At decode (M = slots, 8 at most) the weight
// read is the work: one byte per code against 2 M flops, far below the
// card's balance point, so it is bound by device-memory bytes. At prefill
// (M in the hundreds or thousands) it is bound by operations; on CUDA
// cores in float32 the peak is 67 TFLOP/s, not the tensor cores' 989.
//
// Design, simple and right first; two kernels behind one entry point:
// - M <= 32 (`qmm_rows`): one block of 4 warps per 4 output columns and
//   up to 8 rows of x (grid.y walks further groups of 8 rows). The warps
//   split K; each lane loads 8 codes of each of the 4 columns at a time
//   (one 8-byte load per column, neighbouring lanes on neighbouring
//   bytes), dequantizes them, and applies them to every row of x, so each
//   code tile is read from device memory once and used M times. The
//   partial sums meet through a warp reduction and shared memory.
// - M > 32 (`qmm_tiled`): a plain shared-memory tiled product, 64 x 64
//   output tiles, 32-deep K steps, 4 x 4 outputs per thread; the code tile
//   is dequantized to float32 on its way into shared memory.
// No tensor cores (`wgmma`), no cp.async/TMA pipeline: those are the next
// steps, and the prefill shapes need them most.

#include <stdint.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "common.cuh"

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

// -- large M: the prefill product -----------------------------------------------

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

// -- dispatch -----------------------------------------------------------------

template <typename TX, int Q, int MT>
void launch_rows(const void* x, const void* c, const void* s, void* o, int M,
                 int N, int K, int KB, int bk, int vec, cudaStream_t st) {
  const dim3 grid((N + kCols - 1) / kCols, (M + MT - 1) / MT);
  qmm_rows<TX, Q, MT><<<grid, kRowThreads, 0, st>>>(
      (const TX*)x, (const uint8_t*)c, (const float*)s, (TX*)o, M, N, K, KB,
      bk, vec);
}

template <typename TX, int Q>
void launch(const void* x, const void* c, const void* s, void* o, int M,
            int N, int K, int KB, int bk, cudaStream_t st) {
  // 8-byte code loads and 8-element x loads need K % 8 == 0 and aligned
  // bases (every row then starts aligned too)
  const int vec = (K % kVec == 0) && ((uintptr_t)c % 8 == 0) &&
                  ((uintptr_t)x % 16 == 0);
  if (M == 1) {
    launch_rows<TX, Q, 1>(x, c, s, o, M, N, K, KB, bk, vec, st);
  } else if (M == 2) {
    launch_rows<TX, Q, 2>(x, c, s, o, M, N, K, KB, bk, vec, st);
  } else if (M <= 4) {
    launch_rows<TX, Q, 4>(x, c, s, o, M, N, K, KB, bk, vec, st);
  } else if (M <= 32) {
    launch_rows<TX, Q, 8>(x, c, s, o, M, N, K, KB, bk, vec, st);
  } else {
    const dim3 grid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM);
    qmm_tiled<TX, Q><<<grid, kTileThreads, 0, st>>>(
        (const TX*)x, (const uint8_t*)c, (const float*)s, (TX*)o, M, N, K,
        KB, bk);
  }
}

}  // namespace

// x [M, K]; codes [N, K] (int8 or float8 e4m3); scales [N, KB] float32 with
// bk = K / KB; out [M, N] in x's dtype (0 = float32, 1 = bfloat16). All
// contiguous. q_dtype: 0 = int8, 1 = float8 e4m3. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int quant_matmul_fwd(const void* x, const void* codes,
                                const void* scales, void* out, int M, int N,
                                int K, int KB, int bk, int x_dtype,
                                int q_dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || KB <= 0 || bk <= 0 || bk * KB != K ||
      (M + kTM - 1) / kTM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_dtype == ptt::kFloat32 && q_dtype == kQInt8)
    launch<float, kQInt8>(x, codes, scales, out, M, N, K, KB, bk, st);
  else if (x_dtype == ptt::kFloat32 && q_dtype == kQFp8)
    launch<float, kQFp8>(x, codes, scales, out, M, N, K, KB, bk, st);
  else if (x_dtype == ptt::kBFloat16 && q_dtype == kQInt8)
    launch<__nv_bfloat16, kQInt8>(x, codes, scales, out, M, N, K, KB, bk, st);
  else if (x_dtype == ptt::kBFloat16 && q_dtype == kQFp8)
    launch<__nv_bfloat16, kQFp8>(x, codes, scales, out, M, N, K, KB, bk, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
