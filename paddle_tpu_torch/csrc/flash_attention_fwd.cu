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
// by bytes. This kernel computes on the CUDA cores in float32, so in
// practice its own arithmetic, far below the tensor-core peak, bounds it.
//
// Design: one thread block per (bh, 64-row q tile), 8 warps; each warp owns
// 8 q rows. The q tile is loaded once into shared memory (pre-scaled,
// float32). K and V stream in 32-row tiles through shared memory; the loop
// stops at the causal diagonal (the TPU kernel's block pruning). For the
// scores a lane owns one key column, so a row's max and sum are warp
// reductions and the softmax state (m, l) of a row lives in registers of
// its warp. For p.v a lane owns D/32 output columns of its warp's 8 rows
// and gets p by shuffle. Everything computes in float32 on the CUDA cores:
// simple and right first. The tensor cores (wgmma), TMA loads with a
// producer warp, and bf16 tiles in shared memory are the next steps.

#include <stdint.h>

#include "common.cuh"

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

}  // namespace

// q, k, v, o [BH, S, hd] contiguous, one dtype (0 = float32,
// 1 = bfloat16); lse [BH, S] float32. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int BH,
                                   int S, int hd, float scale, int causal,
                                   int dtype, void* stream) {
  if (BH <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  if (dtype == ptt::kFloat32)
    rc = dispatch_hd<float>(hd, q, k, v, o, (float*)lse, BH, S, scale, causal, st);
  else if (dtype == ptt::kBFloat16)
    rc = dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, (float*)lse, BH, S, scale, causal, st);
  else
    rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
