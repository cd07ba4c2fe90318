// Flash attention backward: dq, dk, dv on [BH, S, D] from the saved
// float32 log-sum-exp.
//
// Replaces: paddle_tpu/kernels/pallas/flash_attention.py, the two-pass
// backward `_mha_bwd` (line 470): `_dq_kernel` (pallas_call at line 480)
// and `_dkv_kernel` (line 497), and their K/V-streaming twins
// `_dq_kernel_stream` / `_dkv_kernel_stream` of `_mha_bwd_stream` (lines
// 341 and 359). On the TPU the twins exist because a whole [S, D] block
// stops fitting VMEM past S*D = 8192*128; here the other side's rows
// always stream through shared memory in tiles, so one pair of kernels
// serves both.
//
// Computes, per (bh), with p = exp(q k^T * scale - lse) recomputed from the
// saved lse (masked scores are -1e30, as on the TPU, so p = 0 there) and
// delta = rowsum(dO * O) computed by the caller in float32:
//   ds = p * (dO v^T - delta) * scale
//   dq = ds k,   dk = ds^T q,   dv = p^T dO.
// Two kernels and no atomics, as on the TPU: the dq kernel owns a q tile
// and loops over K/V tiles up to the causal diagonal; the dk/dv kernel
// owns a k tile and loops over q tiles from the diagonal on. Every sum is
// float32 and each output is rounded to its input's type once, at the end.
//
// What bounds it on the H100: the five S x S x D products are 10*S*S*D
// flops (about half that causal) on 8*S*D elements read or written, so
// about S*5/8 flops per byte in bf16 (S*5/16 causal) against the card's
// 295 flops/byte balance point: bound by operations from S ~ 500 full and
// S ~ 950 causal. This kernel computes on the CUDA cores in float32 and
// recomputes the scores and dO v^T in both kernels (seven S x S x D
// products in all, against five), so in practice its own arithmetic, far
// below the tensor-core peak, bounds it. The tensor cores (wgmma), TMA
// loads and bf16 tiles in shared memory are the next steps.
//
// Design, dq kernel: one block per (bh, 64-row q tile), 8 warps of 8 rows.
// The q tile (pre-scaled) and the dO tile stay in shared memory in float32;
// K and V stream in 32-row tiles with padded rows. A lane owns one key
// column for the scores and dO v^T, so a row's lse and delta are
// per-warp registers; for dq += ds k a lane owns D/32 output columns and
// takes ds by shuffle.
//
// Design, dk/dv kernel: one block per (bh, k tile), 8 warps of R key rows
// (R = 8, or 4 at D = 256 so that the two [R, D/32] float32 accumulators
// of a lane stay in registers without spilling). The k tile stays in
// shared memory; q and dO stream in 32-row tiles with padded rows. A lane
// owns one q row for the scores (its lse and delta are per-lane
// registers), then D/32 output columns of dk and dv, taking p and ds by
// shuffle. dk carries one factor of `scale` (q was pre-scaled and ds
// carries one more), so the pre-scaling is divided out at the end, as the
// TPU kernel does.
//
// Tails: rows and columns past S load as zero, are masked out of p, and
// are never written, so any S works.

#include <stdint.h>

#include "common.cuh"

namespace {

using ptt::from_float;
using ptt::to_float;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;  // rows of the streamed side per tile (= lanes)

// dq kernel: 8 q rows per warp, 64 per block
constexpr int kDqRows = 8;
constexpr int kDqBQ = kWarps * kDqRows;

template <int HD>
__host__ __device__ constexpr int dkv_rows() {
  return HD >= 256 ? 4 : 8;
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) *
         (2 * (size_t)kDqBQ * HD + 2 * (size_t)kTile * (HD + 1));
}

template <int HD>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * (size_t)kWarps * dkv_rows<HD>() * HD +
                          2 * (size_t)kTile * (HD + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int S, float scale, int causal) {
  constexpr int KC = HD / 32;
  constexpr int R = kDqRows;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kDqBQ][HD], pre-scaled
  float* dOs = Qs + kDqBQ * HD;                 // [kDqBQ][HD]
  float* Ks = dOs + kDqBQ * HD;                 // [kTile][HD + 1]
  float* Vs = Ks + kTile * (HD + 1);            // [kTile][HD + 1]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kDqBQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t base = (size_t)bh * S * HD;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;
  const T* db = dout + base;

  for (int i = tid; i < kDqBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int row = q0 + r;
    const bool in = row < S;
    Qs[i] = in ? to_float(qb[(size_t)row * HD + d]) * scale : 0.f;
    dOs[i] = in ? to_float(db[(size_t)row * HD + d]) : 0.f;
  }

  const int row0 = q0 + warp * R;  // this warp's first row
  float lse_r[R], delta_r[R], acc[R][KC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = row0 + i;
    lse_r[i] = row < S ? lse[(size_t)bh * S + row] : 0.f;
    delta_r[i] = row < S ? delta[(size_t)bh * S + row] : 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (S + kTile - 1) / kTile;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kDqBQ, S) + kTile - 1) / kTile);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile is consumed (and Q, dO stored)
    for (int i = tid; i < kTile * HD; i += kThreads) {
      const int c = i / HD, d = i % HD;
      const int col = k0 + c;
      float kk = 0.f, vv = 0.f;
      if (col < S) {
        kk = to_float(kb[(size_t)col * HD + d]);
        vv = to_float(vb[(size_t)col * HD + d]);
      }
      Ks[c * (HD + 1) + d] = kk;
      Vs[c * (HD + 1) + d] = vv;
    }
    __syncthreads();

    // scores and dO v^T: lane = key column, R rows per warp
    float sc[R], dp[R];
#pragma unroll
    for (int i = 0; i < R; ++i) sc[i] = dp[i] = 0.f;
    const float* krow = Ks + lane * (HD + 1);
    const float* vrow = Vs + lane * (HD + 1);
    const float* qw = Qs + (size_t)warp * R * HD;
    const float* dw = dOs + (size_t)warp * R * HD;
    for (int d = 0; d < HD; d += 4) {
      const float k_0 = krow[d], k_1 = krow[d + 1], k_2 = krow[d + 2],
                  k_3 = krow[d + 3];
      const float v_0 = vrow[d], v_1 = vrow[d + 1], v_2 = vrow[d + 2],
                  v_3 = vrow[d + 3];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + i * HD + d);
        const float4 ov = *reinterpret_cast<const float4*>(dw + i * HD + d);
        sc[i] += qv.x * k_0 + qv.y * k_1 + qv.z * k_2 + qv.w * k_3;
        dp[i] += ov.x * v_0 + ov.y * v_1 + ov.z * v_2 + ov.w * v_3;
      }
    }
    const int col = k0 + lane;
    float ds[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = row0 + i;
      const bool ok = col < S && (!causal || col <= row);
      const float p = ok ? expf(sc[i] - lse_r[i]) : 0.f;
      ds[i] = p * (dp[i] - delta_r[i]) * scale;
    }
    // dq += ds k: lane owns output columns lane + 32 c
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float kk[KC];
#pragma unroll
      for (int c = 0; c < KC; ++c) kk[c] = Ks[j * (HD + 1) + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float dsj = __shfl_sync(0xffffffffu, ds[i], j);
#pragma unroll
        for (int c = 0; c < KC; ++c) acc[i][c] += dsj * kk[c];
      }
    }
  }

  T* dqb = dq + base;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = row0 + i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < KC; ++c)
      dqb[(size_t)row * HD + lane + 32 * c] = from_float<T>(acc[i][c]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int S, float scale, int causal) {
  constexpr int KC = HD / 32;
  constexpr int R = dkv_rows<HD>();
  constexpr int BK = kWarps * R;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [BK][HD]
  float* Vs = Ks + BK * HD;                     // [BK][HD]
  float* Qs = Vs + BK * HD;                     // [kTile][HD + 1], pre-scaled
  float* dOs = Qs + kTile * (HD + 1);           // [kTile][HD + 1]

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t base = (size_t)bh * S * HD;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;
  const T* db = dout + base;

  for (int i = tid; i < BK * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int col = k0 + r;
    const bool in = col < S;
    Ks[i] = in ? to_float(kb[(size_t)col * HD + d]) : 0.f;
    Vs[i] = in ? to_float(vb[(size_t)col * HD + d]) : 0.f;
  }

  const int col0 = k0 + warp * R;  // this warp's first key row
  float acc_k[R][KC], acc_v[R][KC];
#pragma unroll
  for (int j = 0; j < R; ++j) {
#pragma unroll
    for (int c = 0; c < KC; ++c) acc_k[j][c] = acc_v[j][c] = 0.f;
  }

  const int n_tiles = (S + kTile - 1) / kTile;
  // the first q tile that reaches this k tile: rows below k0 see none of it
  const int t_lo = causal ? k0 / kTile : 0;

  for (int t = t_lo; t < n_tiles; ++t) {
    const int qs0 = t * kTile;
    __syncthreads();  // the previous tile is consumed (and K, V stored)
    for (int i = tid; i < kTile * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const int row = qs0 + r;
      float qq = 0.f, oo = 0.f;
      if (row < S) {
        qq = to_float(qb[(size_t)row * HD + d]) * scale;
        oo = to_float(db[(size_t)row * HD + d]);
      }
      Qs[r * (HD + 1) + d] = qq;
      dOs[r * (HD + 1) + d] = oo;
    }
    __syncthreads();

    // scores and dO v^T: lane = q row, R key rows per warp
    const int row = qs0 + lane;
    const float lse_i = row < S ? lse[(size_t)bh * S + row] : 0.f;
    const float delta_i = row < S ? delta[(size_t)bh * S + row] : 0.f;
    float sc[R], dp[R];
#pragma unroll
    for (int j = 0; j < R; ++j) sc[j] = dp[j] = 0.f;
    const float* qrow = Qs + lane * (HD + 1);
    const float* orow = dOs + lane * (HD + 1);
    const float* kw = Ks + (size_t)warp * R * HD;
    const float* vw = Vs + (size_t)warp * R * HD;
    for (int d = 0; d < HD; d += 4) {
      const float q_0 = qrow[d], q_1 = qrow[d + 1], q_2 = qrow[d + 2],
                  q_3 = qrow[d + 3];
      const float o_0 = orow[d], o_1 = orow[d + 1], o_2 = orow[d + 2],
                  o_3 = orow[d + 3];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(kw + j * HD + d);
        const float4 vv = *reinterpret_cast<const float4*>(vw + j * HD + d);
        sc[j] += q_0 * kv.x + q_1 * kv.y + q_2 * kv.z + q_3 * kv.w;
        dp[j] += o_0 * vv.x + o_1 * vv.y + o_2 * vv.z + o_3 * vv.w;
      }
    }
    float p[R], ds[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int col = col0 + j;
      const bool ok = row < S && col < S && (!causal || col <= row);
      p[j] = ok ? expf(sc[j] - lse_i) : 0.f;
      ds[j] = p[j] * (dp[j] - delta_i) * scale;
    }
    // dv += p^T dO, dk += ds^T q: lane owns output columns lane + 32 c
#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
      float qq[KC], oo[KC];
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        qq[c] = Qs[i * (HD + 1) + lane + 32 * c];
        oo[c] = dOs[i * (HD + 1) + lane + 32 * c];
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p[j], i);
        const float dsj = __shfl_sync(0xffffffffu, ds[j], i);
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          acc_v[j][c] += pj * oo[c];
          acc_k[j][c] += dsj * qq[c];
        }
      }
    }
  }

  T* dkb = dk + base;
  T* dvb = dv + base;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int col = col0 + j;
    if (col >= S) continue;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const size_t at = (size_t)col * HD + lane + 32 * c;
      dkb[at] = from_float<T>(acc_k[j][c] / scale);
      dvb[at] = from_float<T>(acc_v[j][c]);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk, void* dv,
           int BH, int S, float scale, int causal, cudaStream_t st) {
  constexpr size_t dq_bytes = dq_smem_bytes<HD>();
  constexpr size_t dkv_bytes = dkv_smem_bytes<HD>();
  constexpr int BK = kWarps * dkv_rows<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dq_bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)dkv_bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid_q(BH, (S + kDqBQ - 1) / kDqBQ);
  flash_bwd_dq_kernel<T, HD><<<grid_q, kThreads, dq_bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, S, scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 grid_k(BH, (S + BK - 1) / BK);
  flash_bwd_dkv_kernel<T, HD><<<grid_k, kThreads, dkv_bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, S, scale, causal);
  return 0;
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dq, void* dk, void* dv, int BH, int S, float scale,
                int causal, cudaStream_t st) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, dout, lse, delta, dq, dk, dv, BH, S,
                           scale, causal, st);
    case 128:
      return launch<T, 128>(q, k, v, dout, lse, delta, dq, dk, dv, BH, S,
                            scale, causal, st);
    case 256:
      return launch<T, 256>(q, k, v, dout, lse, delta, dq, dk, dv, BH, S,
                            scale, causal, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, dout, dq, dk, dv [BH, S, hd] contiguous, one dtype (0 =
// float32, 1 = bfloat16); lse and delta [BH, S] float32. Launches the dq
// kernel, then the dk/dv kernel, on `stream`. Returns the CUDA error code
// of the launches (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, void* dk, void* dv, int BH,
                                   int S, int hd, float scale, int causal,
                                   int dtype, void* stream) {
  if (BH <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* dl = (const float*)delta;
  int rc;
  if (dtype == ptt::kFloat32)
    rc = dispatch_hd<float>(hd, q, k, v, dout, l, dl, dq, dk, dv, BH, S,
                            scale, causal, st);
  else if (dtype == ptt::kBFloat16)
    rc = dispatch_hd<__nv_bfloat16>(hd, q, k, v, dout, l, dl, dq, dk, dv, BH,
                                    S, scale, causal, st);
  else
    rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
