// Split-context ragged paged attention: every shard of each slot's block
// table gives its online-softmax partial (o normalised within the shard,
// and lse), to be merged by the lse rescale.
//
// Replaces: paddle_tpu/kernels/pallas/ragged_paged_attention.py, `_pkernel`
// launched by `_ragged_partials_call` (the pallas_call at line 310).
//
// Computes, for shard z (pool blocks lo = z * spb .. hi = min(lo + spb, mb)
// of the table), slot s and query head h (kv group g = h / nrep), over the
// shard's live tokens t = lo * bs .. min(seq_lens[s], hi * bs - 1):
//   l = sum_t exp(x_t - m),  x_t = q[s, h] . K[t] * scale,  m = max_t x_t
//   o[z, s, h] = (sum_t exp(x_t - m) V[t]) / max(l, 1e-30)    (float32)
//   lse[z, s, h] = m + log(max(l, 1e-30))
// A shard with no live token writes o = 0 and lse = -1e30 (+ log 1e-30,
// which float32 absorbs), so its merge weight exp(lse - max lse) is
// exactly 0.
//
// What bounds it on the H100: device-memory bytes, as the ragged kernel
// (csrc/ragged_paged_attention.cu): each live token's K and V row is read
// once, against about 4 * nrep * hd flops.
//
// Design: all shards in ONE launch, the shard as the grid's third axis,
// so one slot's window is spread over `shards` blocks: this is split-KV
// decoding. The TPU ran one launch per shard; on the card that would cost
// a launch per shard and leave the SMs as idle as one block per (slot, kv
// head) does at 8 slots. The body is the ragged kernel's
// (csrc/ragged_paged_attention.cu): 8 warps dealt 4-token groups
// round-robin, each warp's online-softmax state in float32 registers,
// merged through shared memory; no position past seq_lens[s] is read. The
// merge of the shards (a [shards, S, nh] max and weighted sum) is left to
// PyTorch, as the JAX package leaves it to jnp.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using ptt::kNegInf;
using ptt::to_float;
using ptt::warp_sum;

constexpr int kWarps = 8;
constexpr int kGroup = 4;        // tokens a warp handles per pass
constexpr float kTinyL = 1e-30f;  // the TPU kernel's floor under l

template <typename T, int HD, int NREP>
__global__ void __launch_bounds__(kWarps * 32)
    ragged_partials_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                           const T* __restrict__ vpool,
                           const int* __restrict__ tables,
                           const int* __restrict__ seq_lens,
                           float* __restrict__ o, float* __restrict__ lse,
                           int S, int nkv, int bs, int mb, int spb,
                           float scale) {
  constexpr int KC = HD / 32;  // columns per lane (lane + 32 k)
  __shared__ float sm_m[kWarps][NREP];
  __shared__ float sm_l[kWarps][NREP];
  __shared__ float sm_acc[NREP][HD];

  const int s = blockIdx.x;
  const int g = blockIdx.y;
  const int z = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nh = nkv * NREP;
  const int lo = z * spb;
  const int width = min(spb, mb - lo);  // blocks in this shard
  // shard-local position of the last live token (-1: the shard is empty)
  const int last = min(max(seq_lens[s] + 1 - lo * bs, 0), width * bs) - 1;
  const int* tab = tables + (size_t)s * mb + lo;
  const size_t tok_stride = (size_t)nkv * HD;

  float qr[NREP][KC];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    const T* qrow = q + ((size_t)s * nh + (size_t)g * NREP + r) * HD;
#pragma unroll
    for (int k = 0; k < KC; ++k) qr[r][k] = to_float(qrow[lane + 32 * k]) * scale;
  }
  float m[NREP], l[NREP], acc[NREP][KC];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int k = 0; k < KC; ++k) acc[r][k] = 0.f;
  }

  const int n_groups = (last + kGroup) / kGroup;  // 0 for an empty shard
  for (int grp = warp; grp < n_groups; grp += kWarps) {
    const int p0 = grp * kGroup;
    float kv[kGroup][KC], vv[kGroup][KC];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int p = p0 + u;
      if (p <= last) {
        const size_t off =
            ((size_t)tab[p / bs] * bs + (p % bs)) * tok_stride + (size_t)g * HD;
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          kv[u][k] = to_float(kpool[off + lane + 32 * k]);
          vv[u][k] = to_float(vpool[off + lane + 32 * k]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < KC; ++k) kv[u][k] = vv[u][k] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      float sc[kGroup];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        float part = 0.f;
#pragma unroll
        for (int k = 0; k < KC; ++k) part += qr[r][k] * kv[u][k];
        part = warp_sum(part);
        sc[u] = (p0 + u <= last) ? part : kNegInf;
        mx = fmaxf(mx, sc[u]);
      }
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        sc[u] = expf(sc[u] - m_new);
        psum += sc[u];
      }
      l[r] = l[r] * alpha + psum;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        float a = acc[r][k] * alpha;
#pragma unroll
        for (int u = 0; u < kGroup; ++u) a += sc[u] * vv[u][k];
        acc[r][k] = a;
      }
      m[r] = m_new;
    }
  }

  // merge the warps' partial softmax states
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
  }
  for (int i = threadIdx.x; i < NREP * HD; i += kWarps * 32)
    (&sm_acc[0][0])[i] = 0.f;
  __syncthreads();
  float big_m[NREP], big_l[NREP];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    float mm = kNegInf;
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w][r]);
    float ll = 0.f;
    for (int w = 0; w < kWarps; ++w) ll += sm_l[w][r] * expf(sm_m[w][r] - mm);
    big_m[r] = mm;
    big_l[r] = fmaxf(ll, kTinyL);
  }
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        const float f = expf(m[r] - big_m[r]);
#pragma unroll
        for (int k = 0; k < KC; ++k) sm_acc[r][lane + 32 * k] += acc[r][k] * f;
      }
    }
    __syncthreads();
  }
  const size_t head0 = ((size_t)z * S + s) * nh + (size_t)g * NREP;
  for (int i = threadIdx.x; i < NREP * HD; i += kWarps * 32) {
    const int r = i / HD, d = i % HD;
    o[(head0 + r) * HD + d] = sm_acc[r][d] / big_l[r];
  }
  if (threadIdx.x < NREP) {
    const int r = threadIdx.x;
    lse[head0 + r] = big_m[r] + logf(big_l[r]);
  }
}

struct Args {
  const void* q;
  const void* kp;
  const void* vp;
  const int* tables;
  const int* lens;
  float* o;
  float* lse;
  int S, nkv, bs, mb, spb, shards;
  float scale;
  cudaStream_t st;
};

template <typename T, int HD, int NREP>
void launch(const Args& a) {
  ragged_partials_kernel<T, HD, NREP>
      <<<dim3(a.S, a.nkv, a.shards), kWarps * 32, 0, a.st>>>(
          (const T*)a.q, (const T*)a.kp, (const T*)a.vp, a.tables, a.lens,
          a.o, a.lse, a.S, a.nkv, a.bs, a.mb, a.spb, a.scale);
}

template <typename T, int HD>
int dispatch_nrep(int nrep, const Args& a) {
  switch (nrep) {
    case 1: launch<T, HD, 1>(a); return 0;
    case 2: launch<T, HD, 2>(a); return 0;
    case 4: launch<T, HD, 4>(a); return 0;
    case 8: launch<T, HD, 8>(a); return 0;
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_hd(int hd, int nrep, const Args& a) {
  switch (hd) {
    case 64: return dispatch_nrep<T, 64>(nrep, a);
    case 128: return dispatch_nrep<T, 128>(nrep, a);
    case 256: return dispatch_nrep<T, 256>(nrep, a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [S, nh, hd]; kpool/vpool [num_blocks, bs, nkv, hd] (one layer), of one
// dtype (0 = float32, 1 = bfloat16); tables [S, mb] int32; seq_lens [S]
// int32 (global positions); shards = ceil(mb / spb) shards of spb blocks.
// Writes o [shards, S, nh, hd] and lse [shards, S, nh], both float32. All
// contiguous. Returns the CUDA error code of the launch (0 on success).
extern "C" int ragged_paged_attention_partials_fwd(
    const void* q, const void* kpool, const void* vpool, const void* tables,
    const void* seq_lens, void* o, void* lse, int S, int nh, int nkv, int hd,
    int bs, int mb, int spb, int shards, float scale, int dtype,
    void* stream) {
  if (S <= 0 || nkv <= 0 || nh % nkv != 0 || bs <= 0 || mb <= 0 ||
      spb <= 0 || shards <= 0 || (shards - 1) * spb >= mb || shards > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, kpool, vpool, (const int*)tables, (const int*)seq_lens,
               (float*)o, (float*)lse, S, nkv, bs, mb, spb, shards, scale,
               (cudaStream_t)stream};
  const int nrep = nh / nkv;
  int rc;
  if (dtype == ptt::kFloat32)
    rc = dispatch_hd<float>(hd, nrep, a);
  else if (dtype == ptt::kBFloat16)
    rc = dispatch_hd<__nv_bfloat16>(hd, nrep, a);
  else
    rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
