// Ragged paged attention: one decode query per slot against its KV pages.
//
// Replaces: paddle_tpu/kernels/pallas/ragged_paged_attention.py, `_kernel`
// launched by `_ragged_call` (the pallas_call at line 170).
//
// Computes, for every slot s and query head h (kv group g = h / nrep):
//   o[s, h] = softmax_t(q[s, h] . K[t] * scale) . V[t],  t = 0..seq_lens[s]
// where token t of slot s lives at pool[tables[s, t / bs], t % bs, g]. The
// window is inclusive of seq_lens[s] (the token just written). Masked
// scores use -1e30 as the TPU kernel does. Pages past the live one are
// never read, nor are table entries past it (they may be 0 = the trash
// block, or garbage).
//
// What bounds it on the H100: device-memory bytes. Each live token costs
// 2 * hd * itemsize bytes of K/V per kv head and about 4 * nrep * hd flops,
// far below the card's 295 flops/byte balance point.
//
// Design: one thread block per (slot, kv head), 8 warps. The TPU kernel's
// sequential grid axis over pages (scratch m/l/acc carried from step to
// step) becomes a loop inside the block: the window is cut into groups of
// 4 tokens, dealt round-robin to the warps, and each warp keeps its own
// online-softmax state (m, l, acc in float32 registers) for the nrep query
// heads of the group, so GQA reads the unrepeated K/V once. A lane owns hd/32
// columns: K and V rows are read straight from the pool with neighbouring
// lanes on neighbouring addresses, the q.K dot is a warp reduction, and a
// token past the window is never loaded (so a NaN-poisoned page past it
// cannot reach the output). At the end the warps' partial states merge
// through shared memory with the usual max/rescale. It is simple and right
// first: no split of one slot's window across blocks (with 8 slots x 32
// heads the card runs few blocks), no cp.async/TMA prefetch, no tensor
// cores. Those are the next steps.

#include <stdint.h>

#include "common.cuh"

namespace {

using ptt::from_float;
using ptt::kNegInf;
using ptt::to_float;
using ptt::warp_sum;

constexpr int kWarps = 8;
constexpr int kGroup = 4;  // tokens a warp handles per pass

template <typename T, int HD, int NREP>
__global__ void __launch_bounds__(kWarps * 32)
    ragged_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                  const T* __restrict__ vpool, const int* __restrict__ tables,
                  const int* __restrict__ seq_lens, T* __restrict__ out,
                  int nkv, int bs, int mb, float scale) {
  constexpr int KC = HD / 32;  // columns per lane
  __shared__ float sm_m[kWarps][NREP];
  __shared__ float sm_l[kWarps][NREP];
  __shared__ float sm_acc[NREP][HD];

  const int s = blockIdx.x;
  const int g = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nh = nkv * NREP;
  const int last = min(seq_lens[s], mb * bs - 1);  // inclusive window end
  const int* tab = tables + (size_t)s * mb;
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

  const int n_groups = (last + kGroup) / kGroup;  // groups covering 0..last
  for (int grp = warp; grp < n_groups; grp += kWarps) {
    const int p0 = grp * kGroup;
    float kv[kGroup][KC], vv[kGroup][KC];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int p = p0 + u;
      if (p <= last) {
        const int blk = tab[p / bs];
        const size_t off =
            ((size_t)blk * bs + (p % bs)) * tok_stride + (size_t)g * HD;
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
    big_l[r] = ll;
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
  for (int i = threadIdx.x; i < NREP * HD; i += kWarps * 32) {
    const int r = i / HD, d = i % HD;
    out[((size_t)s * nh + (size_t)g * NREP + r) * HD + d] =
        from_float<T>(sm_acc[r][d] / big_l[r]);
  }
}

template <typename T, int HD, int NREP>
void launch(const void* q, const void* kp, const void* vp, const int* tables,
            const int* lens, void* out, int S, int nkv, int bs, int mb,
            float scale, cudaStream_t st) {
  ragged_kernel<T, HD, NREP><<<dim3(S, nkv), kWarps * 32, 0, st>>>(
      (const T*)q, (const T*)kp, (const T*)vp, tables, lens, (T*)out, nkv, bs,
      mb, scale);
}

template <typename T, int HD>
int dispatch_nrep(int nrep, const void* q, const void* kp, const void* vp,
                  const int* tables, const int* lens, void* out, int S,
                  int nkv, int bs, int mb, float scale, cudaStream_t st) {
  switch (nrep) {
    case 1: launch<T, HD, 1>(q, kp, vp, tables, lens, out, S, nkv, bs, mb, scale, st); return 0;
    case 2: launch<T, HD, 2>(q, kp, vp, tables, lens, out, S, nkv, bs, mb, scale, st); return 0;
    case 4: launch<T, HD, 4>(q, kp, vp, tables, lens, out, S, nkv, bs, mb, scale, st); return 0;
    case 8: launch<T, HD, 8>(q, kp, vp, tables, lens, out, S, nkv, bs, mb, scale, st); return 0;
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_hd(int hd, int nrep, const void* q, const void* kp,
                const void* vp, const int* tables, const int* lens, void* out,
                int S, int nkv, int bs, int mb, float scale, cudaStream_t st) {
  switch (hd) {
    case 64: return dispatch_nrep<T, 64>(nrep, q, kp, vp, tables, lens, out, S, nkv, bs, mb, scale, st);
    case 128: return dispatch_nrep<T, 128>(nrep, q, kp, vp, tables, lens, out, S, nkv, bs, mb, scale, st);
    case 256: return dispatch_nrep<T, 256>(nrep, q, kp, vp, tables, lens, out, S, nkv, bs, mb, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [S, nh, hd]; kpool/vpool [num_blocks, bs, nkv, hd] (one layer);
// tables [S, mb] int32; seq_lens [S] int32; out [S, nh, hd]. All
// contiguous, q/pools/out of one dtype (0 = float32, 1 = bfloat16).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int ragged_paged_attention_fwd(const void* q, const void* kpool,
                                          const void* vpool,
                                          const void* tables,
                                          const void* seq_lens, void* out,
                                          int S, int nh, int nkv, int hd,
                                          int bs, int mb, float scale,
                                          int dtype, void* stream) {
  if (S <= 0 || nkv <= 0 || nh % nkv != 0 || bs <= 0 || mb <= 0)
    return (int)cudaErrorInvalidValue;
  const int nrep = nh / nkv;
  cudaStream_t st = (cudaStream_t)stream;
  const int* tabs = (const int*)tables;
  const int* lens = (const int*)seq_lens;
  int rc;
  if (dtype == ptt::kFloat32)
    rc = dispatch_hd<float>(hd, nrep, q, kpool, vpool, tabs, lens, out, S, nkv, bs, mb, scale, st);
  else if (dtype == ptt::kBFloat16)
    rc = dispatch_hd<__nv_bfloat16>(hd, nrep, q, kpool, vpool, tabs, lens, out, S, nkv, bs, mb, scale, st);
  else
    rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
