// Ragged paged attention over an int8 KV pool: one decode query per slot
// against its pages of int8 codes and one float32 scale per token row.
//
// Replaces: paddle_tpu/kernels/pallas/ragged_paged_attention.py, `_qkernel`
// launched by `_ragged_quant_call` (the pallas_call at line 506).
//
// Computes, for every slot s and query head h (kv group g = h / nrep):
//   o[s, h] = softmax_t(q[s, h] . K[t] * scale) . V[t],  t = 0..seq_lens[s]
// with K[t] = kcodes[row(t), g] * kscale[row(t)] (V alike) and row(t) =
// tables[s, t / bs] * bs + t % bs, as `kv_quantize_rows` stores a token.
// The window is inclusive of seq_lens[s]; masked scores use -1e30 as the
// TPU kernel does.
//
// What bounds it on the H100: device-memory bytes. A live token costs
// 2 * (hd + 4 / nkv) bytes per kv head (codes plus its share of the row
// scale), about half of the bf16 pool's, against about 4 * nrep * hd flops.
//
// Design: the unquantized ragged kernel (csrc/ragged_paged_attention.cu) over
// codes. One thread block per (slot, kv head), 8 warps dealt 4-token groups
// round-robin, each warp with its own online-softmax state in float32
// registers, merged through shared memory at the end. A lane owns hd / 32
// NEIGHBOURING columns, so its codes of a row are one 2-, 4- or 8-byte
// load. Codes are widened to float32 after the load; the row scale
// multiplies the finished q.k dot (and p before p.v), so the scale costs
// one multiply per token, not one per element. Neither a code, nor a
// scale, nor a table entry past seq_lens[s] is ever read: the TPU kernel
// reads the live block whole and masks the scores, so a NaN scale stored
// past seq_lens inside the live block reaches its output as 0 x NaN
// (ROADMAP queue 3); here it cannot.

#include <stdint.h>

#include "common.cuh"

namespace {

using ptt::from_float;
using ptt::kNegInf;
using ptt::to_float;
using ptt::warp_sum;

constexpr int kWarps = 8;
constexpr int kGroup = 4;  // tokens a warp handles per pass

// KC neighbouring int8 codes, widened to float32 (KC = 2, 4 or 8; the
// address is KC-aligned because hd is a multiple of 64)
template <int KC>
__device__ __forceinline__ void load_codes(const int8_t* p, float* out) {
  if constexpr (KC == 2) {
    const char2 c = *reinterpret_cast<const char2*>(p);
    out[0] = c.x;
    out[1] = c.y;
  } else {
#pragma unroll
    for (int w = 0; w < KC / 4; ++w) {
      const char4 c = reinterpret_cast<const char4*>(p)[w];
      out[4 * w] = c.x;
      out[4 * w + 1] = c.y;
      out[4 * w + 2] = c.z;
      out[4 * w + 3] = c.w;
    }
  }
}

template <typename T, int HD, int NREP>
__global__ void __launch_bounds__(kWarps * 32)
    ragged_quant_kernel(const T* __restrict__ q,
                        const int8_t* __restrict__ kcodes,
                        const float* __restrict__ kscale,
                        const int8_t* __restrict__ vcodes,
                        const float* __restrict__ vscale,
                        const int* __restrict__ tables,
                        const int* __restrict__ seq_lens, T* __restrict__ out,
                        int nkv, int bs, int mb, float scale) {
  constexpr int KC = HD / 32;  // neighbouring columns per lane
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
  const int c0 = lane * KC;

  float qr[NREP][KC];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    const T* qrow = q + ((size_t)s * nh + (size_t)g * NREP + r) * HD;
#pragma unroll
    for (int k = 0; k < KC; ++k) qr[r][k] = to_float(qrow[c0 + k]) * scale;
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
    float kv[kGroup][KC], vv[kGroup][KC], ks[kGroup], vs[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int p = p0 + u;
      if (p <= last) {
        const size_t row = (size_t)tab[p / bs] * bs + (p % bs);
        const size_t off = (row * nkv + g) * HD + c0;
        load_codes<KC>(kcodes + off, kv[u]);
        load_codes<KC>(vcodes + off, vv[u]);
        ks[u] = kscale[row];
        vs[u] = vscale[row];
      } else {
#pragma unroll
        for (int k = 0; k < KC; ++k) kv[u][k] = vv[u][k] = 0.f;
        ks[u] = vs[u] = 0.f;
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
        part = warp_sum(part) * ks[u];
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
        sc[u] *= vs[u];  // p times the V row's scale
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
        for (int k = 0; k < KC; ++k) sm_acc[r][c0 + k] += acc[r][k] * f;
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

struct Args {
  const void* q;
  const int8_t* kc;
  const float* ks;
  const int8_t* vc;
  const float* vs;
  const int* tables;
  const int* lens;
  void* out;
  int S, nkv, bs, mb;
  float scale;
  cudaStream_t st;
};

template <typename T, int HD, int NREP>
void launch(const Args& a) {
  ragged_quant_kernel<T, HD, NREP><<<dim3(a.S, a.nkv), kWarps * 32, 0, a.st>>>(
      (const T*)a.q, a.kc, a.ks, a.vc, a.vs, a.tables, a.lens, (T*)a.out,
      a.nkv, a.bs, a.mb, a.scale);
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

// q [S, nh, hd] (dtype 0 = float32, 1 = bfloat16; out alike); kcodes /
// vcodes [num_blocks, bs, nkv, hd] int8 and kscale / vscale [num_blocks, bs]
// float32 (one layer); tables [S, mb] int32; seq_lens [S] int32. All
// contiguous. Returns the CUDA error code of the launch (0 on success).
extern "C" int ragged_paged_attention_quant_fwd(
    const void* q, const void* kcodes, const void* kscale, const void* vcodes,
    const void* vscale, const void* tables, const void* seq_lens, void* out,
    int S, int nh, int nkv, int hd, int bs, int mb, float scale, int dtype,
    void* stream) {
  if (S <= 0 || nkv <= 0 || nh % nkv != 0 || bs <= 0 || mb <= 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q, (const int8_t*)kcodes, (const float*)kscale,
               (const int8_t*)vcodes, (const float*)vscale,
               (const int*)tables, (const int*)seq_lens, out, S, nkv, bs, mb,
               scale, (cudaStream_t)stream};
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
