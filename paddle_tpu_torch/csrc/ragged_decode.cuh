// The shared body of the port's ragged decode attention: one query per
// slot against its paged KV, over a pool of rows (float32 or bf16) or of
// int8 codes with one float32 scale per token row, finishing with the
// output (csrc/ragged_paged_attention.cu, csrc/ragged_paged_attention_quant.cu)
// or with the float32 partials of each shard of the slot's block table
// (csrc/ragged_paged_attention_partials.cu). The pool and the output are
// policy classes, so one body serves all three.
//
// Replaces: paddle_tpu/kernels/pallas/ragged_paged_attention.py, `_kernel`
// (the pallas_call at line 170), `_pkernel` (line 310) and `_qkernel`
// (line 506).
//
// Computes, for every slot s and query head h (kv group g = h / NREP):
//   o[s, h] = softmax_t(q[s, h] . K[t] * scale) . V[t],  t = 0..seq_lens[s]
// where token t of slot s lives at pool row tables[s, t / bs] * bs + t % bs.
// The window is inclusive of seq_lens[s]. An int8 row is codes times the
// row's scale: the scale goes on the finished q.k dot, and on p before
// p.v, so it costs one multiply a token, not one an element.
// The partials cut each table into shards of spb blocks (shard z: blocks
// z spb .. min(z spb + spb, mb)); shard z's window is its own live tokens,
// and it writes, in float32,
//   o[z, s, h] = sum_t p_t V[t] / max(l, 1e-30),  lse[z, s, h] = m + ln l
// with m the largest score, p_t = exp(x_t - m) and l = sum_t p_t. A shard
// with no live token writes o = 0 and lse = -1e30 + ln 1e-30 (-1e30 in
// float32), so its merge weight is 0. The unsharded kernels are one shard
// of the whole table.
//
// What bounds it on the H100: device-memory bytes. A live token costs
// 2 * hd * itemsize bytes of K/V per kv head; at MHA (the serve's NREP 1)
// that is 1 flop a byte, at NREP 8 8 flops a byte, far below the card's
// balance point. So the arithmetic stays on the CUDA cores in float32:
// tensor cores would not move a byte-bound kernel, and float32 keeps the
// float32 serves token for token equal to the dense-gather oracle.
//
// Design (the first design, one block per (slot, kv head) walking the
// whole window 2 bytes a lane at a time, was set by the latency of that
// walk, not by bytes):
// - Split each shard's window over a thread-block cluster, all shards in
//   one launch. The grid is (S, nkv, shards * C), in clusters of (1, 1, C):
//   a block's shard is blockIdx.z / C, its rank the cluster rank. The plan
//   is made in the kernel from the device's seq_lens (a decode chunk runs
//   several steps without a host sync): the shard's n live tokens, in
//   units of a stage's TS tokens, are cut into C runs of equal units;
//   cluster rank c takes run c. Shards start on block boundaries, so a
//   shard-local position p lives in the shard's table entry p / bs. A rank
//   (or a whole shard) with no token still takes part in the merge, with
//   m = -1e30, l = 0 and acc = 0. The host picks C (at most 8, the
//   portable limit) as the largest size whose S * nkv * shards clusters
//   all fit on the card at once (`launch`, below).
// - Stream rows through a cp.async ring in shared memory. Each of the 4
//   warps of a block owns every 4th stage of the block's run and a private
//   ring of 3 stages: it keeps the next 2 stages' 16-byte cp.async.cg
//   copies in flight while it computes one, so no block-wide barrier sits
//   in the loop. A stage is TS consecutive tokens, sized in bytes (about
//   2 KB of K and 2 KB of V; int8 adds the stage's row scales), so hd 256
//   in float32 fits. Rows are copied whole: a row of one kv head is
//   hd * itemsize contiguous bytes at a stride of nkv * hd * itemsize.
//   Rows past the run's end are zero-filled without a read, so no position
//   past seq_lens[s] is copied and no table entry past the live page is
//   read (a NaN stored there cannot reach the output; ROADMAP queue 3).
// - A group of G lanes (8, 16 or 32, so that a lane's q columns stay in at
//   most 32 registers, and a vector is at least 8 bytes) owns one key at a
//   time: each lane takes hd / G
//   columns of K as 16-byte (or 8-byte) vectors from shared memory, the
//   chunks of neighbouring lanes side by side, so that each access phase
//   reads one contiguous 128 bytes (no bank conflict, no swizzle). The dot
//   takes log2(G) shuffles a key and head, not 5, and the group keeps its
//   own online-softmax state (m, l, acc over the lane's own columns) for
//   the NREP heads, so p never leaves the group: p.v reads the same
//   columns of V. A group takes U keys a stage (1-4) and rescales once for
//   them. A key past the run's end gets p = 0 by a select (its zero-filled
//   rows give 0 * 0). Scores live in the log2 domain (q is pre-scaled by
//   scale * log2(e)), so each exponential is one exp2.
// - Merge in a fixed order, without atomics or global scratch: the groups
//   of a warp by xor shuffles, the warps of a block through shared memory,
//   then the cluster through distributed shared memory: each rank takes a
//   slice of the NREP * hd outputs and reads the C partials in rank order,
//   rescales each by exp(m_c - M), sums, and divides by
//   L = sum_c l_c exp(m_c - M). A second cluster.sync keeps every block
//   alive while another reads it. The same inputs give the same bits every
//   time. The output policy finishes: `FinalOut<T>` casts to T,
//   `ShardPartials` writes float32 o and lse = M ln 2 + ln L (M is in the
//   log2 domain), or the empty shard's values when L = 0.
//
// PTT_RAGGED_CLUSTER (0: the rule above; else that cluster size) and
// PTT_RAGGED_COST (1: no arithmetic on the staged rows; 2: no copies into
// the ring, the arithmetic on whatever the ring holds) make copies of the
// kernel for chip_smoke.py --ragged-cost; the shipped build sets neither.
#pragma once

#include <stdint.h>
#include <cooperative_groups.h>

#include "common.cuh"
#include "wgmma.cuh"

#ifndef PTT_RAGGED_CLUSTER
#define PTT_RAGGED_CLUSTER 0
#endif
#ifndef PTT_RAGGED_COST
#define PTT_RAGGED_COST 0
#endif

namespace ptt {
namespace ragged {
// Internal linkage: the launch's static caches (the shared-memory attribute
// set, the clusters that fit) and the kernels must stay per library when a
// copy of a source is loaded beside it (chip_smoke.py's cost builds).
namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;       // ring slots a warp: 2 stages in flight
constexpr int kStageBytes = 2048;  // about this much K (and V) a stage
constexpr int kMaxCluster = 8;   // the portable cluster size

// the pool policies: rows of T (float or bf16), or int8 codes with one
// float32 scale per token row
template <typename T>
struct RowsKV {
  static constexpr int kItem = sizeof(T);
  static constexpr bool kScaled = false;
};
struct Int8KV {
  static constexpr int kItem = 1;
  static constexpr bool kScaled = true;
};

// the output policies: the finished output in q's type T, or one shard's
// float32 partials (o normalised within the shard, and lse)
template <typename T>
struct FinalOut {
  using type = T;
  static constexpr bool kPartials = false;
};
struct ShardPartials {
  using type = float;
  static constexpr bool kPartials = true;
};

constexpr float kTinyL = 1e-30f;  // the TPU kernel's floor under l
constexpr float kLn2 = 0.6931471805599453f;

constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int cmin(int a, int b) { return a < b ? a : b; }

// The layout of one instance (kernels/ragged_paged_attention.py
// `decode_stage_tokens` mirrors TS).
template <class KV, int HD, int NREP>
struct Cfg {
  static constexpr int kItem = KV::kItem;
  static constexpr int G =                    // lanes a key
      cmin(cmin(32, HD * kItem / 8), cmax(8, NREP * HD / 32));
  static constexpr int NGW = 32 / G;          // keys a warp takes at once
  static constexpr int CPL = HD / G;          // columns a lane
  static constexpr int VB = cmin(16, CPL * kItem);  // bytes a vector load
  static constexpr int VE = VB / kItem;       // columns a vector
  static constexpr int NV = CPL / VE;         // vectors a lane a row
  static constexpr int RB = HD * kItem;       // bytes a row
  static constexpr int U = cmax(1, cmin(4, kStageBytes / (NGW * RB)));
  static constexpr int TS = NGW * U;          // tokens a stage
  static constexpr int KB = TS * RB;          // bytes of K (or V) a stage
  static constexpr int SB = 2 * KB + (KV::kScaled ? 8 * TS : 0);
  static constexpr int CPR = RB / 16;         // 16-byte chunks a row
  static constexpr int RING = kWarps * kStages * SB;
  // warp partials [kWarps][NREP][HD], their m and l, the block partial
  // [NREP][HD], its m and l (float32), laid over the idle ring
  static constexpr int MERGE =
      4 * (kWarps * NREP * HD + 2 * kWarps * NREP + NREP * HD + 2 * NREP);
  static constexpr int SMEM = cmax(RING, MERGE);
  static_assert(CPL % VE == 0 && VB >= 8, "a lane's columns are vectors");
  static_assert((TS * CPR) % 32 == 0 && TS <= 32, "a stage's copies");
  static_assert(SB % 16 == 0, "stages stay 16-byte aligned");
};

// VE columns of a staged row, widened to float32
template <class KV, int VE>
__device__ __forceinline__ void load_vec(const uint8_t* p, float (&o)[VE]) {
  if constexpr (KV::kScaled) {
    uint32_t w[VE / 4];
    if constexpr (VE == 16) {
      const uint4 x = *reinterpret_cast<const uint4*>(p);
      w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
    } else {
      const uint2 x = *reinterpret_cast<const uint2*>(p);
      w[0] = x.x, w[1] = x.y;
    }
#pragma unroll
    for (int i = 0; i < VE; ++i)
      o[i] = (float)((int)(w[i / 4] << (24 - 8 * (i % 4))) >> 24);
  } else if constexpr (KV::kItem == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x, o[1] = x.y, o[2] = x.z, o[3] = x.w;
  } else {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// sum over the G lanes of a group (aligned runs of G lanes)
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int HD, int NREP, class KV, class Out>
__global__ void __launch_bounds__(kThreads)
    ragged_decode(const T* __restrict__ q, const uint8_t* __restrict__ kpool,
                  const uint8_t* __restrict__ vpool,
                  const float* __restrict__ kscale,
                  const float* __restrict__ vscale,
                  const int* __restrict__ tables,
                  const int* __restrict__ seq_lens,
                  typename Out::type* __restrict__ out,
                  float* __restrict__ lse, int nkv, int bs, int mb, int spb,
                  float scale) {
  using C = Cfg<KV, HD, NREP>;
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nsplit = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int s = blockIdx.x, g = blockIdx.y, z = blockIdx.z / nsplit;
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int gam = lane / C::G, j = lane % C::G;
  const int nh = nkv * NREP;
  // shard z: table entries b0 .. b0 + width, positions from b0 * bs
  const int b0 = z * spb, width = min(spb, mb - b0);
  const int* tab = tables + (size_t)s * mb + b0;

  // the plan: the shard's n live tokens in units of a stage, split evenly
  // over the cluster; this block takes units [u0, u1), tokens up to `end`
  const int n = max(min(seq_lens[s] - b0 * bs, width * bs - 1) + 1, 0);
  const int units = n > 0 ? (n + C::TS - 1) / C::TS : 0;
  const int u0 = (int)((long long)rank * units / nsplit);
  const int u1 = (int)((long long)(rank + 1) * units / nsplit);
  const int end = min(u1 * C::TS, n);
  // this warp's stages: w, w + kWarps, ... of the block's run
  const int nst = u1 - u0 > w ? (u1 - u0 - w + kWarps - 1) / kWarps : 0;
  const size_t row_bytes = (size_t)nkv * C::RB;
  const uint8_t* kbase = kpool + (size_t)g * C::RB;
  const uint8_t* vbase = vpool + (size_t)g * C::RB;
  uint8_t* ring = smem + w * kStages * C::SB;
  const uint32_t ring_addr = wg::smem_addr(ring);

  // the lane's q columns, pre-scaled into the log2 domain: element (i, e)
  // is column (j + G i) VE + e
  const float qscale = scale * 1.4426950408889634f;
  float qf[NREP][C::CPL];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    const T* qrow = q + ((size_t)s * nh + (size_t)g * NREP + r) * HD;
#pragma unroll
    for (int i = 0; i < C::NV; ++i)
#pragma unroll
      for (int e = 0; e < C::VE; ++e)
        qf[r][i * C::VE + e] =
            to_float(qrow[(j + C::G * i) * C::VE + e]) * qscale;
  }
  float m[NREP], l[NREP], acc[NREP][C::CPL];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C::CPL; ++c) acc[r][c] = 0.f;
  }

  // copies of this warp's stage i into ring slot `slot`: lane r < TS
  // finds token r's pool row, every lane copies 16-byte chunks of K and V
  auto load = [&](int i, int slot) {
    const int t0 = (u0 + w + i * kWarps) * C::TS;
    int row = -1;  // pool row of token t0 + lane; -1 past the run
    if (lane < C::TS && t0 + lane < end) {
      const int p = t0 + lane;
      row = tab[p / bs] * bs + p % bs;
    }
    const uint32_t dst = ring_addr + slot * C::SB;
#pragma unroll
    for (int k = 0; k < C::TS * C::CPR / 32; ++k) {
      const int idx = lane + 32 * k, r = idx / C::CPR, c = idx % C::CPR;
      const int rw = __shfl_sync(0xffffffffu, row, r);
      const size_t off = (size_t)max(rw, 0) * row_bytes + c * 16;
      if (PTT_RAGGED_COST != 2) {
        wg::cp_async16(dst + r * C::RB + c * 16, kbase + off, rw >= 0);
        wg::cp_async16(dst + C::KB + r * C::RB + c * 16, vbase + off,
                       rw >= 0);
      }
    }
    if constexpr (KV::kScaled) {
      if (PTT_RAGGED_COST != 2 && lane < C::TS) {
        wg::cp_async4(dst + 2 * C::KB + 4 * lane, kscale + max(row, 0),
                      row >= 0);
        wg::cp_async4(dst + 2 * C::KB + 4 * (C::TS + lane),
                      vscale + max(row, 0), row >= 0);
      }
    }
  };

  for (int p = 0; p < kStages - 1; ++p) {
    if (p < nst) load(p, p);
    wg::cp_async_commit();
  }
  for (int i = 0; i < nst; ++i) {
    wg::cp_async_wait<kStages - 2>();
    // publishes stage i to the warp and frees the slot of stage i - 1
    __syncwarp();
    if (i + kStages - 1 < nst) load(i + kStages - 1, (i + kStages - 1) % kStages);
    wg::cp_async_commit();
    if (PTT_RAGGED_COST == 1) continue;
    const uint8_t* st = ring + (i % kStages) * C::SB;
    const int t0 = (u0 + w + i * kWarps) * C::TS;
    const float* ks = reinterpret_cast<const float*>(st + 2 * C::KB);
    const float* vs = ks + C::TS;
    // the group's keys of the stage: rows u NGW + gam, so that the groups
    // of a warp read neighbouring rows together
    float sc[C::U][NREP];
#pragma unroll
    for (int u = 0; u < C::U; ++u) {
      const int kk = u * C::NGW + gam;
      const uint8_t* kr = st + kk * C::RB;
      float part[NREP];
#pragma unroll
      for (int r = 0; r < NREP; ++r) part[r] = 0.f;
#pragma unroll
      for (int v = 0; v < C::NV; ++v) {
        float kv[C::VE];
        load_vec<KV, C::VE>(kr + (j + C::G * v) * C::VB, kv);
#pragma unroll
        for (int r = 0; r < NREP; ++r)
#pragma unroll
          for (int e = 0; e < C::VE; ++e)
            part[r] = fmaf(qf[r][v * C::VE + e], kv[e], part[r]);
      }
      const bool live = t0 + kk < end;
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        float d = group_sum<C::G>(part[r]);
        if constexpr (KV::kScaled) d *= ks[kk];
        sc[u][r] = live ? d : kNegInf;
      }
    }
    // one rescale for the U keys; a key past the run gets p = 0 by the
    // select, whatever the running max
    float pr[C::U][NREP];
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      float mx = sc[0][r];
#pragma unroll
      for (int u = 1; u < C::U; ++u) mx = fmaxf(mx, sc[u][r]);
      const float m_new = fmaxf(m[r], mx);
      const float alpha = exp2f(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < C::U; ++u) {
        const int kk = u * C::NGW + gam;
        const float p = t0 + kk < end ? exp2f(sc[u][r] - m_new) : 0.f;
        psum += p;
        if constexpr (KV::kScaled)
          pr[u][r] = p * vs[kk];  // p times the V row's scale
        else
          pr[u][r] = p;
      }
      l[r] = fmaf(l[r], alpha, psum);
#pragma unroll
      for (int c = 0; c < C::CPL; ++c) acc[r][c] *= alpha;
      m[r] = m_new;
    }
#pragma unroll
    for (int u = 0; u < C::U; ++u) {
      const uint8_t* vr = st + C::KB + (u * C::NGW + gam) * C::RB;
#pragma unroll
      for (int v = 0; v < C::NV; ++v) {
        float vv[C::VE];
        load_vec<KV, C::VE>(vr + (j + C::G * v) * C::VB, vv);
#pragma unroll
        for (int r = 0; r < NREP; ++r)
#pragma unroll
          for (int e = 0; e < C::VE; ++e)
            acc[r][v * C::VE + e] =
                fmaf(pr[u][r], vv[e], acc[r][v * C::VE + e]);
      }
    }
  }
  wg::cp_async_wait<0>();

  // the groups of the warp: lanes j of every group hold the same columns
#pragma unroll
  for (int o = C::G; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float mm = fmaxf(m[r], mo);
      const float fa = exp2f(m[r] - mm), fb = exp2f(mo - mm);
      l[r] = l[r] * fa + lo * fb;
#pragma unroll
      for (int c = 0; c < C::CPL; ++c) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][c], o);
        acc[r][c] = acc[r][c] * fa + ao * fb;
      }
      m[r] = mm;
    }
  }
  // every warp's ring is idle: the merge areas lie over it
  __syncthreads();
  float* wacc = reinterpret_cast<float*>(smem);  // [kWarps][NREP][HD]
  float* wm = wacc + kWarps * NREP * HD;         // [kWarps][NREP]
  float* wl = wm + kWarps * NREP;
  float* bacc = wl + kWarps * NREP;              // [NREP][HD]
  float* bm = bacc + NREP * HD;                  // [NREP]
  float* bl = bm + NREP;
  if (gam == 0) {
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
#pragma unroll
      for (int v = 0; v < C::NV; ++v)
#pragma unroll
        for (int e = 0; e < C::VE; ++e)
          wacc[(w * NREP + r) * HD + (j + C::G * v) * C::VE + e] =
              acc[r][v * C::VE + e];
      if (j == 0) {
        wm[w * NREP + r] = m[r];
        wl[w * NREP + r] = l[r];
      }
    }
  }
  __syncthreads();
  // the block's partial, the warps in order
  for (int e = t; e < NREP * HD; e += kThreads) {
    const int r = e / HD;
    float mm = kNegInf;
#pragma unroll
    for (int x = 0; x < kWarps; ++x) mm = fmaxf(mm, wm[x * NREP + r]);
    float ll = 0.f, v = 0.f;
#pragma unroll
    for (int x = 0; x < kWarps; ++x) {
      const float f = exp2f(wm[x * NREP + r] - mm);
      ll = fmaf(wl[x * NREP + r], f, ll);
      v = fmaf(wacc[x * NREP * HD + e], f, v);
    }
    bacc[e] = v;
    if (e % HD == 0) {
      bm[r] = mm;
      bl[r] = ll;
    }
  }
  cluster.sync();
  // this rank's slice of the outputs, each from the cluster's partials in
  // rank order
  const int E = NREP * HD;
  const int lo = (int)((long long)rank * E / nsplit);
  const int hi = (int)((long long)(rank + 1) * E / nsplit);
  for (int e = lo + t; e < hi; e += kThreads) {
    const int r = e / HD;
    float mm = kNegInf;
    for (int c = 0; c < nsplit; ++c)
      mm = fmaxf(mm, cluster.map_shared_rank(bm, c)[r]);
    float ll = 0.f, v = 0.f;
    for (int c = 0; c < nsplit; ++c) {
      const float f = exp2f(cluster.map_shared_rank(bm, c)[r] - mm);
      ll = fmaf(cluster.map_shared_rank(bl, c)[r], f, ll);
      v = fmaf(cluster.map_shared_rank(bacc, c)[e], f, v);
    }
    const size_t head = ((size_t)z * gridDim.x + s) * nh + (size_t)g * NREP;
    if constexpr (Out::kPartials) {
      out[head * HD + e] = v / fmaxf(ll, kTinyL);
      if (e % HD == 0)  // M is in the log2 domain; L = 0: an empty shard
        lse[head + r] = ll > 0.f ? fmaf(mm, kLn2, logf(fmaxf(ll, kTinyL)))
                                 : kNegInf + logf(kTinyL);
    } else {
      out[head * HD + e] = from_float<T>(v / ll);
    }
  }
  cluster.sync();  // no block leaves while another reads its partial
}

// -- launch -------------------------------------------------------------------

struct Args {
  const void* q;
  const void* kpool;
  const void* vpool;
  const float* kscale;  // int8 pools only
  const float* vscale;
  const int* tables;
  const int* lens;
  void* out;
  float* lse;  // shard partials only
  int S, nkv, bs, mb;
  int spb, shards;  // blocks a shard (mb unsharded), and shards
  float scale;
  cudaStream_t st;
};

// The cluster size of a launch: PTT_RAGGED_CLUSTER if set, else the
// largest (at most kMaxCluster) whose S * nkv * shards clusters all fit on
// the card at once (and whose grid fits the 65535 blocks of its z axis),
// asked once per device and size. Returns the size, or minus a CUDA error.
// With cluster_only the caller only wants the size.
template <typename T, int HD, int NREP, class KV, class Out>
int launch(const Args& a, bool cluster_only) {
  using C = Cfg<KV, HD, NREP>;
  auto kernel = ragged_decode<T, HD, NREP, KV, Out>;
  static bool smem_set[kMaxDevices] = {};
  static int fit[kMaxDevices][kMaxCluster + 1] = {};  // 1 + clusters that fit
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  if (C::SMEM > 48 * 1024)
    if (int r = raise_smem(kernel, C::SMEM, smem_set)) return -r;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = a.st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int size = PTT_RAGGED_CLUSTER;
  if (size <= 0) {
    const long long clusters = (long long)a.S * a.nkv * a.shards;
    for (size = kMaxCluster; size > 1; --size) {
      if ((long long)a.shards * size > 65535) continue;
      cfg.gridDim = dim3(a.S, a.nkv, a.shards * size);
      attr[0].val.clusterDim.z = size;
      int n = dev < kMaxDevices ? fit[dev][size] - 1 : -1;
      if (n < 0) {
        e = cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg);
        if (e != cudaSuccess) return -(int)e;
        if (dev < kMaxDevices) fit[dev][size] = n + 1;
      }
      if (n >= clusters) break;
    }
  }
  if (cluster_only) return size;
  cfg.gridDim = dim3(a.S, a.nkv, a.shards * size);
  attr[0].val.clusterDim.z = size;
  e = cudaLaunchKernelEx(&cfg, kernel, (const T*)a.q,
                         (const uint8_t*)a.kpool, (const uint8_t*)a.vpool,
                         a.kscale, a.vscale, a.tables, a.lens,
                         (typename Out::type*)a.out, a.lse, a.nkv, a.bs,
                         a.mb, a.spb, a.scale);
  return e == cudaSuccess ? size : -(int)e;
}

template <typename T, int HD, class KV, class Out>
int run_nrep(int nrep, const Args& a, bool cluster_only) {
  switch (nrep) {
    case 1: return launch<T, HD, 1, KV, Out>(a, cluster_only);
    case 2: return launch<T, HD, 2, KV, Out>(a, cluster_only);
    case 4: return launch<T, HD, 4, KV, Out>(a, cluster_only);
    case 8: return launch<T, HD, 8, KV, Out>(a, cluster_only);
  }
  return -(int)cudaErrorInvalidValue;
}

// Launches (or, with cluster_only, sizes) the instance for (hd, nrep) with
// q of type T, finishing by the output policy Out (the output in T by
// default). Returns the cluster size, or minus a CUDA error.
template <typename T, class KV, class Out = FinalOut<T>>
int run(int hd, int nrep, const Args& a, bool cluster_only) {
  switch (hd) {
    case 64: return run_nrep<T, 64, KV, Out>(nrep, a, cluster_only);
    case 128: return run_nrep<T, 128, KV, Out>(nrep, a, cluster_only);
    case 256: return run_nrep<T, 256, KV, Out>(nrep, a, cluster_only);
  }
  return -(int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace ragged
}  // namespace ptt
