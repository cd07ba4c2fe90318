// The shared body of the port's masked flash-attention kernels: the
// forward (o and the float32 lse), the dq kernel and the dk/dv kernel of
// a two-pass backward, on [B, S, H, D] operands read in place with
// strides. The mask is a policy class, so one body serves packed
// documents (SegmentMask, csrc/flash_varlen.cu) and FlashMask's per-column
// start rows (StartRowMask, csrc/flash_sparse_mask.cu).
//
// The tile layout is the dense kernels' (csrc/flash_attention_fwd.cu and
// flash_attention_bwd.cu), in float32 on the CUDA cores:
// - forward and dq: one block per (b*h, 64-row q tile), 8 warps of 8 q
//   rows; the q tile (pre-scaled) and, for dq, the dO tile stay in shared
//   memory; K and V stream through shared memory in 32-row tiles, a lane
//   owning one key column for the scores and D/32 output columns for the
//   products, taking p (or ds) by shuffle;
// - dk/dv: one block per (b*h, k tile of 64 rows, 32 at D = 256), 8 warps
//   of 8 (or 4) key rows; q and dO stream in 32-row tiles, a lane owning
//   one q row for the scores.
//
// What the policy decides:
// - which keys a q tile visits (`keys_of_q_tile`), and which 32-key tiles
//   of that range it may skip whole (`dead_key_tile`);
// - which q rows a k tile visits (`rows_of_k_tile`);
// - whether one (row, column) pair is live (`live`, from per-row and
//   per-column attributes the policy loads).
// So a kernel visits the live tiles only, where the TPU kernels walk the
// whole (q tile, kv tile) grid and skip dead pairs with pl.when.
//
// Masked pairs follow the TPU kernels' rules: a masked score is -1e30,
// and it contributes p = 0 through an explicit test, not through exp
// underflow. A row that sees no key keeps m = -1e30 and l = 0, so l is
// clamped to 1e-30, the row's output is 0 and its lse is -1e30 +
// log(1e-30); in the backward its p and ds are 0, so its gradients are 0.
//
// A masked pair contributes nothing, whatever the values: the p.v,
// ds.k, p^T.dO and ds^T.q accumulations skip a zero p or ds (the skip is
// uniform across the warp, since the factor comes by shuffle), and the
// scores and dO.v^T of a masked pair are replaced, not multiplied. A NaN
// in one document's K or V therefore never reaches another document's
// outputs or gradients, although a tile may hold rows of both. Rows
// outside a tile's live range are never loaded: they load as 0.
#pragma once

#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace ptt {
namespace masked {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;               // q rows per warp (forward, dq)
constexpr int kBQ = kWarps * kRows;    // q rows per block (forward, dq)
constexpr int kTile = 32;              // rows of a streamed tile (= lanes)

// key rows per warp of the dk/dv kernel: 4 at D = 256, so that a lane's
// two [R, D/32] float32 accumulators stay in registers
template <int HD>
__host__ __device__ constexpr int dkv_rows() {
  return HD >= 256 ? 4 : 8;
}

// A [B, S, H, D] operand read in place: element (b, s, h, d) lies at
// b * sb + s * ss + h * sh + d (strides in elements, D contiguous).
struct Operand {
  const void* p;
  long long sb, ss, sh;
};

template <typename T>
__device__ __forceinline__ const T* head_base(const Operand& x, int b,
                                              int h) {
  return static_cast<const T*>(x.p) + b * x.sb + h * x.sh;
}

struct Params {
  Operand q, k, v, dout;   // q, dout [B, Sq, H, D]; k, v [B, Sk, H, D]
  void* o;                 // [B, Sq, H, D] contiguous
  void* dq;                // [B, Sq, H, D] contiguous
  void* dk;                // [B, Sk, H, D] contiguous
  void* dv;                // [B, Sk, H, D] contiguous
  float* lse;              // [B * H, Sq]
  const float* delta;      // [B * H, Sq], rowsum(dO * O) in float32
  int B, H, Sq, Sk;
  float scale;
};

// Packed documents (flash_varlen): q row r lies in segment seg_q[r] at
// local position pos_q[r], key c in seg_k[c] at pos_k[c]; the pair is live
// iff the segments are equal (and pos_q >= pos_k when causal). The ids are
// shared by every head. q_ranges[t] is the key range [lo, hi) of q tile t
// and k_ranges[t] the q-row range of k tile t, computed on the device by
// kernels/flash_varlen.py from the segments (rows of other segments are
// outside them, and when causal so are keys past the last row's position).
struct SegmentMask {
  const int* seg_q;
  const int* pos_q;
  const int* seg_k;
  const int* pos_k;
  const int2* q_ranges;
  const int2* k_ranges;
  int causal;

  __device__ int2 row(int, int r) const {
    return make_int2(__ldg(seg_q + r), __ldg(pos_q + r));
  }
  __device__ int2 col(int, int c) const {
    return make_int2(__ldg(seg_k + c), __ldg(pos_k + c));
  }
  __device__ static int2 dead_row() { return make_int2(-1, 0); }
  __device__ static int2 dead_col() { return make_int2(-2, 0); }
  __device__ bool live(int2 r, int2 c) const {
    return r.x == c.x && (!causal || r.y >= c.y);
  }
  __device__ int2 keys_of_q_tile(int, int t, int, int) const {
    return q_ranges[t];
  }
  __device__ bool dead_key_tile(int, int, int) const { return false; }
  __device__ int2 rows_of_k_tile(int, int t, int, int) const {
    return k_ranges[t];
  }
};

// FlashMask's start rows (flash_sparse_mask): row r sees column c iff
// r < start[bh][c] (and r >= c when causal). tile_max[bh][t] is the
// largest start of the 32 columns of tile t (kernels/flash_sparse_mask.py
// computes it on the device, as the TPU kernel's _prep does per kv block):
// a q tile whose first row is at or past it sees none of those columns,
// and a k tile's rows run from its diagonal (causal) to its largest start.
struct StartRowMask {
  const int* start;      // [B * H, S]
  const int* tile_max;   // [B * H, n32]
  int S, n32, causal;

  __device__ int2 row(int, int r) const { return make_int2(r, 0); }
  __device__ int2 col(int bh, int c) const {
    return make_int2(__ldg(start + (size_t)bh * S + c), c);
  }
  __device__ static int2 dead_row() { return make_int2(INT_MAX, 0); }
  __device__ static int2 dead_col() { return make_int2(INT_MIN, 0); }
  __device__ bool live(int2 r, int2 c) const {
    return r.x < c.x && (!causal || r.x >= c.y);
  }
  __device__ int2 keys_of_q_tile(int, int, int, int q1) const {
    return make_int2(0, causal ? min(q1, S) : S);
  }
  __device__ bool dead_key_tile(int bh, int k0, int q0) const {
    return q0 >= __ldg(tile_max + (size_t)bh * n32 + k0 / kTile);
  }
  __device__ int2 rows_of_k_tile(int bh, int, int k0, int k1) const {
    int mx = INT_MIN;
    for (int t = k0 / kTile; t * kTile < k1; ++t)
      mx = max(mx, __ldg(tile_max + (size_t)bh * n32 + t));
    return make_int2(causal ? k0 : 0, min(mx, S));
  }
};

template <int HD>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * HD + (size_t)kTile * (HD + 1) +
                          (size_t)kTile * HD);
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) *
         (2 * (size_t)kBQ * HD + 2 * (size_t)kTile * (HD + 1));
}

template <int HD>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * (size_t)kWarps * dkv_rows<HD>() * HD +
                          2 * (size_t)kTile * (HD + 1));
}

template <typename T, int HD, class Mask>
__global__ void __launch_bounds__(kThreads)
    masked_fwd_kernel(const Params p, const Mask mask) {
  constexpr int KC = HD / 32;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kBQ][HD], pre-scaled
  float* Ks = Qs + kBQ * HD;                    // [kTile][HD + 1]
  float* Vs = Ks + kTile * (HD + 1);            // [kTile][HD]

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - b * p.H;
  const int qt = blockIdx.y;
  const int q0 = qt * kBQ;
  const int q1 = min(q0 + kBQ, p.Sq);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const T* qb = head_base<T>(p.q, b, h);
  const T* kb = head_base<T>(p.k, b, h);
  const T* vb = head_base<T>(p.v, b, h);

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int row = q0 + r;
    Qs[i] = row < q1 ? to_float(qb[row * p.q.ss + d]) * p.scale : 0.f;
  }

  const int row0 = q0 + warp * kRows;  // this warp's first row
  int2 ra[kRows];
  float m[kRows], l[kRows], acc[kRows][KC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = row0 + i;
    ra[i] = row < q1 ? mask.row(bh, row) : Mask::dead_row();
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[i][c] = 0.f;
  }

  int2 keys = mask.keys_of_q_tile(bh, qt, q0, q1);
  keys.x = max(keys.x, 0);
  keys.y = min(keys.y, p.Sk);
  for (int k0 = keys.x; k0 < keys.y; k0 += kTile) {
    if (mask.dead_key_tile(bh, k0, q0)) continue;  // uniform in the block
    __syncthreads();  // the previous tile is consumed (and Q is stored)
    for (int i = tid; i < kTile * HD; i += kThreads) {
      const int c = i / HD, d = i % HD;
      const int col = k0 + c;
      float kk = 0.f, vv = 0.f;
      if (col < keys.y) {
        kk = to_float(kb[col * p.k.ss + d]);
        vv = to_float(vb[col * p.v.ss + d]);
      }
      Ks[c * (HD + 1) + d] = kk;
      Vs[c * HD + d] = vv;
    }
    __syncthreads();

    // scores: lane = key column, kRows rows per warp
    float sc[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) sc[i] = 0.f;
    const float* krow = Ks + lane * (HD + 1);
    const float* qw = Qs + (size_t)warp * kRows * HD;
    for (int d = 0; d < HD; d += 4) {
      const float k_0 = krow[d], k_1 = krow[d + 1], k_2 = krow[d + 2],
                  k_3 = krow[d + 3];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + i * HD + d);
        sc[i] += qv.x * k_0 + qv.y * k_1 + qv.z * k_2 + qv.w * k_3;
      }
    }
    const int col = k0 + lane;
    const int2 ca = col < keys.y ? mask.col(bh, col) : Mask::dead_col();
    float pr[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const bool ok = mask.live(ra[i], ca);
      const float s_ = ok ? sc[i] : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(s_));
      const float alpha = expf(m[i] - m_new);
      pr[i] = ok ? expf(s_ - m_new) : 0.f;
      l[i] = l[i] * alpha + warp_sum(pr[i]);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < KC; ++c) acc[i][c] *= alpha;
    }
    // o += p v: lane owns output columns lane + 32 c; a zero p adds nothing
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float vv[KC];
#pragma unroll
      for (int c = 0; c < KC; ++c) vv[c] = Vs[j * HD + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float pj = __shfl_sync(0xffffffffu, pr[i], j);
        if (pj != 0.f) {
#pragma unroll
          for (int c = 0; c < KC; ++c) acc[i][c] += pj * vv[c];
        }
      }
    }
  }

  T* ob = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = row0 + i;
    if (row >= q1) continue;
    const float lc = fmaxf(l[i], 1e-30f);  // a keyless row emits zeros
    const float inv = 1.f / lc;
    const size_t at = (((size_t)b * p.Sq + row) * p.H + h) * HD + lane;
#pragma unroll
    for (int c = 0; c < KC; ++c) ob[at + 32 * c] = from_float<T>(acc[i][c] * inv);
    if (lane == 0) p.lse[(size_t)bh * p.Sq + row] = m[i] + logf(lc);
  }
}

template <typename T, int HD, class Mask>
__global__ void __launch_bounds__(kThreads)
    masked_dq_kernel(const Params p, const Mask mask) {
  constexpr int KC = HD / 32;
  constexpr int R = kRows;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kBQ][HD], pre-scaled
  float* dOs = Qs + kBQ * HD;                   // [kBQ][HD]
  float* Ks = dOs + kBQ * HD;                   // [kTile][HD + 1]
  float* Vs = Ks + kTile * (HD + 1);            // [kTile][HD + 1]

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - b * p.H;
  const int qt = blockIdx.y;
  const int q0 = qt * kBQ;
  const int q1 = min(q0 + kBQ, p.Sq);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const T* qb = head_base<T>(p.q, b, h);
  const T* kb = head_base<T>(p.k, b, h);
  const T* vb = head_base<T>(p.v, b, h);
  const T* db = head_base<T>(p.dout, b, h);

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int row = q0 + r;
    const bool in = row < q1;
    Qs[i] = in ? to_float(qb[row * p.q.ss + d]) * p.scale : 0.f;
    dOs[i] = in ? to_float(db[row * p.dout.ss + d]) : 0.f;
  }

  const int row0 = q0 + warp * R;  // this warp's first row
  int2 ra[R];
  float lse_r[R], delta_r[R], acc[R][KC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = row0 + i;
    const bool in = row < q1;
    ra[i] = in ? mask.row(bh, row) : Mask::dead_row();
    lse_r[i] = in ? p.lse[(size_t)bh * p.Sq + row] : 0.f;
    delta_r[i] = in ? p.delta[(size_t)bh * p.Sq + row] : 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[i][c] = 0.f;
  }

  int2 keys = mask.keys_of_q_tile(bh, qt, q0, q1);
  keys.x = max(keys.x, 0);
  keys.y = min(keys.y, p.Sk);
  for (int k0 = keys.x; k0 < keys.y; k0 += kTile) {
    if (mask.dead_key_tile(bh, k0, q0)) continue;  // uniform in the block
    __syncthreads();  // the previous tile is consumed (and Q, dO stored)
    for (int i = tid; i < kTile * HD; i += kThreads) {
      const int c = i / HD, d = i % HD;
      const int col = k0 + c;
      float kk = 0.f, vv = 0.f;
      if (col < keys.y) {
        kk = to_float(kb[col * p.k.ss + d]);
        vv = to_float(vb[col * p.v.ss + d]);
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
    const int2 ca = col < keys.y ? mask.col(bh, col) : Mask::dead_col();
    float ds[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const bool ok = mask.live(ra[i], ca);
      ds[i] = ok ? expf(sc[i] - lse_r[i]) * (dp[i] - delta_r[i]) * p.scale
                 : 0.f;
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
        if (dsj != 0.f) {
#pragma unroll
          for (int c = 0; c < KC; ++c) acc[i][c] += dsj * kk[c];
        }
      }
    }
  }

  T* dqb = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = row0 + i;
    if (row >= q1) continue;
    const size_t at = (((size_t)b * p.Sq + row) * p.H + h) * HD + lane;
#pragma unroll
    for (int c = 0; c < KC; ++c) dqb[at + 32 * c] = from_float<T>(acc[i][c]);
  }
}

template <typename T, int HD, class Mask>
__global__ void __launch_bounds__(kThreads)
    masked_dkv_kernel(const Params p, const Mask mask) {
  constexpr int KC = HD / 32;
  constexpr int R = dkv_rows<HD>();
  constexpr int BK = kWarps * R;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [BK][HD]
  float* Vs = Ks + BK * HD;                     // [BK][HD]
  float* Qs = Vs + BK * HD;                     // [kTile][HD + 1], pre-scaled
  float* dOs = Qs + kTile * (HD + 1);           // [kTile][HD + 1]

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - b * p.H;
  const int kt = blockIdx.y;
  const int k0 = kt * BK;
  const int k1 = min(k0 + BK, p.Sk);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const T* qb = head_base<T>(p.q, b, h);
  const T* kb = head_base<T>(p.k, b, h);
  const T* vb = head_base<T>(p.v, b, h);
  const T* db = head_base<T>(p.dout, b, h);

  for (int i = tid; i < BK * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int col = k0 + r;
    const bool in = col < k1;
    Ks[i] = in ? to_float(kb[col * p.k.ss + d]) : 0.f;
    Vs[i] = in ? to_float(vb[col * p.v.ss + d]) : 0.f;
  }

  const int col0 = k0 + warp * R;  // this warp's first key row
  int2 ca[R];
  float acc_k[R][KC], acc_v[R][KC];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int col = col0 + j;
    ca[j] = col < k1 ? mask.col(bh, col) : Mask::dead_col();
#pragma unroll
    for (int c = 0; c < KC; ++c) acc_k[j][c] = acc_v[j][c] = 0.f;
  }

  int2 rows = mask.rows_of_k_tile(bh, kt, k0, k1);
  rows.x = max(rows.x, 0);
  rows.y = min(rows.y, p.Sq);
  for (int qs0 = rows.x; qs0 < rows.y; qs0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and K, V stored)
    for (int i = tid; i < kTile * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const int row = qs0 + r;
      float qq = 0.f, oo = 0.f;
      if (row < rows.y) {
        qq = to_float(qb[row * p.q.ss + d]) * p.scale;
        oo = to_float(db[row * p.dout.ss + d]);
      }
      Qs[r * (HD + 1) + d] = qq;
      dOs[r * (HD + 1) + d] = oo;
    }
    __syncthreads();

    // scores and dO v^T: lane = q row, R key rows per warp
    const int row = qs0 + lane;
    const bool in = row < rows.y;
    const int2 ra = in ? mask.row(bh, row) : Mask::dead_row();
    const float lse_i = in ? p.lse[(size_t)bh * p.Sq + row] : 0.f;
    const float delta_i = in ? p.delta[(size_t)bh * p.Sq + row] : 0.f;
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
    float pr[R], ds[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const bool ok = mask.live(ra, ca[j]);
      pr[j] = ok ? expf(sc[j] - lse_i) : 0.f;
      ds[j] = ok ? pr[j] * (dp[j] - delta_i) * p.scale : 0.f;
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
        const float pj = __shfl_sync(0xffffffffu, pr[j], i);
        const float dsj = __shfl_sync(0xffffffffu, ds[j], i);
        if (pj != 0.f) {
#pragma unroll
          for (int c = 0; c < KC; ++c) acc_v[j][c] += pj * oo[c];
        }
        if (dsj != 0.f) {
#pragma unroll
          for (int c = 0; c < KC; ++c) acc_k[j][c] += dsj * qq[c];
        }
      }
    }
  }

  // dk carries one factor of scale (q was pre-scaled and ds carries one
  // more), so the pre-scaling is divided out, as the TPU kernel does
  T* dkb = static_cast<T*>(p.dk);
  T* dvb = static_cast<T*>(p.dv);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int col = col0 + j;
    if (col >= k1) continue;
    const size_t at = (((size_t)b * p.Sk + col) * p.H + h) * HD + lane;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      dkb[at + 32 * c] = from_float<T>(acc_k[j][c] / p.scale);
      dvb[at + 32 * c] = from_float<T>(acc_v[j][c]);
    }
  }
}

template <typename T, int HD, class Mask>
int launch_fwd(const Params& p, const Mask& m, cudaStream_t st) {
  constexpr size_t bytes = fwd_smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      masked_fwd_kernel<T, HD, Mask>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(p.B * p.H, (p.Sq + kBQ - 1) / kBQ);
  masked_fwd_kernel<T, HD, Mask><<<grid, kThreads, bytes, st>>>(p, m);
  return (int)cudaGetLastError();
}

template <typename T, int HD, class Mask>
int launch_bwd(const Params& p, const Mask& m, cudaStream_t st) {
  constexpr size_t dq_bytes = dq_smem_bytes<HD>();
  constexpr size_t dkv_bytes = dkv_smem_bytes<HD>();
  constexpr int BK = kWarps * dkv_rows<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      masked_dq_kernel<T, HD, Mask>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(masked_dkv_kernel<T, HD, Mask>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)dkv_bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid_q(p.B * p.H, (p.Sq + kBQ - 1) / kBQ);
  masked_dq_kernel<T, HD, Mask><<<grid_q, kThreads, dq_bytes, st>>>(p, m);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 grid_k(p.B * p.H, (p.Sk + BK - 1) / BK);
  masked_dkv_kernel<T, HD, Mask><<<grid_k, kThreads, dkv_bytes, st>>>(p, m);
  return (int)cudaGetLastError();
}

// The number of k tiles of the dk/dv kernel at head dim hd (0 if hd has
// no kernel): the callers size k_ranges with it.
inline int dkv_tiles(int hd, int Sk) {
  const int bk = hd == 256 ? kWarps * dkv_rows<256>()
                 : (hd == 64 || hd == 128) ? kWarps * dkv_rows<128>() : 0;
  return bk ? (Sk + bk - 1) / bk : 0;
}

// Shape checks shared by the entry points; the grid's y dimension holds
// at most 65535 tiles.
inline bool shapes_ok(const Params& p, int hd) {
  return p.B > 0 && p.H > 0 && p.Sq > 0 && p.Sk > 0 &&
         (hd == 64 || hd == 128 || hd == 256) &&
         (p.Sq + kBQ - 1) / kBQ <= 65535 && dkv_tiles(hd, p.Sk) <= 65535 &&
         (long long)p.B * p.H <= INT_MAX;
}

template <class Mask, bool Bwd>
int run_typed(int dtype, int hd, const Params& p, const Mask& m,
              cudaStream_t st) {
#define PTT_MASKED_CASE(T, HD)                              \
  if (hd == HD) {                                           \
    if constexpr (Bwd) return launch_bwd<T, HD, Mask>(p, m, st); \
    else return launch_fwd<T, HD, Mask>(p, m, st);          \
  }
  if (dtype == kFloat32) {
    PTT_MASKED_CASE(float, 64)
    PTT_MASKED_CASE(float, 128)
    PTT_MASKED_CASE(float, 256)
  } else if (dtype == kBFloat16) {
    PTT_MASKED_CASE(__nv_bfloat16, 64)
    PTT_MASKED_CASE(__nv_bfloat16, 128)
    PTT_MASKED_CASE(__nv_bfloat16, 256)
  }
#undef PTT_MASKED_CASE
  return (int)cudaErrorInvalidValue;
}

// The forward: o and lse from q, k, v.
template <class Mask>
int run_fwd(int dtype, int hd, const Params& p, const Mask& m,
            cudaStream_t st) {
  if (!shapes_ok(p, hd)) return (int)cudaErrorInvalidValue;
  return run_typed<Mask, false>(dtype, hd, p, m, st);
}

// The backward: the dq kernel, then the dk/dv kernel, on one stream.
template <class Mask>
int run_bwd(int dtype, int hd, const Params& p, const Mask& m,
            cudaStream_t st) {
  if (!shapes_ok(p, hd)) return (int)cudaErrorInvalidValue;
  return run_typed<Mask, true>(dtype, hd, p, m, st);
}

}  // namespace masked
}  // namespace ptt
