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
// Each direction has a second route on the tensor cores (bf16 at D 64 or
// 128; the caller picks the route, see run_fwd and run_bwd): the forward
// `masked_fwd_wgmma` and the backward pair `masked_dq_wgmma` +
// `masked_dkv_wgmma`, the dense kernels' designs (csrc/flash_attention_fwd.cu
// `flash_fwd_wgmma`, csrc/flash_attention_bwd.cu `flash_bwd_dq_wgmma` and
// `flash_bwd_dkv_wgmma`, the helpers of flash_wgmma.cuh) with the policy
// deciding the key range and the dead tiles over 64-key tiles (forward,
// dq) and the q-row range of each 64-key tile (dk/dv, whose tiles are the
// CUDA-core pair's, so one k_ranges serves both). What they add, told for
// the forward:
// - strided operands: q, k, v rows come with their row stride (a multiple
//   of 8 elements) through `load_panels_strided`, key tiles start at the
//   range's first key (not 64-aligned for packed documents), and o is
//   written with its row stride H * D;
// - the 64 key columns' attributes come with each K/V stage by 4-byte
//   cp.async, each thread keeps its two rows' attributes in registers;
// - a tile is wholly live when every one of its 64 columns is live for the
//   q tile's first and last rows: a column's live rows form one interval
//   under both policies (one document's rows from the key's position on;
//   rows [c, start) or [0, start)), so that test is exact. A wholly live
//   tile skips the pair test; every other tile takes it, as a select: a
//   masked score stays out of the max and its p is 0;
// - NaN isolation. On the tensor cores p = 0 times a NaN in V is NaN, and
//   a tile that is not wholly live may hold V rows of another document. So
//   such a tile's V is scanned in shared memory for non-finite values; if
//   any, those V rows are zeroed before the product and every row with a
//   live pair on one of them ends as NaN. p = 0 times a finite V is an
//   exact 0, so every other row gets exactly what it gets without the NaN.
//   The scan costs one 16-byte shared load a thread per 2 KB of V and one
//   block-wide OR, on partial tiles only (PTT_NAN_GUARD, below, moves it
//   for timing). The guard keeps NaN, not inf: an inf in V on such a tile
//   also turns every row with a live pair on its V row into NaN, not the
//   +-inf of exact arithmetic;
// - a row that sees no key keeps m = -1e30: it writes lse -1e30 +
//   log(1e-30) (as the CUDA-core kernel), not the exp2 domain's
//   (-1e30 + log2 1e-30) ln 2, and l is clamped to 1e-30, so o is 0.
// The backward pair computes p = exp2(s scale log2e - lse log2e) and ds =
// p (dp - delta) scale, both replaced by 0 where a pair is masked (a
// keyless row's p would be inf: the select keeps its gradients 0), and
// carries P and dS into their products as bf16 hi + lo pairs. Its NaN
// guard (`guard_rows`, the forward's scan) covers the B operands of its
// RS products, which hold rows of other documents on a partial tile: K in
// dq (dQ += dS K); Q and dO in dk/dv (dK += dS^T Q, dV += P^T dO), where a
// row non-finite in either is zeroed in both and every key with a live
// pair on it ends NaN in dk and dv. V in dq and the resident K and V in
// dk/dv enter only the SS products, whose masked results the select
// replaces, so they need no guard. The dk/dv kernel at D 128 holds two
// [64, 128] float32 accumulators, so it issues the dV products, waits,
// and only then splits dS into the same fragment registers.
//
// On the CUDA cores a masked pair contributes nothing, whatever the
// values: the p.v, ds.k, p^T.dO and ds^T.q accumulations skip a zero p or
// ds (the skip is uniform across the warp, since the factor comes by
// shuffle), and the scores and dO.v^T of a masked pair are replaced, not
// multiplied. A NaN in one document's K or V therefore never reaches
// another document's outputs or gradients, although a tile may hold rows
// of both. Rows outside a tile's live range are never loaded: they load
// as 0.
#pragma once

#include <limits.h>
#include <stdint.h>

#include "common.cuh"
#include "flash_wgmma.cuh"

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
  template <int W = kTile>
  __device__ bool dead_key_tile(int, int, int) const {
    return false;
  }
  // the tensor-core forward's column attributes of keys [k0, k0 + 64)
  // (zeros at or past kend) into shared a (seg) and b (pos), by the 128
  // threads of a warpgroup
  __device__ void stage_cols(uint32_t sa, uint32_t sb, int, int k0,
                             int kend) const {
    const int t = threadIdx.x % 128, j = t % 64, c = k0 + j;
    const bool ok = c < kend;
    const int* src = t < 64 ? seg_k : pos_k;
    wg::cp_async4((t < 64 ? sa : sb) + 4 * j, ok ? src + c : src, ok);
  }
  __device__ int2 staged_col(const int* a, const int* b, int, int j) const {
    return make_int2(a[j], b[j]);
  }
  // the tensor-core dk/dv kernel's row attributes of q rows [r0, r0 + 64)
  // (zeros at or past rend), the same way
  __device__ void stage_rows(uint32_t sa, uint32_t sb, int, int r0,
                             int rend) const {
    const int t = threadIdx.x % 128, j = t % 64, r = r0 + j;
    const bool ok = r < rend;
    const int* src = t < 64 ? seg_q : pos_q;
    wg::cp_async4((t < 64 ? sa : sb) + 4 * j, ok ? src + r : src, ok);
  }
  __device__ int2 staged_row(const int* a, const int* b, int, int j) const {
    return make_int2(a[j], b[j]);
  }
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
  // a tile of W keys from k0 (a multiple of kTile) is dead iff every one
  // of its kTile-column parts is
  template <int W = kTile>
  __device__ bool dead_key_tile(int bh, int k0, int q0) const {
    const int* tm = tile_max + (size_t)bh * n32;
    for (int t = k0 / kTile; t < n32 && t * kTile < k0 + W; ++t)
      if (q0 < __ldg(tm + t)) return false;
    return true;
  }
  __device__ void stage_cols(uint32_t sa, uint32_t, int bh, int k0,
                             int kend) const {
    const int t = threadIdx.x % 128, c = k0 + t;
    if (t < 64) {
      const int* src = start + (size_t)bh * S;
      wg::cp_async4(sa + 4 * t, c < kend ? src + c : src, c < kend);
    }
  }
  __device__ int2 staged_col(const int* a, const int*, int k0, int j) const {
    return make_int2(a[j], k0 + j);
  }
  // a row's attribute is its index: nothing to stage
  __device__ void stage_rows(uint32_t, uint32_t, int, int, int) const {}
  __device__ int2 staged_row(const int*, const int*, int r0, int j) const {
    return make_int2(r0 + j, 0);
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

// -- the forward on the tensor cores ----------------------------------------

// route codes of both directions (kernels/flash_attention.py keeps the
// table)
constexpr int kRouteCudaCore = 0;
constexpr int kRouteWgmma = 1;

static_assert(kBQ == flash::kRows, "one q tile serves both routes");

// shared memory of masked_fwd_wgmma: Q, two stages of K and V (D-panel
// tiles), two stages of the 64 key columns' attributes a and b, and the
// 64-bit mask of V rows that hold a non-finite value
template <int HD>
constexpr size_t fwd_wgmma_smem_bytes() {
  return 5 * (size_t)flash::kTileBytes<HD> + 2 * 2 * flash::kRows * 4 + 16;
}

// the largest of a row's values over the four lanes of its quad (the
// accumulator layout spreads a row over them), and their sum
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// where the tensor-core kernels scan their guarded tiles for non-finite
// values: 1 (the kernels' rule) on tiles that are not wholly live; 2 on
// every tile and 0 on none exist only to time the scan (chip_smoke.py
// --nan-guard-cost), and 0 lets NaN cross documents
#ifndef PTT_NAN_GUARD
#define PTT_NAN_GUARD 1
#endif

// whether any of the eight bf16 values of a 16-byte chunk is inf or NaN
// (all exponent bits set)
__device__ __forceinline__ bool nonfinite_bf16x8(uint4 x) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  bool bad = false;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    bad |= (w[i] & 0x7F80u) == 0x7F80u ||
           (w[i] & 0x7F800000u) == 0x7F800000u;
  return bad;
}

// The NaN guard of the tensor-core kernels, by the block's one warpgroup:
// scan N [64, HD] bf16 D-panel tiles in shared memory (generic pointers)
// for non-finite values, and zero row r of every one of them where any
// holds one in row r. Returns the 64-bit mask of those rows (x: rows 0-31,
// y: 32-63), the same in every thread. `bad_rows` (two words of shared
// memory) must be zero on entry; the caller zeroes it again once every
// thread has read the mask. Cost: one 16-byte shared load a thread per 2
// KB, then a block-wide OR; the zeroing only when a row is bad.
template <int HD, int N>
__device__ __forceinline__ uint2 guard_rows(uint8_t* const (&tiles)[N],
                                            uint32_t* bad_rows) {
  constexpr int R = flash::kRows;
  bool mine = false;
#pragma unroll
  for (int n = 0; n < N; ++n)
    for (int i = threadIdx.x; i < R * HD / 8; i += 128) {
      const int row = (i % (R * 8)) / 8;  // 8 chunks a row in a panel
      if (nonfinite_bf16x8(*reinterpret_cast<const uint4*>(tiles[n] +
                                                           16 * i))) {
        atomicOr(bad_rows + row / 32, 1u << (row % 32));
        mine = true;
      }
    }
  if (!__syncthreads_or(mine)) return make_uint2(0, 0);
  const uint2 bad = make_uint2(bad_rows[0], bad_rows[1]);
#pragma unroll
  for (int n = 0; n < N; ++n)
    for (int i = threadIdx.x; i < R * HD / 8; i += 128) {
      const int row = (i % (R * 8)) / 8;
      if (((row < 32 ? bad.x : bad.y) >> (row % 32)) & 1)
        *reinterpret_cast<uint4*>(tiles[n] + 16 * i) = make_uint4(0, 0, 0, 0);
    }
  wg::fence_proxy_async();
  __syncthreads();
  return bad;
}

__device__ __forceinline__ bool bad_bit(uint2 bad, int j) {
  return ((j < 32 ? bad.x : bad.y) >> (j % 32)) & 1;
}

// The pair test of a tile that is not wholly live, in the accumulator
// layout of a [64, 64] product: bit i of the result is element i of this
// thread (its row lo for i % 4 < 2, hi otherwise; tile column j = 8 (i /
// 4) + 2 (lane % 4) + i % 2). pair(j) gives bit 0 if the pair of row lo
// and column j is live, bit 1 for row hi; columns at or past nvalid are
// dead. A live pair on a column the guard zeroed (bit j of bad) sets
// nan_lo or nan_hi.
template <class Pair>
__device__ __forceinline__ uint32_t live_bits(Pair pair, int nvalid,
                                              uint2 bad, bool& nan_lo,
                                              bool& nan_hi) {
  const int lane = threadIdx.x & 31;
  uint32_t live = 0;
#pragma unroll
  for (int g = 0; g < 8; ++g) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 8 * g + 2 * (lane & 3) + e;
      const int both = j < nvalid ? pair(j) : 0;
      const bool hit = bad_bit(bad, j);
      if (both & 1) {
        live |= 1u << (4 * g + e);
        nan_lo |= hit;
      }
      if (both & 2) {
        live |= 1u << (4 * g + 2 + e);
        nan_hi |= hit;
      }
    }
  }
  return live;
}

// whether a row's flag is set in any lane of its quad (the accumulator
// layout spreads a row over four lanes)
__device__ __forceinline__ bool quad_any(bool x) {
  int v = x;
  v |= __shfl_xor_sync(0xffffffffu, v, 1);
  v |= __shfl_xor_sync(0xffffffffu, v, 2);
  return v != 0;
}

// one block per (b*h, 64-row q tile), one warpgroup. Q stays in shared
// memory; the live 64-key tiles of the policy's key range stream through a
// 2-stage cp.async ring with their column attributes. Per tile: S = Q K^T
// (SS), the pair test unless the tile is wholly live, the NaN guard of V
// on those tiles, the online softmax in registers in the exp2 domain, and
// O += P V (RS, V read MN-major) with P as hi + lo.
template <int HD, class Mask>
__global__ void __launch_bounds__(128)
    masked_fwd_wgmma(const Params p, const Mask mask) {
  using bf16 = __nv_bfloat16;
  constexpr int R = flash::kRows;
  constexpr uint32_t kT = flash::kTileBytes<HD>;
  constexpr float kLn2 = 0.6931471805599453f;
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  const uint32_t sQ = wg::smem_addr(wg_smem);
  if (sQ & 1023) __trap();  // the swizzle needs it
  const uint32_t sKV = sQ + kT;                // stage s: K, V at +2kT s
  int* attrs = reinterpret_cast<int*>(wg_smem + 5 * kT);  // stage s at 2R s
  uint32_t* bad_rows = reinterpret_cast<uint32_t*>(attrs + 4 * R);

  const int t = threadIdx.x, lane = t & 31;
  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int qt = blockIdx.y, q0 = qt * R, q1 = min(q0 + R, p.Sq);
  const int r_lo = q0 + (t >> 5) * 16 + lane / 4, r_hi = r_lo + 8;
  const bf16* qb = head_base<bf16>(p.q, b, h);
  const bf16* kb = head_base<bf16>(p.k, b, h);
  const bf16* vb = head_base<bf16>(p.v, b, h);
  const float sl2 = p.scale * flash::kLog2e;

  // this thread's two rows, and the tile's first and last (the wholly
  // live test)
  const int2 ra_lo = r_lo < q1 ? mask.row(bh, r_lo) : Mask::dead_row();
  const int2 ra_hi = r_hi < q1 ? mask.row(bh, r_hi) : Mask::dead_row();
  const int2 first = mask.row(bh, q0), last = mask.row(bh, q1 - 1);
  int2 keys = mask.keys_of_q_tile(bh, qt, q0, q1);
  keys.x = max(keys.x, 0);
  keys.y = min(keys.y, p.Sk);
  // the first live tile at or after k (block-uniform)
  auto next_tile = [&](int k) {
    while (k < keys.y && mask.template dead_key_tile<R>(bh, k, q0)) k += R;
    return k;
  };
  auto load_stage = [&](int stage, int k) {
    if (k >= keys.y) return;
    const uint32_t sK = sKV + 2 * kT * stage;
    wg::load_panels_strided<HD>(sK, kb, p.k.ss, k, keys.y);
    wg::load_panels_strided<HD>(sK + kT, vb, p.v.ss, k, keys.y);
    const uint32_t sa = wg::smem_addr(attrs + 2 * R * stage);
    mask.stage_cols(sa, sa + 4 * R, bh, k, keys.y);
  };

  if (t == 0) bad_rows[0] = bad_rows[1] = 0;
  wg::load_panels_strided<HD>(sQ, qb, p.q.ss, q0, q1);
  int cur = next_tile(keys.x);
  load_stage(0, cur);
  wg::cp_async_commit();
  int nxt = cur < keys.y ? next_tile(cur + R) : keys.y;
  load_stage(1, nxt);
  wg::cp_async_commit();
  int iss = nxt < keys.y ? next_tile(nxt + R) : keys.y;

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  // the running max (exp2 domain) and this thread's partial sum of rows
  // r_lo and r_hi; whether a live pair of the row met a non-finite V
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
  bool nan_lo = false, nan_hi = false;

  for (int it = 0; cur < keys.y; ++it) {
    const int stage = it & 1;
    wg::cp_async_wait<1>();  // this tile's copies (the next may fly)
    wg::fence_proxy_async();
    __syncthreads();
    const uint32_t sK = sKV + 2 * kT * stage, sV = sK + kT;
    const int* ca = attrs + 2 * R * stage;
    const int nvalid = min(R, keys.y - cur);
    bool ok = true;
    if (t < R) {
      const int2 c = mask.staged_col(ca, ca + R, cur, t);
      ok = t < nvalid && mask.live(first, c) && mask.live(last, c);
    }
    const bool full = __syncthreads_and(ok);

    // the NaN guard of V (rows 0-31 in bad.x, 32-63 in bad.y) on a tile
    // that is not wholly live
    uint2 bad = make_uint2(0, 0);
    if (PTT_NAN_GUARD == 2 || (PTT_NAN_GUARD == 1 && !full)) {
      uint8_t* const tiles[1] = {wg_smem + (sV - sQ)};
      bad = guard_rows<HD>(tiles, bad_rows);
    }

    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wg::fence();
    flash::ss_over_d<HD>(sc, sQ, sK);
    wg::commit();
    wg::wait<0>();
    wg::fence_operand(sc);

    // the pair test: bit i of `live` for sc[i] (rows r_lo, r_hi)
    uint32_t live = 0xffffffffu;
    if (!full)
      live = live_bits(
          [&](int j) {
            const int2 c = mask.staged_col(ca, ca + R, cur, j);
            return mask.live(ra_lo, c) | mask.live(ra_hi, c) << 1;
          },
          nvalid, bad, nan_lo, nan_hi);
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] *= sl2;
      if (!((live >> i) & 1)) continue;  // masked: out of the max
      if (i & 2)
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
      float pr = exp2f(sc[i] - (hi_row ? m_hi : m_lo));
      if (!((live >> i) & 1)) pr = 0.f;  // a select, never a product
      sc[i] = pr;
      if (hi_row)
        s_hi += pr;
      else
        s_lo += pr;
    }
    l_lo = l_lo * a_lo + s_lo;
    l_hi = l_hi * a_hi + s_hi;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= (i & 2) ? a_hi : a_lo;
    uint32_t ph[4][4], pl[4][4];
    flash::split_all(sc, ph, pl);
    wg::fence_operand(acc);
    wg::fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) flash::rs_hilo<HD>(acc, ph[j], pl[j], sV, j);
    wg::commit();
    wg::wait<0>();
    wg::fence_operand(acc);
    __syncthreads();  // every warp is done with this stage and the mask
    if (t == 0 && (bad.x | bad.y)) bad_rows[0] = bad_rows[1] = 0;
    load_stage(stage, iss);
    wg::cp_async_commit();
    cur = nxt;
    nxt = iss;
    iss = iss < keys.y ? next_tile(iss + R) : keys.y;
  }
  wg::cp_async_wait<0>();
  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);
  nan_lo = quad_any(nan_lo);
  nan_hi = quad_any(nan_hi);
  // a keyless row (l = 0) emits zeros
  const float lc_lo = fmaxf(l_lo, 1e-30f), lc_hi = fmaxf(l_hi, 1e-30f);
  const float inv_lo = nan_lo ? __int_as_float(0x7fc00000) : 1.f / lc_lo;
  const float inv_hi = nan_hi ? __int_as_float(0x7fc00000) : 1.f / lc_hi;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] *= (i & 2) ? inv_hi : inv_lo;
  bf16* ob = static_cast<bf16*>(p.o) + ((size_t)b * p.Sq * p.H + h) * HD;
  flash::store_rows_strided<HD>(ob, acc, q0, q1, (size_t)p.H * HD);
  if ((lane & 3) == 0) {
    float* lb = p.lse + (size_t)bh * p.Sq;
    if (r_lo < q1)
      lb[r_lo] = m_lo == kNegInf ? m_lo + logf(lc_lo)
                                 : (m_lo + log2f(lc_lo)) * kLn2;
    if (r_hi < q1)
      lb[r_hi] = m_hi == kNegInf ? m_hi + logf(lc_hi)
                                 : (m_hi + log2f(lc_hi)) * kLn2;
  }
}

// -- the backward on the tensor cores ---------------------------------------

// shared memory of masked_dq_wgmma: Q, dO, two stages of K and V, two
// stages of the 64 key columns' attributes a and b, and the bad-row mask
template <int HD>
constexpr size_t dq_wgmma_smem_bytes() {
  return 6 * (size_t)flash::kTileBytes<HD> + 2 * 2 * flash::kRows * 4 + 16;
}

// dq: one block per (b*h, 64-row q tile), one warpgroup. Q and dO stay in
// shared memory; the live 64-key tiles of the policy's key range stream
// through a 2-stage cp.async ring with their column attributes, as in
// masked_fwd_wgmma. Per tile: S = Q K^T and dP = dO V^T (SS), p and ds by
// the pair test as a select unless the tile is wholly live, then dQ += dS K
// (RS, K read MN-major) with dS as hi + lo. K is the B operand of that
// product, so on a tile that is not wholly live its non-finite rows are
// zeroed first and every row with a live pair on one ends NaN. V enters
// only dP, where a masked pair's ds is replaced.
template <int HD, class Mask>
__global__ void __launch_bounds__(128)
    masked_dq_wgmma(const Params p, const Mask mask) {
  using bf16 = __nv_bfloat16;
  constexpr int R = flash::kRows;
  constexpr uint32_t kT = flash::kTileBytes<HD>;
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  const uint32_t sQ = wg::smem_addr(wg_smem);
  if (sQ & 1023) __trap();  // the swizzle needs it
  const uint32_t sDO = sQ + kT, sKV = sQ + 2 * kT;  // stage s: K, V at +2kT s
  int* attrs = reinterpret_cast<int*>(wg_smem + 6 * kT);  // stage s at 2R s
  uint32_t* bad_rows = reinterpret_cast<uint32_t*>(attrs + 4 * R);

  const int t = threadIdx.x, lane = t & 31;
  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int qt = blockIdx.y, q0 = qt * R, q1 = min(q0 + R, p.Sq);
  const int r_lo = q0 + (t >> 5) * 16 + lane / 4, r_hi = r_lo + 8;
  const bf16* qb = head_base<bf16>(p.q, b, h);
  const bf16* kb = head_base<bf16>(p.k, b, h);
  const bf16* vb = head_base<bf16>(p.v, b, h);
  const bf16* db = head_base<bf16>(p.dout, b, h);
  const float sl2 = p.scale * flash::kLog2e;
  const float* lse_b = p.lse + (size_t)bh * p.Sq;
  const float* del_b = p.delta + (size_t)bh * p.Sq;
  // this thread's two rows: lse in the exp2 domain, delta, attributes;
  // the tile's first and last rows (the wholly live test)
  const float lse_lo = r_lo < q1 ? lse_b[r_lo] * flash::kLog2e : 0.f;
  const float lse_hi = r_hi < q1 ? lse_b[r_hi] * flash::kLog2e : 0.f;
  const float dl_lo = r_lo < q1 ? del_b[r_lo] : 0.f;
  const float dl_hi = r_hi < q1 ? del_b[r_hi] : 0.f;
  const int2 ra_lo = r_lo < q1 ? mask.row(bh, r_lo) : Mask::dead_row();
  const int2 ra_hi = r_hi < q1 ? mask.row(bh, r_hi) : Mask::dead_row();
  const int2 first = mask.row(bh, q0), last = mask.row(bh, q1 - 1);
  int2 keys = mask.keys_of_q_tile(bh, qt, q0, q1);
  keys.x = max(keys.x, 0);
  keys.y = min(keys.y, p.Sk);
  auto next_tile = [&](int k) {  // the first live tile at or after k
    while (k < keys.y && mask.template dead_key_tile<R>(bh, k, q0)) k += R;
    return k;
  };
  auto load_stage = [&](int stage, int k) {
    if (k >= keys.y) return;
    const uint32_t sK = sKV + 2 * kT * stage;
    wg::load_panels_strided<HD>(sK, kb, p.k.ss, k, keys.y);
    wg::load_panels_strided<HD>(sK + kT, vb, p.v.ss, k, keys.y);
    const uint32_t sa = wg::smem_addr(attrs + 2 * R * stage);
    mask.stage_cols(sa, sa + 4 * R, bh, k, keys.y);
  };

  if (t == 0) bad_rows[0] = bad_rows[1] = 0;
  wg::load_panels_strided<HD>(sQ, qb, p.q.ss, q0, q1);
  wg::load_panels_strided<HD>(sDO, db, p.dout.ss, q0, q1);
  int cur = next_tile(keys.x);
  load_stage(0, cur);
  wg::cp_async_commit();
  int nxt = cur < keys.y ? next_tile(cur + R) : keys.y;
  load_stage(1, nxt);
  wg::cp_async_commit();
  int iss = nxt < keys.y ? next_tile(nxt + R) : keys.y;

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  bool nan_lo = false, nan_hi = false;  // a live pair met a non-finite K

  for (int it = 0; cur < keys.y; ++it) {
    const int stage = it & 1;
    wg::cp_async_wait<1>();  // this tile's copies (the next may fly)
    wg::fence_proxy_async();
    __syncthreads();
    const uint32_t sK = sKV + 2 * kT * stage, sV = sK + kT;
    const int* ca = attrs + 2 * R * stage;
    const int nvalid = min(R, keys.y - cur);
    bool ok = true;
    if (t < R) {
      const int2 c = mask.staged_col(ca, ca + R, cur, t);
      ok = t < nvalid && mask.live(first, c) && mask.live(last, c);
    }
    const bool full = __syncthreads_and(ok);
    uint2 bad = make_uint2(0, 0);  // K rows zeroed by the guard
    if (PTT_NAN_GUARD == 2 || (PTT_NAN_GUARD == 1 && !full)) {
      uint8_t* const tiles[1] = {wg_smem + (sK - sQ)};
      bad = guard_rows<HD>(tiles, bad_rows);
    }

    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    wg::fence();
    flash::ss_over_d<HD>(sc, sQ, sK);
    flash::ss_over_d<HD>(dp, sDO, sV);
    wg::commit();
    wg::wait<0>();
    wg::fence_operand(sc);
    wg::fence_operand(dp);

    // the pair test: bit i of `live` for sc[i] (rows r_lo, r_hi)
    uint32_t live = 0xffffffffu;
    if (!full)
      live = live_bits(
          [&](int j) {
            const int2 c = mask.staged_col(ca, ca + R, cur, j);
            return mask.live(ra_lo, c) | mask.live(ra_hi, c) << 1;
          },
          nvalid, bad, nan_lo, nan_hi);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool hi_row = (i & 2) != 0;
      const float pr =
          exp2f(fmaf(sc[i], sl2, -(hi_row ? lse_hi : lse_lo)));
      const float ds = pr * (dp[i] - (hi_row ? dl_hi : dl_lo)) * p.scale;
      dp[i] = ((live >> i) & 1) ? ds : 0.f;  // a select, never a product
    }
    uint32_t dh[4][4], dl[4][4];
    flash::split_all(dp, dh, dl);
    wg::fence_operand(acc);
    wg::fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) flash::rs_hilo<HD>(acc, dh[j], dl[j], sK, j);
    wg::commit();
    wg::wait<0>();
    wg::fence_operand(acc);
    __syncthreads();  // every warp is done with this stage and the mask
    if (t == 0 && (bad.x | bad.y)) bad_rows[0] = bad_rows[1] = 0;
    load_stage(stage, iss);
    wg::cp_async_commit();
    cur = nxt;
    nxt = iss;
    iss = iss < keys.y ? next_tile(iss + R) : keys.y;
  }
  wg::cp_async_wait<0>();
  nan_lo = quad_any(nan_lo);
  nan_hi = quad_any(nan_hi);
  const float qnan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int i = 0; i < HD / 2; ++i)
    if ((i & 2) ? nan_hi : nan_lo) acc[i] = qnan;
  bf16* dqb = static_cast<bf16*>(p.dq) + ((size_t)b * p.Sq * p.H + h) * HD;
  flash::store_rows_strided<HD>(dqb, acc, q0, q1, (size_t)p.H * HD);
}

// shared memory of masked_dkv_wgmma: K, V, two stages of Q and dO, two
// stages of the 64 rows' lse, delta and attributes a and b, and the
// bad-row mask
template <int HD>
constexpr size_t dkv_wgmma_smem_bytes() {
  return 6 * (size_t)flash::kTileBytes<HD> + 2 * 4 * flash::kRows * 4 + 16;
}

// dk/dv: one block per (b*h, 64-key tile at kt * 64, the tiling of the
// policy's row ranges), one warpgroup. K, V and the 64 columns' attributes
// stay resident; the 64-row tiles of the policy's row range (from its
// first row, not 64-aligned for packed documents) stream through a
// 2-stage ring with their lse, delta and row attributes. Per tile: S^T = K
// Q^T and dP^T = V dO^T (SS), p^T and ds^T by the pair test as a select
// unless the tile is wholly live, then dV += P^T dO and, once those
// products have read P's fragments, dK += dS^T Q (RS, dO and Q read
// MN-major), each as hi + lo. Q and dO are the B operands there, so on a
// tile that is not wholly live a row that is non-finite in either is
// zeroed in both, and every key with a live pair on it ends NaN in dk and
// dv. K and V enter only the SS products.
template <int HD, class Mask>
__global__ void __launch_bounds__(128)
    masked_dkv_wgmma(const Params p, const Mask mask) {
  using bf16 = __nv_bfloat16;
  constexpr int R = flash::kRows;
  constexpr uint32_t kT = flash::kTileBytes<HD>;
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  const uint32_t sK = wg::smem_addr(wg_smem);
  if (sK & 1023) __trap();
  const uint32_t sV = sK + kT, sQO = sK + 2 * kT;  // stage s: Q, dO at +2kT s
  // stage s at 4R s: lse, delta, row attributes a and b (R each)
  float* rows_s = reinterpret_cast<float*>(wg_smem + 6 * kT);
  uint32_t* bad_rows = reinterpret_cast<uint32_t*>(rows_s + 8 * R);

  const int t = threadIdx.x, lane = t & 31;
  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int kt = blockIdx.y, k0 = kt * R, k1 = min(k0 + R, p.Sk);
  const int c_lo = k0 + (t >> 5) * 16 + lane / 4, c_hi = c_lo + 8;
  const bf16* qb = head_base<bf16>(p.q, b, h);
  const bf16* kb = head_base<bf16>(p.k, b, h);
  const bf16* vb = head_base<bf16>(p.v, b, h);
  const bf16* db = head_base<bf16>(p.dout, b, h);
  const float sl2 = p.scale * flash::kLog2e;
  const float* lse_b = p.lse + (size_t)bh * p.Sq;
  const float* del_b = p.delta + (size_t)bh * p.Sq;
  // this thread's two keys, and (threads 0-63) key k0 + t of the wholly
  // live test
  const int2 ca_lo = c_lo < k1 ? mask.col(bh, c_lo) : Mask::dead_col();
  const int2 ca_hi = c_hi < k1 ? mask.col(bh, c_hi) : Mask::dead_col();
  const int2 ca_t = t < R && k0 + t < k1 ? mask.col(bh, k0 + t)
                                         : Mask::dead_col();
  int2 rows = mask.rows_of_k_tile(bh, kt, k0, k1);
  rows.x = max(rows.x, 0);
  rows.y = min(rows.y, p.Sq);
  auto load_stage = [&](int stage, int r0) {
    if (r0 >= rows.y) return;
    const uint32_t sQ = sQO + 2 * kT * stage;
    wg::load_panels_strided<HD>(sQ, qb, p.q.ss, r0, rows.y);
    wg::load_panels_strided<HD>(sQ + kT, db, p.dout.ss, r0, rows.y);
    // threads 0-63 copy the tile's lse, 64-127 its delta
    float* rs = rows_s + 4 * R * stage;
    const int r = r0 + (t & 63);
    const bool ok = r < rows.y;
    const float* src = t < 64 ? lse_b : del_b;
    wg::cp_async4(wg::smem_addr(rs + (t < 64 ? 0 : R) + (t & 63)),
                  ok ? src + r : src, ok);
    const uint32_t sa = wg::smem_addr(rs + 2 * R);
    mask.stage_rows(sa, sa + 4 * R, bh, r0, rows.y);
  };

  if (t == 0) bad_rows[0] = bad_rows[1] = 0;
  wg::load_panels_strided<HD>(sK, kb, p.k.ss, k0, k1);
  wg::load_panels_strided<HD>(sV, vb, p.v.ss, k0, k1);
  load_stage(0, rows.x);
  wg::cp_async_commit();
  load_stage(1, rows.x + R);
  wg::cp_async_commit();

  float acc_k[HD / 2], acc_v[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  // a live pair of key c_lo / c_hi met a row zeroed by the guard
  bool nan_lo = false, nan_hi = false;

  for (int it = 0, r0 = rows.x; r0 < rows.y; ++it, r0 += R) {
    const int stage = it & 1;
    wg::cp_async_wait<1>();
    wg::fence_proxy_async();
    __syncthreads();
    const uint32_t sQ = sQO + 2 * kT * stage, sDO = sQ + kT;
    const float* lse_t = rows_s + 4 * R * stage;
    const float* del_t = lse_t + R;
    const int* ra = reinterpret_cast<const int*>(lse_t + 2 * R);
    const int nvalid = min(R, rows.y - r0);
    const int2 first = mask.row(bh, r0), last = mask.row(bh, r0 + nvalid - 1);
    const bool full = __syncthreads_and(
        t >= R || (mask.live(first, ca_t) && mask.live(last, ca_t)));
    uint2 bad = make_uint2(0, 0);  // Q and dO rows zeroed by the guard
    if (PTT_NAN_GUARD == 2 || (PTT_NAN_GUARD == 1 && !full)) {
      uint8_t* const tiles[2] = {wg_smem + (sQ - sK), wg_smem + (sDO - sK)};
      bad = guard_rows<HD>(tiles, bad_rows);
    }

    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    wg::fence();
    flash::ss_over_d<HD>(st, sK, sQ);
    flash::ss_over_d<HD>(dpt, sV, sDO);
    wg::commit();
    wg::wait<0>();
    wg::fence_operand(st);
    wg::fence_operand(dpt);

    // the pair test: bit i of `live` for st[i] (keys c_lo, c_hi; the
    // tile's columns are q rows)
    uint32_t live = 0xffffffffu;
    if (!full)
      live = live_bits(
          [&](int j) {
            const int2 r = mask.staged_row(ra, ra + R, r0, j);
            return mask.live(r, ca_lo) | mask.live(r, ca_hi) << 1;
          },
          nvalid, bad, nan_lo, nan_hi);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qi = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const float pr = exp2f(fmaf(st[i], sl2, -lse_t[qi] * flash::kLog2e));
      const float ds = pr * (dpt[i] - del_t[qi]) * p.scale;
      const bool ok = (live >> i) & 1;  // a select, never a product
      st[i] = ok ? pr : 0.f;
      dpt[i] = ok ? ds : 0.f;
    }
    // dV += P^T dO, then dK += dS^T Q in the same fragment registers
    uint32_t fh[4][4], fl[4][4];
    flash::split_all(st, fh, fl);
    wg::fence_operand(acc_v);
    wg::fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) flash::rs_hilo<HD>(acc_v, fh[j], fl[j], sDO, j);
    wg::commit();
    wg::wait<0>();
    wg::fence_operand(acc_v);
    flash::split_all(dpt, fh, fl);
    wg::fence_operand(acc_k);
    wg::fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) flash::rs_hilo<HD>(acc_k, fh[j], fl[j], sQ, j);
    wg::commit();
    wg::wait<0>();
    wg::fence_operand(acc_k);
    __syncthreads();  // every warp is done with this stage and the mask
    if (t == 0 && (bad.x | bad.y)) bad_rows[0] = bad_rows[1] = 0;
    load_stage(stage, r0 + 2 * R);
    wg::cp_async_commit();
  }
  wg::cp_async_wait<0>();
  nan_lo = quad_any(nan_lo);
  nan_hi = quad_any(nan_hi);
  const float qnan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int i = 0; i < HD / 2; ++i)
    if ((i & 2) ? nan_hi : nan_lo) acc_k[i] = acc_v[i] = qnan;
  // ds carries one factor of scale and q none: dk = ds^T q as it stands
  const size_t head = ((size_t)b * p.Sk * p.H + h) * HD;
  flash::store_rows_strided<HD>(static_cast<bf16*>(p.dk) + head, acc_k, k0,
                                k1, (size_t)p.H * HD);
  flash::store_rows_strided<HD>(static_cast<bf16*>(p.dv) + head, acc_v, k0,
                                k1, (size_t)p.H * HD);
}

// the tensor-core route takes bf16 at D 64 or 128 with q, k, v (and, in
// the backward, dout) 16-byte aligned and every row, head and batch stride
// a multiple of 8 elements
inline bool wgmma_takes(int dtype, int hd, const Params& p, bool bwd) {
  if (dtype != kBFloat16 || (hd != 64 && hd != 128)) return false;
  const Operand* ops[4] = {&p.q, &p.k, &p.v, &p.dout};
  for (int i = 0; i < (bwd ? 4 : 3); ++i) {
    const Operand* x = ops[i];
    if ((uintptr_t)x->p % 16 || x->sb % 8 || x->ss % 8 || x->sh % 8)
      return false;
  }
  return true;
}

template <int HD, class Mask>
int launch_fwd_wgmma(const Params& p, const Mask& m, cudaStream_t st) {
  constexpr size_t bytes = fwd_wgmma_smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      masked_fwd_wgmma<HD, Mask>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(p.B * p.H, (p.Sq + kBQ - 1) / kBQ);
  masked_fwd_wgmma<HD, Mask><<<grid, 128, bytes, st>>>(p, m);
  return (int)cudaGetLastError();
}

// the dk/dv kernel's 64-key tiles are those of the CUDA-core pair at D 64
// and 128, so both routes read one k_ranges
static_assert(kWarps * dkv_rows<128>() == flash::kRows,
              "one k tile serves both backward routes");

template <int HD, class Mask>
int launch_bwd_wgmma(const Params& p, const Mask& m, cudaStream_t st) {
  constexpr size_t dq_bytes = dq_wgmma_smem_bytes<HD>();
  constexpr size_t dkv_bytes = dkv_wgmma_smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      masked_dq_wgmma<HD, Mask>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(masked_dkv_wgmma<HD, Mask>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)dkv_bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid_q(p.B * p.H, (p.Sq + kBQ - 1) / kBQ);
  masked_dq_wgmma<HD, Mask><<<grid_q, 128, dq_bytes, st>>>(p, m);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 grid_k(p.B * p.H, (p.Sk + flash::kRows - 1) / flash::kRows);
  masked_dkv_wgmma<HD, Mask><<<grid_k, 128, dkv_bytes, st>>>(p, m);
  return (int)cudaGetLastError();
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

// The forward: o and lse from q, k, v, on the route the caller names (0:
// the CUDA-core kernel, any dtype, hd 64, 128 or 256; 1: the tensor-core
// kernel, see wgmma_takes). A route that cannot take the inputs returns
// cudaErrorInvalidValue; no route is chosen here.
template <class Mask>
int run_fwd(int dtype, int hd, int route, const Params& p, const Mask& m,
            cudaStream_t st) {
  if (!shapes_ok(p, hd)) return (int)cudaErrorInvalidValue;
  if (route == kRouteCudaCore)
    return run_typed<Mask, false>(dtype, hd, p, m, st);
  if (route != kRouteWgmma || !wgmma_takes(dtype, hd, p, false))
    return (int)cudaErrorInvalidValue;
  return hd == 64 ? launch_fwd_wgmma<64, Mask>(p, m, st)
                  : launch_fwd_wgmma<128, Mask>(p, m, st);
}

// The backward: the dq kernel, then the dk/dv kernel, on one stream, on
// the route the caller names (0: the CUDA-core pair, any dtype, hd 64, 128
// or 256; 1: the tensor-core pair, see wgmma_takes), as run_fwd.
template <class Mask>
int run_bwd(int dtype, int hd, int route, const Params& p, const Mask& m,
            cudaStream_t st) {
  if (!shapes_ok(p, hd)) return (int)cudaErrorInvalidValue;
  if (route == kRouteCudaCore)
    return run_typed<Mask, true>(dtype, hd, p, m, st);
  if (route != kRouteWgmma || !wgmma_takes(dtype, hd, p, true))
    return (int)cudaErrorInvalidValue;
  return hd == 64 ? launch_bwd_wgmma<64, Mask>(p, m, st)
                  : launch_bwd_wgmma<128, Mask>(p, m, st);
}

}  // namespace masked
}  // namespace ptt
