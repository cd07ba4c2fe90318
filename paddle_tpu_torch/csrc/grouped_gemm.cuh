// The shared body of the port's grouped (expert-sorted) matrix products:
// a 128 x 128 output tile per block of 256 threads, 8 x 8 outputs per
// thread, the contraction in steps of 8 through double-buffered shared
// memory, everything in float32 on the CUDA cores.
//
// A kernel supplies two loaders, one for the A tile (the 128 output rows'
// slice of the contraction) and one for the B tile (the contraction's
// slice of the 128 output columns). Each loads its 1024 elements, 4 per
// thread, from device memory into registers (`load`) and writes them to
// shared memory as As[c][m] / Bs[c][j], c the contraction index inside the
// step (`store`). The main loop loads the next step into registers while
// the block multiplies the current one out of shared memory, so one
// barrier per step suffices. An element outside the operand (past a
// group's rows, past K or N) is never read: the loader writes 0 in its
// place, so a NaN there cannot reach a sum.
//
// Its users: the CUDA-core routes of the grouped forward (`grouped_fwd`,
// grouped_matmul.cu) and of the quantized grouped forward
// (`quant_grouped_fwd`, quant_grouped_matmul.cu), the weight gradient
// (`grouped_dw`), and the tensor-core forward's and weight gradient's
// redo of a tile that holds an inf or a NaN (`grouped_wgmma`,
// `grouped_dw_wgmma`: their split pieces would turn inf x 0 into NaN;
// these float32 FMAs give the IEEE products).
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace ptt {
namespace gg {

constexpr int kBM = 128;      // output rows per block
constexpr int kBN = 128;      // output columns per block
constexpr int kBK = 8;        // contraction step
constexpr int kThreads = 256;
constexpr int kPad = 4;       // keeps float4 rows 16-byte aligned, no conflicts

struct Smem {
  float a[2][kBK][kBM + kPad];
  float b[2][kBK][kBN + kPad];
};

// v[0..3] = p[0..3] as float; only the first n_valid (0..4) are read, the
// rest are 0. vec: p is aligned for one 16-byte (float) or 8-byte
// (bfloat16) load, taken when all four are valid.
__device__ __forceinline__ void load4(const float* p, bool vec, int n_valid,
                                      float* v) {
  if (vec && n_valid == 4) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = i < n_valid ? p[i] : 0.f;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, bool vec,
                                      int n_valid, float* v) {
  if (vec && n_valid == 4) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
    const float2 f0 = __bfloat1622float2(h[0]);
    const float2 f1 = __bfloat1622float2(h[1]);
    v[0] = f0.x; v[1] = f0.y; v[2] = f1.x; v[3] = f1.y;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = i < n_valid ? to_float(p[i]) : 0.f;
}

__device__ __forceinline__ int clamp4(int n) { return n < 0 ? 0 : (n > 4 ? 4 : n); }

// A tile from row-major rows: As[c][m] = a[row0 + m, k0 + c] for the rows
// [row0, row_end) of an [rows, K] operand (the grouped forward's x).
// Thread t reads row t / 2, four contraction indices from (t % 2) * 4.
template <typename T>
struct RowsA {
  const T* a;
  int K, row0, row_end;
  bool vec;
  int m, c4;

  __device__ RowsA(const T* a_, int K_, int row0_, int row_end_, bool vec_)
      : a(a_), K(K_), row0(row0_), row_end(row_end_), vec(vec_),
        m(threadIdx.x >> 1), c4((threadIdx.x & 1) * 4) {}

  __device__ __forceinline__ void load(int k0, float* r) const {
    const int row = row0 + m;
    const int k = k0 + c4;
    const int n = row < row_end ? clamp4(K - k) : 0;
    load4(a + (size_t)row * K + k, vec, n, r);
  }
  __device__ __forceinline__ void store(float (*as)[kBM + kPad],
                                        const float* r) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) as[c4 + i][m] = r[i];
  }
};

// 8 x 8 outputs per thread: rows {ty*4 .. +4, 64 + ty*4 .. +4}, columns
// {tx*4 .. +4, 64 + tx*4 .. +4}; the split halves keep a warp's float4
// reads of a shared row free of bank conflicts.
__device__ __forceinline__ int out_row(int i, int ty) {
  return i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4);
}

__device__ __forceinline__ void mma_step(const float (*as)[kBM + kPad],
                                         const float (*bs)[kBN + kPad],
                                         float (*acc)[8], int tx, int ty) {
#pragma unroll
  for (int c = 0; c < kBK; ++c) {
    const float4 a0 = *reinterpret_cast<const float4*>(&as[c][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&as[c][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&bs[c][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&bs[c][64 + tx * 4]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc += A . B over the contraction [0, k_total), A and B as the loaders
// give them. Ends with a barrier, so shared memory may be reused after.
template <class LA, class LB>
__device__ __forceinline__ void mainloop(const LA& la, const LB& lb,
                                         int k_total, Smem& sm,
                                         float (*acc)[8], int tx, int ty) {
  float ra[4], rb[4];
  la.load(0, ra);
  lb.load(0, rb);
  la.store(sm.a[0], ra);
  lb.store(sm.b[0], rb);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < k_total; k0 += kBK) {
    const bool more = k0 + kBK < k_total;
    if (more) {
      la.load(k0 + kBK, ra);
      lb.load(k0 + kBK, rb);
    }
    mma_step(sm.a[buf], sm.b[buf], acc, tx, ty);
    if (more) {
      la.store(sm.a[buf ^ 1], ra);
      lb.store(sm.b[buf ^ 1], rb);
    }
    __syncthreads();
    buf ^= 1;
  }
}

// out[row0 + r, n0 + j] = acc (+ bias[n0 + j]) for the rows below row_end
// and the columns below N; out has N columns. bias may be null.
template <typename TO, typename TB>
__device__ __forceinline__ void store_tile(TO* out, int N, int row0,
                                           int row_end, int n0,
                                           const TB* bias,
                                           const float (*acc)[8], int tx,
                                           int ty) {
  float bv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + out_row(j, tx);
    bv[j] = (bias != nullptr && n < N) ? to_float(bias[n]) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + out_row(i, ty);
    if (r >= row_end) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + out_row(j, tx);
      if (n < N) out[(size_t)r * N + n] = from_float<TO>(acc[i][j] + bv[j]);
    }
  }
}

__device__ __forceinline__ void zero_acc(float (*acc)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// The rows of group e that the forward computes: its live tiles, from its
// tile-aligned offset up to ceil(counts[e] / bm) * bm rows, as the TPU
// kernel's grid does (rows past counts[e] inside the last live tile are
// padding: computed, and unspecified to the caller).
__device__ __forceinline__ int live_rows(const int* counts, int e, int bm) {
  const int c = counts[e];
  return c > 0 ? ((c + bm - 1) / bm) * bm : 0;
}

}  // namespace gg
}  // namespace ptt
