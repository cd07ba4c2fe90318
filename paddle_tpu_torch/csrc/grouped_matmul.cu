// Grouped matmul over expert-sorted rows: the forward (also the input
// gradient, against the transposed weight) and the weight gradient.
//
// Replaces: paddle_tpu/kernels/pallas/grouped_matmul.py, `_fwd_kernel`
// launched by `_fwd_call` (the pallas_call at line 226) and `_dw_kernel`
// launched by `_dw_call` (line 287).
//
// Layout (grouped_metadata's): the rows of x are sorted by expert, group e
// starting at the tile-aligned row offsets[e] (a multiple of bm) with
// counts[e] rows; rows between groups are padding.
//
// grouped_mm_fwd computes out[r] = x[r] . w[e(r)] (+ b[e(r)]) over each
// group's live tiles: x [Tp, K], w [E, K, N] (or, transposed, w [E, N, K]
// read in place: out[r] = x[r] . w[e]^T, the input gradient dy . w^T of
// the TPU backward without materialising swapaxes(w)), b [E, N] or null,
// out [Tp, N] in x's dtype. Rows past a group's live tiles are not
// written. grouped_mm_dw computes dw[e] = sum over the group's rows r <
// offsets[e] + counts[e] of x[r]^T dy[r] into dw [E, K, N] float32; a row
// past counts[e] is never loaded (selection, not a multiply by 0), so a
// NaN in a padding row cannot reach dw.
//
// The routing never leaves the card: each block reads its group's offset
// and count from device memory and returns at once past the live tiles,
// as the TPU kernel's `pl.when(t < tcnt[e])` does. The grid covers the
// worst case, (N tiles, ceil(Tp / 128) row tiles, E) for the forward and
// (N tiles, K tiles, E) for dw.
//
// What bounds it on the H100. The MoE layer's products (16,384 routes, K
// and N 768 and 3072) do 2 * routes * K * N = 77 GFLOP on 0.2 GB: about
// 400 flops per byte, above the card's balance point, so operations bound
// them. This kernel runs float32 on the CUDA cores (67 TFLOP/s peak), not
// the tensor cores (495 TFLOP/s TF32, 989 bf16), so its own arithmetic
// bounds it in practice.
//
// Design, simple and right first (grouped_gemm.cuh): 128 x 128 output
// tiles, 256 threads with 8 x 8 outputs each, the contraction in steps of
// 8 through double-buffered shared memory, float32 accumulation, bfloat16
// inputs converted on load. The dw block loops over its group's rows. No
// tensor cores (wgmma), no TMA: those are the next steps.

#include "grouped_gemm.cuh"

namespace {

using namespace ptt::gg;

// B tile of the forward: Bs[c][j] = w[k0 + c, n0 + j] of a row-major
// [K, N] matrix. Thread t reads contraction row t / 32, four columns.
template <typename T>
struct DenseB {
  const T* w;
  int K, N, n0;
  bool vec;
  int c, j4;

  __device__ DenseB(const T* w_, int K_, int N_, int n0_, bool vec_)
      : w(w_), K(K_), N(N_), n0(n0_), vec(vec_), c(threadIdx.x >> 5),
        j4((threadIdx.x & 31) * 4) {}

  __device__ __forceinline__ void load(int k0, float* r) const {
    const int k = k0 + c;
    const int n = n0 + j4;
    load4(w + (size_t)k * N + n, vec, k < K ? clamp4(N - n) : 0, r);
  }
  __device__ __forceinline__ void store(float (*bs)[kBN + kPad],
                                        const float* r) const {
    *reinterpret_cast<float4*>(&bs[c][j4]) = make_float4(r[0], r[1], r[2],
                                                         r[3]);
  }
};

// B tile read through the transpose: Bs[c][j] = w[n0 + j, k0 + c] of a
// row-major [N, K] matrix (the forward weight [K_fwd, N_fwd] seen from the
// input gradient, whose contraction is N_fwd). Thread t reads output
// column t / 2, four contraction indices.
template <typename T>
struct TransposedB {
  const T* w;
  int K, N, n0;
  bool vec;
  int j, c4;

  __device__ TransposedB(const T* w_, int K_, int N_, int n0_, bool vec_)
      : w(w_), K(K_), N(N_), n0(n0_), vec(vec_), j(threadIdx.x >> 1),
        c4((threadIdx.x & 1) * 4) {}

  __device__ __forceinline__ void load(int k0, float* r) const {
    const int n = n0 + j;
    const int k = k0 + c4;
    load4(w + (size_t)n * K + k, vec, n < N ? clamp4(K - k) : 0, r);
  }
  __device__ __forceinline__ void store(float (*bs)[kBN + kPad],
                                        const float* r) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) bs[c4 + i][j] = r[i];
  }
};

// x [Tp, K] . w[e] -> out [Tp, N]; TRANS: w[e] is [N, K] and read
// transposed. One block per (N tile, row tile t of group e, e).
template <typename T, bool TRANS>
__global__ void __launch_bounds__(kThreads, 2)
    grouped_fwd(const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ bias, T* __restrict__ out,
                const int* __restrict__ offsets,
                const int* __restrict__ counts, int Tp, int K, int N,
                int bm, int vec_a, int vec_b) {
  __shared__ __align__(16) Smem sm;
  const int e = blockIdx.z;
  const int live = live_rows(counts, e, bm);
  const int t0 = blockIdx.y * kBM;
  if (t0 >= live) return;               // past the group's live tiles
  const int row0 = offsets[e] + t0;
  const int row_end = min(offsets[e] + live, Tp);
  if (row0 >= row_end) return;
  const int n0 = blockIdx.x * kBN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* we = w + (size_t)e * K * N;
  float acc[8][8];
  zero_acc(acc);
  const RowsA<T> la(x, K, row0, row_end, vec_a);
  if (TRANS) {
    const TransposedB<T> lb(we, K, N, n0, vec_b);
    mainloop(la, lb, K, sm, acc, tx, ty);
  } else {
    const DenseB<T> lb(we, K, N, n0, vec_b);
    mainloop(la, lb, K, sm, acc, tx, ty);
  }
  store_tile<T, T>(out, N, row0, row_end, n0,
                   bias != nullptr ? bias + (size_t)e * N : nullptr, acc,
                   tx, ty);
}

// dw tiles: the contraction runs over the group's rows. A: As[c][m] =
// x[r0 + k0 + c, m0 + m] (x^T); B: Bs[c][j] = dy[r0 + k0 + c, n0 + j].
// Thread t reads row t / 32, four consecutive columns; a row at or past
// r_end is not read.
template <typename T>
struct GroupRows {
  const T* a;
  int cols, r0, r_end, col0;
  bool vec;
  int c, j4;

  __device__ GroupRows(const T* a_, int cols_, int r0_, int r_end_,
                       int col0_, bool vec_)
      : a(a_), cols(cols_), r0(r0_), r_end(r_end_), col0(col0_),
        vec(vec_), c(threadIdx.x >> 5), j4((threadIdx.x & 31) * 4) {}

  __device__ __forceinline__ void load(int k0, float* r) const {
    const int row = r0 + k0 + c;
    const int col = col0 + j4;
    load4(a + (size_t)row * cols + col, vec,
          row < r_end ? clamp4(cols - col) : 0, r);
  }
  __device__ __forceinline__ void store(float (*s)[kBM + kPad],
                                        const float* r) const {
    *reinterpret_cast<float4*>(&s[c][j4]) = make_float4(r[0], r[1], r[2],
                                                        r[3]);
  }
};

// dw[e] [K, N] = sum over rows r in [offsets[e], offsets[e] + counts[e])
// of x[r]^T dy[r]. One block per (N tile, K tile, e); an empty group
// writes zeros.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    grouped_dw(const T* __restrict__ x, const T* __restrict__ dy,
               float* __restrict__ dw, const int* __restrict__ offsets,
               const int* __restrict__ counts, int Tp, int K, int N,
               int vec_x, int vec_dy) {
  __shared__ __align__(16) Smem sm;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int r0 = offsets[e];
  const int cnt = max(0, min(counts[e], Tp - r0));
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[8][8];
  zero_acc(acc);
  const GroupRows<T> la(x, K, r0, r0 + cnt, m0, vec_x);
  const GroupRows<T> lb(dy, N, r0, r0 + cnt, n0, vec_dy);
  mainloop(la, lb, cnt, sm, acc, tx, ty);
  store_tile<float, float>(dw + (size_t)e * K * N, N, m0, K, n0, nullptr,
                           acc, tx, ty);
}

bool aligned(const void* p, int bytes) {
  return ((uintptr_t)p % bytes) == 0;
}

template <typename T>
int launch_fwd(const void* x, const void* w, const void* b, void* out,
               const int* offsets, const int* counts, int E, int Tp, int K,
               int N, int bm, int trans, cudaStream_t st) {
  const int vb = sizeof(T) * 4;
  // four consecutive elements along x's rows, and along w's contiguous dim
  const int vec_a = (K % 4 == 0) && aligned(x, vb);
  const int vec_b = (trans ? K % 4 == 0 : N % 4 == 0) && aligned(w, vb);
  const dim3 grid((N + kBN - 1) / kBN, (Tp + kBM - 1) / kBM, E);
  if (trans)
    grouped_fwd<T, true><<<grid, kThreads, 0, st>>>(
        (const T*)x, (const T*)w, (const T*)b, (T*)out, offsets, counts, Tp,
        K, N, bm, vec_a, vec_b);
  else
    grouped_fwd<T, false><<<grid, kThreads, 0, st>>>(
        (const T*)x, (const T*)w, (const T*)b, (T*)out, offsets, counts, Tp,
        K, N, bm, vec_a, vec_b);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dw(const void* x, const void* dy, void* dw, const int* offsets,
              const int* counts, int E, int Tp, int K, int N,
              cudaStream_t st) {
  const int vb = sizeof(T) * 4;
  const int vec_x = (K % 4 == 0) && aligned(x, vb);
  const int vec_dy = (N % 4 == 0) && aligned(dy, vb);
  const dim3 grid((N + kBN - 1) / kBN, (K + kBM - 1) / kBM, E);
  grouped_dw<T><<<grid, kThreads, 0, st>>>(
      (const T*)x, (const T*)dy, (float*)dw, offsets, counts, Tp, K, N,
      vec_x, vec_dy);
  return (int)cudaGetLastError();
}

}  // namespace

// x [Tp, K]; w [E, K, N], or [E, N, K] when trans (then out[r] = x[r] .
// w[e]^T); b [E, N] or null; out [Tp, N]; x, w, b and out share the dtype
// (0 = float32, 1 = bfloat16); offsets, counts [E] int32 on the card. All
// contiguous. Returns the CUDA error code of the launch (0 on success).
extern "C" int grouped_matmul_fwd(const void* x, const void* w,
                                  const void* b, void* out,
                                  const void* offsets, const void* counts,
                                  int E, int Tp, int K, int N, int bm,
                                  int trans, int dtype, void* stream) {
  if (E <= 0 || Tp <= 0 || K <= 0 || N <= 0 || bm <= 0 ||
      (Tp + kBM - 1) / kBM > 65535 || E > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* off = (const int*)offsets;
  const int* cnt = (const int*)counts;
  if (dtype == ptt::kFloat32)
    return launch_fwd<float>(x, w, b, out, off, cnt, E, Tp, K, N, bm, trans,
                             st);
  if (dtype == ptt::kBFloat16)
    return launch_fwd<__nv_bfloat16>(x, w, b, out, off, cnt, E, Tp, K, N,
                                     bm, trans, st);
  return (int)cudaErrorInvalidValue;
}

// x [Tp, K] and dy [Tp, N] of one dtype (0 = float32, 1 = bfloat16);
// dw [E, K, N] float32; offsets, counts [E] int32 on the card. All
// contiguous. Returns the CUDA error code of the launch (0 on success).
extern "C" int grouped_matmul_dw(const void* x, const void* dy, void* dw,
                                 const void* offsets, const void* counts,
                                 int E, int Tp, int K, int N, int dtype,
                                 void* stream) {
  if (E <= 0 || Tp <= 0 || K <= 0 || N <= 0 ||
      (K + kBM - 1) / kBM > 65535 || E > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* off = (const int*)offsets;
  const int* cnt = (const int*)counts;
  if (dtype == ptt::kFloat32)
    return launch_dw<float>(x, dy, dw, off, cnt, E, Tp, K, N, st);
  if (dtype == ptt::kBFloat16)
    return launch_dw<__nv_bfloat16>(x, dy, dw, off, cnt, E, Tp, K, N, st);
  return (int)cudaErrorInvalidValue;
}
