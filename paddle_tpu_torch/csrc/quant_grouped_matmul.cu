// Grouped matmul over block-scaled int8 / fp8 expert weights.
//
// Replaces: paddle_tpu/kernels/pallas/quant_matmul.py, `_gq_kernel`
// launched by `_gq_call` (the pallas_call at line 263).
//
// Computes, for x [Tp, K] (float32 or bfloat16) sorted by expert as
// grouped_matmul.cu reads it (group e at the tile-aligned row offsets[e],
// counts[e] rows), codes [E, N, K] (int8 or float8 e4m3, each expert in
// the torch Linear layout of kernels/quant_matmul.py) and scales [E, N,
// KB] float32 with block bk = K / KB:
//   out[r, n] = sum_k x[r, k] * (codes[e(r), n, k] * scales[e(r), n, k / bk])
// over each group's live tiles, accumulated in float32 and written in x's
// dtype. Each code is dequantized in registers between its load and its
// store into shared memory, as the TPU kernel dequantizes in VMEM: the
// full-width expert weights never exist in device memory. Rows past a
// group's live tiles are not written.
//
// The routing stays on the card: each block reads its group's offset and
// count and returns at once past the live tiles.
//
// What bounds it on the H100: the MoE layer's shapes (16,384 routes, K
// and N 768 and 3072) do 77 GFLOP on about 0.1 GB, so operations bound it;
// float32 on the CUDA cores, its own arithmetic bounds it in practice.
//
// Design: the forward grouped kernel's schedule and tile (grouped_gemm.cuh)
// with the weight tile's loader swapped for one that reads 4 codes of an
// output column (one 4-byte load) and their scales. No tensor cores yet.

#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "grouped_gemm.cuh"

namespace {

using namespace ptt::gg;

constexpr int kQInt8 = 0;  // code dtype codes (kernels/quant_matmul.py)
constexpr int kQFp8 = 1;

template <int Q>
__device__ __forceinline__ float code_to_float(unsigned b);
template <>
__device__ __forceinline__ float code_to_float<kQInt8>(unsigned b) {
  return (float)(int8_t)(uint8_t)b;
}
template <>
__device__ __forceinline__ float code_to_float<kQFp8>(unsigned b) {
  __half_raw h = __nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)(b & 0xffu),
                                         __NV_E4M3);
  return __half2float(__half(h));
}

// Bs[c][j] = codes[n0 + j, k0 + c] * scales[n0 + j, (k0 + c) / bk] of one
// expert's [N, K] codes. Thread t reads output column t / 2, four
// consecutive codes (one 4-byte load when vec).
template <int Q>
struct QuantB {
  const uint8_t* codes;
  const float* scales;
  int K, N, KB, bk, n0;
  bool vec;
  int j, c4;

  __device__ QuantB(const uint8_t* codes_, const float* scales_, int K_,
                    int N_, int KB_, int bk_, int n0_, bool vec_)
      : codes(codes_), scales(scales_), K(K_), N(N_), KB(KB_), bk(bk_),
        n0(n0_), vec(vec_), j(threadIdx.x >> 1),
        c4((threadIdx.x & 1) * 4) {}

  __device__ __forceinline__ void load(int k0, float* r) const {
    const int n = n0 + j;
    const int k = k0 + c4;
    const int nv = n < N ? clamp4(K - k) : 0;
    const uint8_t* p = codes + (size_t)n * K + k;
    const float* s = scales + (size_t)n * KB;
    if (vec && nv == 4) {
      const unsigned raw = *reinterpret_cast<const unsigned*>(p);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = code_to_float<Q>(raw >> (8 * i)) * s[(k + i) / bk];
      return;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = i < nv ? code_to_float<Q>(p[i]) * s[(k + i) / bk] : 0.f;
  }
  __device__ __forceinline__ void store(float (*bs)[kBN + kPad],
                                        const float* r) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) bs[c4 + i][j] = r[i];
  }
};

template <typename T, int Q>
__global__ void __launch_bounds__(kThreads, 2)
    quant_grouped_fwd(const T* __restrict__ x,
                      const uint8_t* __restrict__ codes,
                      const float* __restrict__ scales, T* __restrict__ out,
                      const int* __restrict__ offsets,
                      const int* __restrict__ counts, int Tp, int K, int N,
                      int KB, int bk, int bm, int vec_a, int vec_b) {
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
  float acc[8][8];
  zero_acc(acc);
  const RowsA<T> la(x, K, row0, row_end, vec_a);
  const QuantB<Q> lb(codes + (size_t)e * N * K, scales + (size_t)e * N * KB,
                     K, N, KB, bk, n0, vec_b);
  mainloop(la, lb, K, sm, acc, tx, ty);
  store_tile<T, T>(out, N, row0, row_end, n0, nullptr, acc, tx, ty);
}

template <typename T, int Q>
int launch(const void* x, const void* codes, const void* scales, void* out,
           const int* offsets, const int* counts, int E, int Tp, int K,
           int N, int KB, int bk, int bm, cudaStream_t st) {
  const int vec_a = (K % 4 == 0) && ((uintptr_t)x % (sizeof(T) * 4) == 0);
  const int vec_b = (K % 4 == 0) && ((uintptr_t)codes % 4 == 0);
  const dim3 grid((N + kBN - 1) / kBN, (Tp + kBM - 1) / kBM, E);
  quant_grouped_fwd<T, Q><<<grid, kThreads, 0, st>>>(
      (const T*)x, (const uint8_t*)codes, (const float*)scales, (T*)out,
      offsets, counts, Tp, K, N, KB, bk, bm, vec_a, vec_b);
  return (int)cudaGetLastError();
}

}  // namespace

// x [Tp, K] (x_dtype 0 = float32, 1 = bfloat16); codes [E, N, K] (q_dtype
// 0 = int8, 1 = float8 e4m3); scales [E, N, KB] float32 with bk = K / KB;
// out [Tp, N] in x's dtype; offsets, counts [E] int32 on the card. All
// contiguous. Returns the CUDA error code of the launch (0 on success).
extern "C" int quant_grouped_matmul_fwd(const void* x, const void* codes,
                                        const void* scales, void* out,
                                        const void* offsets,
                                        const void* counts, int E, int Tp,
                                        int K, int N, int KB, int bk, int bm,
                                        int x_dtype, int q_dtype,
                                        void* stream) {
  if (E <= 0 || Tp <= 0 || K <= 0 || N <= 0 || KB <= 0 || bk <= 0 ||
      bk * KB != K || bm <= 0 || (Tp + kBM - 1) / kBM > 65535 || E > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* off = (const int*)offsets;
  const int* cnt = (const int*)counts;
  if (x_dtype == ptt::kFloat32 && q_dtype == kQInt8)
    return launch<float, kQInt8>(x, codes, scales, out, off, cnt, E, Tp, K,
                                 N, KB, bk, bm, st);
  if (x_dtype == ptt::kFloat32 && q_dtype == kQFp8)
    return launch<float, kQFp8>(x, codes, scales, out, off, cnt, E, Tp, K,
                                N, KB, bk, bm, st);
  if (x_dtype == ptt::kBFloat16 && q_dtype == kQInt8)
    return launch<__nv_bfloat16, kQInt8>(x, codes, scales, out, off, cnt, E,
                                         Tp, K, N, KB, bk, bm, st);
  if (x_dtype == ptt::kBFloat16 && q_dtype == kQFp8)
    return launch<__nv_bfloat16, kQFp8>(x, codes, scales, out, off, cnt, E,
                                        Tp, K, N, KB, bk, bm, st);
  return (int)cudaErrorInvalidValue;
}
