// RMSNorm over the last dim of x [n, h]: forward, and backward with the
// weight gradient reduced in a fixed order.
//
// Replaces: paddle_tpu/kernels/pallas/rms_norm.py, `_fwd_kernel` (the
// pallas_call of `_rms_fwd`, line 59) and `_bwd_kernel` (the pallas_call
// of `_rms_bwd`, line 84). The TPU backward leaves dw = sum over rows of
// g * xhat to an XLA einsum (Mosaic's store tiling refuses a (1, h) block
// output); here the backward kernel writes per-block float32 partials and
// a second small kernel adds them in a fixed order, so dw is the same bits
// on every run, with no atomics.
//
// Forward: out = x * rstd * w in float32, cast to x's dtype, with
// rstd = rsqrt(mean(x^2) + eps) saved as float32 [n]. Backward, from that
// rstd: xhat = x * rstd, dx = rstd * (g w - xhat mean(g w xhat)), and
// dw = sum over rows of g * xhat, cast to w's dtype. rsqrtf is within
// 2 ulp of the rounded reciprocal square root (CUDA's documented bound),
// which the tolerances allow.
//
// What bounds it on the H100: bytes. The forward reads x once and writes
// out once, the backward reads x and g once and writes dx once (w, rstd
// and the partials are small beside them), and each element costs a few
// flops. The design: a block of up to 512 threads per row (forward) or
// per run of rows (backward); each thread owns kCols columns of the row as
// 16-byte vectors, strided by the block so that a warp reads 512
// contiguous bytes, and keeps them in registers between the row's sum
// (one block reduction) and its output, so every byte is read from device
// memory once. The backward block carries its columns' dw partials in
// registers across its rows.

#include "rowwise.cuh"

namespace {

using ptt::rowwise::block_sum;
using ptt::rowwise::load;
using ptt::rowwise::store;
using ptt::rowwise::vec_elems;

constexpr int kMaxThreads = 512;

// kCols: the columns of a row each thread owns, a whole number of 16-byte
// vectors of either dtype.
template <typename T, typename W, int kCols>
__global__ void __launch_bounds__(kMaxThreads)
    rms_fwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                   T* __restrict__ out, float* __restrict__ rstd, int h,
                   float eps) {
  constexpr int E = vec_elems<T>();
  constexpr int NV = kCols / E;
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const T* xr = x + row * h;
  const int nvec = h / E;
  float v[NV][E];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = i * blockDim.x + threadIdx.x;
    if (c < nvec) {
      load<T, E>(xr + c * E, v[i]);
#pragma unroll
      for (int e = 0; e < E; ++e) ss += v[i][e] * v[i][e];
    }
  }
  const float rs = rsqrtf(block_sum(ss, red) / static_cast<float>(h) + eps);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = i * blockDim.x + threadIdx.x;
    if (c < nvec) {
      float o[E];
#pragma unroll
      for (int e = 0; e < E; ++e)
        o[e] = __fmul_rn(__fmul_rn(v[i][e], rs),
                         ptt::to_float(w[c * E + e]));
      store<T, E>(out + row * h + c * E, o);
    }
  }
  if (threadIdx.x == 0) rstd[row] = rs;
}

// Rows [blockIdx.x * rows, ...) of the backward: dx, and this block's
// float32 dw partial over its rows in partial[blockIdx.x, :].
template <typename T, typename W, int kCols>
__global__ void __launch_bounds__(kMaxThreads)
    rms_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                   const float* __restrict__ rstd, const T* __restrict__ g,
                   T* __restrict__ dx, float* __restrict__ partial, int n,
                   int h, int rows) {
  constexpr int E = vec_elems<T>();
  constexpr int NV = kCols / E;
  __shared__ float red[32];
  const int nvec = h / E;
  float acc[NV][E];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows;
  const long long r1 = min(r0 + rows, static_cast<long long>(n));
  for (long long row = r0; row < r1; ++row) {
    const float rs = rstd[row];
    float xv[NV][E], gv[NV][E];
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = i * blockDim.x + threadIdx.x;
      if (c < nvec) {
        load<T, E>(x + row * h + c * E, xv[i]);
        load<T, E>(g + row * h + c * E, gv[i]);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float xh = __fmul_rn(xv[i][e], rs);
          const float wg = __fmul_rn(gv[i][e], ptt::to_float(w[c * E + e]));
          dot += wg * xh;
          acc[i][e] += __fmul_rn(gv[i][e], xh);
        }
      }
    }
    const float mean = block_sum(dot, red) / static_cast<float>(h);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = i * blockDim.x + threadIdx.x;
      if (c < nvec) {
        float o[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float xh = __fmul_rn(xv[i][e], rs);
          const float wg = __fmul_rn(gv[i][e], ptt::to_float(w[c * E + e]));
          o[e] = __fmul_rn(rs, __fsub_rn(wg, __fmul_rn(xh, mean)));
        }
        store<T, E>(dx + row * h + c * E, o);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = i * blockDim.x + threadIdx.x;
    if (c < nvec) {
      float* pr = partial + static_cast<long long>(blockIdx.x) * h + c * E;
#pragma unroll
      for (int e = 0; e < E; ++e) pr[e] = acc[i][e];
    }
  }
}

// dw[c] = sum over b of partial[b, c], in the order b = j, j + 8, ... for
// each of 8 lanes j, then lane 0 + 1 + ... + 7: a fixed order, so the same
// bits every run. Block (32, 8): 32 columns, 8 row lanes.
template <typename W>
__global__ void dw_reduce_kernel(const float* __restrict__ partial,
                                 W* __restrict__ dw, int nb, int h) {
  __shared__ float part[8][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (c < h)
    for (int b = threadIdx.y; b < nb; b += 8)
      s += partial[static_cast<long long>(b) * h + c];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < h) {
    float t = part[0][threadIdx.x];
#pragma unroll
    for (int j = 1; j < 8; ++j) t += part[j][threadIdx.x];
    dw[c] = ptt::from_float<W>(t);
  }
}

// threads of a block for h columns at kCols a thread: a multiple of 32
int threads_for(int h, int elems, int cols) {
  const int nvec = h / elems;
  const int per = cols / elems;
  const int t = (nvec + per - 1) / per;
  return ((t + 31) / 32) * 32;
}

template <typename T, typename W, int kCols>
int fwd_launch(const void* x, const void* w, void* out, void* rstd, int n,
               int h, float eps, cudaStream_t stream) {
  const int threads = threads_for(h, vec_elems<T>(), kCols);
  rms_fwd_kernel<T, W, kCols><<<n, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<T*>(out), static_cast<float*>(rstd), h, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename W, int kCols>
int bwd_launch(const void* x, const void* w, const void* rstd, const void* g,
               void* dx, void* partial, void* dw, int n, int h, int rows,
               cudaStream_t stream) {
  const int threads = threads_for(h, vec_elems<T>(), kCols);
  const int nb = (n + rows - 1) / rows;
  rms_bwd_kernel<T, W, kCols><<<nb, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<const float*>(rstd), static_cast<const T*>(g),
      static_cast<T*>(dx), static_cast<float*>(partial), n, h, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dw_reduce_kernel<W><<<(h + 31) / 32, dim3(32, 8), 0, stream>>>(
      static_cast<const float*>(partial), static_cast<W*>(dw), nb, h);
  return static_cast<int>(cudaGetLastError());
}

// kCols 16 up to h = 16 * 512; 32 beyond, up to 32 * 512
template <typename T, typename W>
int fwd_cols(const void* x, const void* w, void* out, void* rstd, int n,
             int h, float eps, cudaStream_t stream) {
  if (h <= 16 * kMaxThreads)
    return fwd_launch<T, W, 16>(x, w, out, rstd, n, h, eps, stream);
  return fwd_launch<T, W, 32>(x, w, out, rstd, n, h, eps, stream);
}

template <typename T, typename W>
int bwd_cols(const void* x, const void* w, const void* rstd, const void* g,
             void* dx, void* partial, void* dw, int n, int h, int rows,
             cudaStream_t stream) {
  if (h <= 16 * kMaxThreads)
    return bwd_launch<T, W, 16>(x, w, rstd, g, dx, partial, dw, n, h, rows,
                                stream);
  return bwd_launch<T, W, 32>(x, w, rstd, g, dx, partial, dw, n, h, rows,
                              stream);
}

bool bad_shape(int n, int h) {
  return n < 1 || h < 1 || h % 128 != 0 || h > 32 * kMaxThreads;
}

}  // namespace

// x [n, h] contiguous in x_dtype, w [h] in w_dtype (0 = float32,
// 1 = bfloat16); out [n, h] in x_dtype, rstd [n] float32. h a multiple of
// 128, at most 16384. Returns the CUDA error code of the launch (0 on
// success; cudaErrorInvalidValue for a shape or dtype it does not take).
extern "C" int rms_norm_fwd(const void* x, const void* w, void* out,
                            void* rstd, int n, int h, float eps, int x_dtype,
                            int w_dtype, void* stream) {
  if (bad_shape(n, h)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_dtype == ptt::kFloat32 && w_dtype == ptt::kFloat32)
    return fwd_cols<float, float>(x, w, out, rstd, n, h, eps, s);
  if (x_dtype == ptt::kFloat32 && w_dtype == ptt::kBFloat16)
    return fwd_cols<float, bf16>(x, w, out, rstd, n, h, eps, s);
  if (x_dtype == ptt::kBFloat16 && w_dtype == ptt::kFloat32)
    return fwd_cols<bf16, float>(x, w, out, rstd, n, h, eps, s);
  if (x_dtype == ptt::kBFloat16 && w_dtype == ptt::kBFloat16)
    return fwd_cols<bf16, bf16>(x, w, out, rstd, n, h, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward from the forward's rstd: g [n, h] in x_dtype; dx [n, h] in
// x_dtype; partial float32 [ceil(n / rows), h] scratch; dw [h] in w_dtype.
// Each block of the first kernel takes `rows` rows. Returns the CUDA error
// code of the launches.
extern "C" int rms_norm_bwd(const void* x, const void* w, const void* rstd,
                            const void* g, void* dx, void* partial, void* dw,
                            int n, int h, int rows, int x_dtype, int w_dtype,
                            void* stream) {
  if (bad_shape(n, h) || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_dtype == ptt::kFloat32 && w_dtype == ptt::kFloat32)
    return bwd_cols<float, float>(x, w, rstd, g, dx, partial, dw, n, h, rows,
                                  s);
  if (x_dtype == ptt::kFloat32 && w_dtype == ptt::kBFloat16)
    return bwd_cols<float, bf16>(x, w, rstd, g, dx, partial, dw, n, h, rows,
                                 s);
  if (x_dtype == ptt::kBFloat16 && w_dtype == ptt::kFloat32)
    return bwd_cols<bf16, float>(x, w, rstd, g, dx, partial, dw, n, h, rows,
                                 s);
  if (x_dtype == ptt::kBFloat16 && w_dtype == ptt::kBFloat16)
    return bwd_cols<bf16, bf16>(x, w, rstd, g, dx, partial, dw, n, h, rows,
                                s);
  return static_cast<int>(cudaErrorInvalidValue);
}
