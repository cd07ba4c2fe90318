// Rotary position embedding (rotate-half pairing) and the causal
// (upper-triangle masked) softmax, forward and backward.
//
// Replaces: paddle_tpu/kernels/pallas/fused_elementwise.py, `_rope_kernel`
// (the pallas_call of `_rope_core`, line 71; one kernel serves both
// directions there too), `_smut_kernel` (`_smut_fwd_core`, line 154) and
// `_smut_bwd_kernel` (`_smut_bwd_core`, line 168).
//
// RoPE. x [B, S, H, D] with D a multiple of 128, tables cos and sin
// float32 [S, D] (row s, read in place; a one-row table has row stride 0).
// A thread owns the pairs (d, d + D/2) for one 16-byte vector of d in the
// first half, so it reads x and the tables once and needs no roll (the TPU
// kernel's roll(x * t, D/2) is a Mosaic workaround for a lane concat):
//   forward   o1 = x1 c1 - x2 s1,  o2 = x2 c2 + x1 s2
//   backward  dx1 = g1 c1 + g2 s2, dx2 = g2 c2 - g1 s1
// in float32, each product and sum rounded on its own (__fmul_rn,
// __fadd_rn), so the result has the plain PyTorch version's bits. The
// halves of a table may differ (c1 != c2); nothing assumes they match.
//
// Causal softmax. x [N, S, S], row r of each matrix keeps the columns
// c <= r. One block per row reads only those columns: a first pass keeps a
// running maximum and sum per thread (rescaled when the maximum grows),
// the block combines them, and a second pass writes exp(x - m) / l there
// and zeros beyond, so a row longer than the block keeps on chip is still
// right and whatever the masked half holds (NaN included) never matters.
// The backward, from the saved output p: dx = p (g - sum(p g)), the sum
// and the output over c <= r only, zeros beyond; a NaN in g's masked half
// (which the TPU kernel multiplies by p = 0) does not reach dx.
//
// What bounds them on the H100: bytes. RoPE reads x and writes the output
// once (the tables are S x D float32 and stay in L2). The softmax forward
// reads the live half of x and writes all of p; the backward reads the
// live halves of p and g and writes all of dx. The second pass over a row
// re-reads what the first just read, from L1 or L2.

#include "rowwise.cuh"

namespace {

using ptt::rowwise::block_max;
using ptt::rowwise::block_sum;
using ptt::rowwise::load;
using ptt::rowwise::store;
using ptt::rowwise::store_zeros;
using ptt::rowwise::vec_elems;

constexpr int kRopeThreads = 256;
constexpr int kMaxThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kRopeThreads)
    rope_kernel(const T* __restrict__ x, const float* __restrict__ cos_t,
                const float* __restrict__ sin_t, T* __restrict__ out,
                long long total, int S, int H, int D, long long table_stride,
                int backward) {
  constexpr int E = vec_elems<T>();
  const int half = D / 2;
  const int nvh = half / E;  // vectors in each half of a head
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int j = static_cast<int>(i % nvh);
    const long long head = i / nvh;        // (b * S + s) * H + h
    const int s = static_cast<int>((head / H) % S);
    const long long base = head * D + static_cast<long long>(j) * E;
    const float* ct = cos_t + s * table_stride + j * E;
    const float* st = sin_t + s * table_stride + j * E;
    float x1[E], x2[E], c1[E], c2[E], s1[E], s2[E], o1[E], o2[E];
    load<T, E>(x + base, x1);
    load<T, E>(x + base + half, x2);
    load<float, E>(ct, c1);
    load<float, E>(ct + half, c2);
    load<float, E>(st, s1);
    load<float, E>(st + half, s2);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (backward) {
        o1[e] = __fadd_rn(__fmul_rn(x1[e], c1[e]), __fmul_rn(x2[e], s2[e]));
        o2[e] = __fsub_rn(__fmul_rn(x2[e], c2[e]), __fmul_rn(x1[e], s1[e]));
      } else {
        o1[e] = __fsub_rn(__fmul_rn(x1[e], c1[e]), __fmul_rn(x2[e], s1[e]));
        o2[e] = __fadd_rn(__fmul_rn(x2[e], c2[e]), __fmul_rn(x1[e], s2[e]));
      }
    }
    store<T, E>(out + base, o1);
    store<T, E>(out + base + half, o2);
  }
}

// One block per row of [N * S, S]; row r = blockIdx.x % S keeps c <= r.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    causal_softmax_fwd_kernel(const T* __restrict__ x, T* __restrict__ p,
                              int S) {
  constexpr int E = vec_elems<T>();
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const int r = static_cast<int>(row % S);
  const T* xr = x + row * S;
  T* pr = p + row * S;
  const int live = r / E + 1;  // vectors holding a column <= r
  const int nvec = S / E;
  float m = -INFINITY, l = 0.f;
  for (int v = threadIdx.x; v < live; v += blockDim.x) {
    float f[E];
    load<T, E>(xr + v * E, f);
    float vm = -INFINITY;
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (v * E + e <= r) vm = fmaxf(vm, f[e]);
    if (vm > m) {
      l *= expf(m - vm);
      m = vm;
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (v * E + e <= r) l += expf(f[e] - m);
  }
  const float bm = block_max(m, red);
  // a thread that saw no column has m = -inf and l = 0 and adds nothing;
  // a NaN in its l still reaches the sum
  const float bl = block_sum(
      m == -INFINITY && l == 0.f ? 0.f : l * expf(m - bm), red);
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    if (v < live) {
      float f[E];
      load<T, E>(xr + v * E, f);
#pragma unroll
      for (int e = 0; e < E; ++e)
        f[e] = v * E + e <= r ? __fdiv_rn(expf(f[e] - bm), bl) : 0.f;
      store<T, E>(pr + v * E, f);
    } else {
      store_zeros<T, E>(pr + v * E);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    causal_softmax_bwd_kernel(const T* __restrict__ p,
                              const T* __restrict__ g, T* __restrict__ dx,
                              int S) {
  constexpr int E = vec_elems<T>();
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const int r = static_cast<int>(row % S);
  const long long off = row * S;
  const int live = r / E + 1;
  const int nvec = S / E;
  float dot = 0.f;
  for (int v = threadIdx.x; v < live; v += blockDim.x) {
    float pf[E], gf[E];
    load<T, E>(p + off + v * E, pf);
    load<T, E>(g + off + v * E, gf);
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (v * E + e <= r) dot += pf[e] * gf[e];
  }
  dot = block_sum(dot, red);
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    if (v < live) {
      float pf[E], gf[E];
      load<T, E>(p + off + v * E, pf);
      load<T, E>(g + off + v * E, gf);
#pragma unroll
      for (int e = 0; e < E; ++e)
        pf[e] = v * E + e <= r ? __fmul_rn(pf[e], __fsub_rn(gf[e], dot))
                               : 0.f;
      store<T, E>(dx + off + v * E, pf);
    } else {
      store_zeros<T, E>(dx + off + v * E);
    }
  }
}

// threads for a row of S columns: a multiple of 32, at most kMaxThreads
int softmax_threads(int S, int elems) {
  const int nvec = S / elems;
  const int t = ((nvec + 31) / 32) * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

template <typename T>
int rope_launch(const void* x, const void* cos_t, const void* sin_t,
                void* out, long long total, int S, int H, int D,
                long long table_stride, int backward, cudaStream_t stream) {
  const long long want = (total + kRopeThreads - 1) / kRopeThreads;
  const int blocks = static_cast<int>(want < (1LL << 30) ? want : 1LL << 30);
  rope_kernel<T><<<blocks, kRopeThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<T*>(out), total, S, H, D,
      table_stride, backward);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x and out [B, S, H, D] contiguous in `dtype` (0 = float32,
// 1 = bfloat16), D a multiple of 128; cos_t and sin_t float32 with rows of
// D, row s at s * table_stride (D, or 0 for a one-row table). backward = 1
// applies the transpose (the gradient of x). Returns the CUDA error code
// of the launch (0 on success).
extern "C" int rope_apply(const void* x, const void* cos_t,
                          const void* sin_t, void* out, int B, int S, int H,
                          int D, long long table_stride, int backward,
                          int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || D < 128 || D % 128 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long heads = static_cast<long long>(B) * S * H;
  if (dtype == ptt::kFloat32)
    return rope_launch<float>(x, cos_t, sin_t, out,
                              heads * (D / 2 / vec_elems<float>()), S, H, D,
                              table_stride, backward, s);
  if (dtype == ptt::kBFloat16)
    return rope_launch<__nv_bfloat16>(
        x, cos_t, sin_t, out, heads * (D / 2 / vec_elems<__nv_bfloat16>()),
        S, H, D, table_stride, backward, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x and p [N, S, S] contiguous in `dtype`, S a multiple of 128. Returns
// the CUDA error code of the launch.
extern "C" int causal_softmax_fwd(const void* x, void* p, int N, int S,
                                  int dtype, void* stream) {
  if (N < 1 || S < 128 || S % 128 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(N) * S;
  if (rows >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == ptt::kFloat32) {
    causal_softmax_fwd_kernel<float>
        <<<static_cast<unsigned>(rows), softmax_threads(S, 4), 0, s>>>(
            static_cast<const float*>(x), static_cast<float*>(p), S);
  } else if (dtype == ptt::kBFloat16) {
    causal_softmax_fwd_kernel<__nv_bfloat16>
        <<<static_cast<unsigned>(rows), softmax_threads(S, 8), 0, s>>>(
            static_cast<const __nv_bfloat16*>(x),
            static_cast<__nv_bfloat16*>(p), S);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// From the forward's output p and the gradient g (both [N, S, S] in
// `dtype`): dx [N, S, S]. Returns the CUDA error code of the launch.
extern "C" int causal_softmax_bwd(const void* p, const void* g, void* dx,
                                  int N, int S, int dtype, void* stream) {
  if (N < 1 || S < 128 || S % 128 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(N) * S;
  if (rows >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == ptt::kFloat32) {
    causal_softmax_bwd_kernel<float>
        <<<static_cast<unsigned>(rows), softmax_threads(S, 4), 0, s>>>(
            static_cast<const float*>(p), static_cast<const float*>(g),
            static_cast<float*>(dx), S);
  } else if (dtype == ptt::kBFloat16) {
    causal_softmax_bwd_kernel<__nv_bfloat16>
        <<<static_cast<unsigned>(rows), softmax_threads(S, 8), 0, s>>>(
            static_cast<const __nv_bfloat16*>(p),
            static_cast<const __nv_bfloat16*>(g),
            static_cast<__nv_bfloat16*>(dx), S);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
