// Ragged paged attention over a pool of float32 or bf16 rows: one decode
// query per slot against its KV pages.
//
// Replaces: paddle_tpu/kernels/pallas/ragged_paged_attention.py, `_kernel`
// launched by `_ragged_call` (the pallas_call at line 170).
//
// The kernel is the shared body of csrc/ragged_decode.cuh (`ragged_decode`
// under the RowsKV policy): each slot's window split over a thread-block
// cluster, rows streamed through a cp.async ring, float32 arithmetic on
// the CUDA cores, the partial softmax states merged in distributed shared
// memory. Its note says what bounds it and why it is laid out so.

#include "ragged_decode.cuh"

namespace {

using ptt::ragged::Args;
using ptt::ragged::RowsKV;
using ptt::ragged::run;

int dispatch(int hd, int nrep, int dtype, const Args& a, bool cluster_only) {
  if (dtype == ptt::kFloat32)
    return run<float, RowsKV<float>>(hd, nrep, a, cluster_only);
  if (dtype == ptt::kBFloat16)
    return run<__nv_bfloat16, RowsKV<__nv_bfloat16>>(hd, nrep, a,
                                                     cluster_only);
  return -(int)cudaErrorInvalidValue;
}

}  // namespace

// q [S, nh, hd]; kpool/vpool [num_blocks, bs, nkv, hd] (one layer, 16-byte
// aligned); tables [S, mb] int32; seq_lens [S] int32; out [S, nh, hd]. All
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
  const Args a{q, kpool, vpool, nullptr, nullptr, (const int*)tables,
               (const int*)seq_lens, out, nullptr, S, nkv, bs, mb, mb, 1,
               scale, (cudaStream_t)stream};
  const int r = dispatch(hd, nh / nkv, dtype, a, false);
  return r < 0 ? -r : 0;
}

// The cluster size a launch of these shapes takes (1-8), or minus a CUDA
// error code. Launches nothing.
extern "C" int ragged_paged_attention_cluster(int S, int nh, int nkv, int hd,
                                              int dtype) {
  if (S <= 0 || nkv <= 0 || nh % nkv != 0) return -(int)cudaErrorInvalidValue;
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, nullptr, nullptr, S, nkv, 1, 1, 1, 1, 1.f, nullptr};
  return dispatch(hd, nh / nkv, dtype, a, true);
}
