// Ragged paged attention over an int8 KV pool: one decode query per slot
// against its pages of int8 codes and one float32 scale per token row.
//
// Replaces: paddle_tpu/kernels/pallas/ragged_paged_attention.py, `_qkernel`
// launched by `_ragged_quant_call` (the pallas_call at line 506).
//
// The kernel is the shared body of csrc/ragged_decode.cuh (`ragged_decode`
// under the Int8KV policy): the stage's row scales come through the
// cp.async ring with its codes, the codes are widened to float32 after the
// shared-memory read, and the row scale multiplies the finished q.k dot
// (and p before p.v). A live token costs 2 * (hd + 4 / nkv) bytes per kv
// head, about half of the bf16 pool's. Neither a code, nor a scale, nor a
// table entry past seq_lens[s] is ever read: the TPU kernel reads the live
// block whole and masks the scores, so a NaN scale stored past seq_lens
// inside the live block reaches its output as 0 x NaN (ROADMAP queue 3);
// here it cannot.

#include "ragged_decode.cuh"

namespace {

using ptt::ragged::Args;
using ptt::ragged::Int8KV;
using ptt::ragged::run;

int dispatch(int hd, int nrep, int dtype, const Args& a, bool cluster_only) {
  if (dtype == ptt::kFloat32)
    return run<float, Int8KV>(hd, nrep, a, cluster_only);
  if (dtype == ptt::kBFloat16)
    return run<__nv_bfloat16, Int8KV>(hd, nrep, a, cluster_only);
  return -(int)cudaErrorInvalidValue;
}

}  // namespace

// q [S, nh, hd] (dtype 0 = float32, 1 = bfloat16; out alike); kcodes /
// vcodes [num_blocks, bs, nkv, hd] int8 (16-byte aligned) and kscale /
// vscale [num_blocks, bs] float32 (one layer); tables [S, mb] int32;
// seq_lens [S] int32. All contiguous. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int ragged_paged_attention_quant_fwd(
    const void* q, const void* kcodes, const void* kscale, const void* vcodes,
    const void* vscale, const void* tables, const void* seq_lens, void* out,
    int S, int nh, int nkv, int hd, int bs, int mb, float scale, int dtype,
    void* stream) {
  if (S <= 0 || nkv <= 0 || nh % nkv != 0 || bs <= 0 || mb <= 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q, kcodes, vcodes, (const float*)kscale, (const float*)vscale,
               (const int*)tables, (const int*)seq_lens, out, nullptr, S,
               nkv, bs, mb, mb, 1, scale, (cudaStream_t)stream};
  const int r = dispatch(hd, nh / nkv, dtype, a, false);
  return r < 0 ? -r : 0;
}

// The cluster size a launch of these shapes takes (1-8), or minus a CUDA
// error code. Launches nothing.
extern "C" int ragged_paged_attention_quant_cluster(int S, int nh, int nkv,
                                                    int hd, int dtype) {
  if (S <= 0 || nkv <= 0 || nh % nkv != 0) return -(int)cudaErrorInvalidValue;
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, nullptr, nullptr, S, nkv, 1, 1, 1, 1, 1.f, nullptr};
  return dispatch(hd, nh / nkv, dtype, a, true);
}
