// Split-context ragged paged attention: every shard of each slot's block
// table gives its online-softmax partial (o normalised within the shard,
// and lse), to be merged by the lse rescale.
//
// Replaces: paddle_tpu/kernels/pallas/ragged_paged_attention.py, `_pkernel`
// launched by `_ragged_partials_call` (the pallas_call at line 310).
//
// Computes, for shard z (pool blocks lo = z * spb .. hi = min(lo + spb, mb)
// of the table), slot s and query head h (kv group g = h / nrep), over the
// shard's live tokens t = lo * bs .. min(seq_lens[s], hi * bs - 1):
//   l = sum_t exp(x_t - m),  x_t = q[s, h] . K[t] * scale,  m = max_t x_t
//   o[z, s, h] = (sum_t exp(x_t - m) V[t]) / max(l, 1e-30)    (float32)
//   lse[z, s, h] = m + log(max(l, 1e-30))
// A shard with no live token writes o = 0 and lse = -1e30 (+ log 1e-30,
// which float32 absorbs), so its merge weight exp(lse - max lse) is
// exactly 0.
//
// The kernel is the shared body of csrc/ragged_decode.cuh (`ragged_decode`
// under the RowsKV pool policy and the ShardPartials output policy): the
// shard is the outer unit of the grid, each shard's window split over a
// thread-block cluster, rows streamed through a cp.async ring, float32
// arithmetic on the CUDA cores, the cluster's partial softmax states merged
// in distributed shared memory. All shards go in one launch (split-KV
// decoding); the TPU ran one launch per shard. Its note says what bounds
// it (device-memory bytes) and why it is laid out so. The merge of the
// shards (a [shards, S, nh] max and weighted sum) is left to PyTorch, as
// the JAX package leaves it to jnp.

#include "ragged_decode.cuh"

namespace {

using ptt::ragged::Args;
using ptt::ragged::RowsKV;
using ptt::ragged::ShardPartials;
using ptt::ragged::run;

int dispatch(int hd, int nrep, int dtype, const Args& a, bool cluster_only) {
  if (dtype == ptt::kFloat32)
    return run<float, RowsKV<float>, ShardPartials>(hd, nrep, a,
                                                    cluster_only);
  if (dtype == ptt::kBFloat16)
    return run<__nv_bfloat16, RowsKV<__nv_bfloat16>, ShardPartials>(
        hd, nrep, a, cluster_only);
  return -(int)cudaErrorInvalidValue;
}

bool bad_shape(int S, int nh, int nkv, int shards) {
  return S <= 0 || nkv <= 0 || nh % nkv != 0 || shards <= 0 ||
         shards > 65535;
}

}  // namespace

// q [S, nh, hd]; kpool/vpool [num_blocks, bs, nkv, hd] (one layer, 16-byte
// aligned), of one dtype (0 = float32, 1 = bfloat16); tables [S, mb] int32;
// seq_lens [S] int32 (global positions); shards = ceil(mb / spb) shards of
// spb blocks. Writes o [shards, S, nh, hd] and lse [shards, S, nh], both
// float32. All contiguous. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int ragged_paged_attention_partials_fwd(
    const void* q, const void* kpool, const void* vpool, const void* tables,
    const void* seq_lens, void* o, void* lse, int S, int nh, int nkv, int hd,
    int bs, int mb, int spb, int shards, float scale, int dtype,
    void* stream) {
  if (bad_shape(S, nh, nkv, shards) || bs <= 0 || mb <= 0 || spb <= 0 ||
      (shards - 1) * spb >= mb || shards * spb < mb)
    return (int)cudaErrorInvalidValue;
  const Args a{q, kpool, vpool, nullptr, nullptr, (const int*)tables,
               (const int*)seq_lens, o, (float*)lse, S, nkv, bs, mb, spb,
               shards, scale, (cudaStream_t)stream};
  const int r = dispatch(hd, nh / nkv, dtype, a, false);
  return r < 0 ? -r : 0;
}

// The cluster size (1-8) a launch of these shapes takes: the largest whose
// S * nkv * shards clusters all fit at once. Or minus a CUDA error code.
// Launches nothing.
extern "C" int ragged_paged_attention_partials_cluster(int S, int nh,
                                                       int nkv, int hd,
                                                       int shards,
                                                       int dtype) {
  if (bad_shape(S, nh, nkv, shards)) return -(int)cudaErrorInvalidValue;
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, nullptr, nullptr, S, nkv, 1, shards, 1, shards,
               1.f, nullptr};
  return dispatch(hd, nh / nkv, dtype, a, true);
}
