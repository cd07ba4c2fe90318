// FlashMask attention: forward, dq and dk/dv on [B, S, H, D] with a start
// row per column: row r sees column c iff r < start[b, h, c] (and r >= c
// when causal), the compact encoding PaddleNLP's FlashMask uses for
// document and causal hybrid masks.
//
// Replaces: paddle_tpu/kernels/pallas/flash_sparse_mask.py, `_fwd_kernel`
// (pallas_call at line 185), `_dq_kernel` (line 225) and `_dkv_kernel`
// (line 245). The tile bodies are csrc/flash_masked.cuh with StartRowMask.
//
// The TPU kernels walk every (q block, kv block) pair and skip a dead one
// with pl.when: above the causal diagonal, or when the q block's first row
// is at or past the kv block's largest start. Here a q tile's key loop
// stops at the diagonal and skips a 32-key tile whose largest start
// (tile_max, computed on the device by kernels/flash_sparse_mask.py) is at
// or before the q tile's first row, reading one int for it; a k tile's
// q-row loop runs from its diagonal to its largest start. With documents
// encoded as start rows (column c of a document ending at e gets start e)
// that visits each document's own tiles only, as flash_varlen.cu does.
//
// q, k, v and dO are read in place from [B, S, H, D] with their strides (D
// contiguous): no [B*H, S, D] copy as the TPU wrapper's swapaxes makes.
// Any S works: tail rows and keys load as 0 and are never written.
//
// What bounds it on the H100: as flash_varlen.cu, about 4 D flops per live
// pair and head forward and 10 D backward, so by operations at the
// tensor-core peak for documents of some hundreds of tokens. The forward
// takes the route the caller names, as flash_varlen.cu's: the tensor-core
// `masked_fwd_wgmma` (bf16, D 64 and 128; a 64-key tile is skipped when
// both of its 32-column tile_max entries are at or before the q tile's
// first row) or the CUDA-core `masked_fwd_kernel`. The backward's two
// routes are flash_varlen.cu's: the tensor-core pair `masked_dq_wgmma` +
// `masked_dkv_wgmma` (the dq kernel skips dead 64-key tiles as the forward
// does; the dk/dv kernel's 64-row tiles run from the k tile's diagonal to
// its largest start) or the CUDA-core pair.

#include "flash_masked.cuh"

using ptt::masked::Operand;
using ptt::masked::Params;
using ptt::masked::StartRowMask;

namespace {

Params make_params(const void* q, const void* k, const void* v, int B,
                   int H, int S, const long long* qs, const long long* ks,
                   const long long* vs, float scale) {
  Params p{};
  p.q = Operand{q, qs[0], qs[1], qs[2]};
  p.k = Operand{k, ks[0], ks[1], ks[2]};
  p.v = Operand{v, vs[0], vs[1], vs[2]};
  p.B = B;
  p.H = H;
  p.Sq = S;
  p.Sk = S;
  p.scale = scale;
  return p;
}

}  // namespace

// q, k, v [B, S, H, hd], strided ((b, s, h) strides in elements, hd
// contiguous), one dtype (0 = float32, 1 = bfloat16); o [B, S, H, hd]
// contiguous; lse [B*H, S] float32; start int32 [B*H, S]; tile_max int32
// [B*H, ceil(S / 32)], the largest start of each 32 columns. route: 0 the
// CUDA-core kernel, 1 the tensor-core kernel (bf16, hd 64 or 128, q, k, v
// 16-byte aligned with strides a multiple of 8). Returns the CUDA error
// code of the launch (0 on success); cudaErrorInvalidValue for inputs the
// route does not take.
extern "C" int flash_sparse_mask_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* start, const void* tile_max, int B, int H, int S, int hd,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, float scale, int causal, int dtype, int route,
    void* stream) {
  const long long qs[3] = {q_sb, q_ss, q_sh}, ks[3] = {k_sb, k_ss, k_sh},
                  vs[3] = {v_sb, v_ss, v_sh};
  Params p = make_params(q, k, v, B, H, S, qs, ks, vs, scale);
  p.o = o;
  p.lse = static_cast<float*>(lse);
  const StartRowMask m{static_cast<const int*>(start),
                       static_cast<const int*>(tile_max), S,
                       (S + ptt::masked::kTile - 1) / ptt::masked::kTile,
                       causal};
  return ptt::masked::run_fwd(dtype, hd, route, p, m, (cudaStream_t)stream);
}

// The backward from the forward's lse and delta = rowsum(dO * O) (float32
// [B*H, S], computed by the caller): dq, dk, dv [B, S, H, hd] contiguous
// in the inputs' dtype; dout strided like q. route: 0 the CUDA-core pair,
// 1 the tensor-core pair (bf16, hd 64 or 128, q, k, v and dout 16-byte
// aligned with strides a multiple of 8). Launches the dq kernel, then the
// dk/dv kernel, on `stream`; returns the CUDA error code
// (cudaErrorInvalidValue for inputs the route does not take).
extern "C" int flash_sparse_mask_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    const void* start, const void* tile_max, int B, int H, int S, int hd,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long do_sb, long long do_ss, long long do_sh,
    float scale, int causal, int dtype, int route, void* stream) {
  const long long qs[3] = {q_sb, q_ss, q_sh}, ks[3] = {k_sb, k_ss, k_sh},
                  vs[3] = {v_sb, v_ss, v_sh};
  Params p = make_params(q, k, v, B, H, S, qs, ks, vs, scale);
  p.dout = Operand{dout, do_sb, do_ss, do_sh};
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  const StartRowMask m{static_cast<const int*>(start),
                       static_cast<const int*>(tile_max), S,
                       (S + ptt::masked::kTile - 1) / ptt::masked::kTile,
                       causal};
  return ptt::masked::run_bwd(dtype, hd, route, p, m,
                              (cudaStream_t)stream);
}
