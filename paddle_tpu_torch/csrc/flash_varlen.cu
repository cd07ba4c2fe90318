// Packed (varlen) flash attention: forward, dq and dk/dv on [total, H, D]
// tokens whose documents are given by segment ids and local positions.
//
// Replaces: paddle_tpu/kernels/pallas/flash_varlen.py, `_fwd_kernel`
// (pallas_call at line 222), `_dq_kernel` (line 284) and `_dkv_kernel`
// (line 313). The tile bodies are csrc/flash_masked.cuh with SegmentMask.
//
// A pair (r, c) is live iff seg_q[r] == seg_k[c], and when causal also
// pos_q[r] >= pos_k[c]: causality compares positions inside a document,
// so unequal q and k packs (cross attention) stay right. The TPU kernels
// walk every (q block, kv block) pair and skip those whose segment ranges
// cannot overlap; here each q tile visits only the keys of its own
// documents (and, when causal, none past its last row's position), and
// each k tile only the q rows of its documents, from ranges that
// kernels/flash_varlen.py computes on the device from the segment ids. So
// the work follows the pairs the mask keeps, sum over documents of L^2
// (about L^2 / 2 causal), not total^2.
//
// Totals need not divide any tile: tail rows and keys load as 0, are
// masked out and never written. q, k, v and dO are read in place from
// [total, H, D] with their token and head strides (D contiguous), so a
// slice of a packed qkv tensor or autograd's strided dO needs no copy.
//
// What bounds it on the H100: about 4 D flops per live pair and head in
// the forward (10 D in the backward's five products) on 4 (8) bf16
// [total, H, D] tensors: at documents of some hundreds of tokens and more,
// bound by operations at the tensor-core peak. The forward has two
// kernels, and the caller names the route: for bf16 at D 64 and 128 with
// 16-byte aligned rows, `masked_fwd_wgmma` on the tensor cores (64-key
// tiles, P as bf16 hi + lo, the NaN guard of flash_masked.cuh); for
// float32 and D 256, `masked_fwd_kernel` on the CUDA cores in float32.
// The backward takes the route the caller names the same way: the
// tensor-core pair `masked_dq_wgmma` + `masked_dkv_wgmma` (bf16 at D 64
// and 128 with dO aligned too; P and dS as bf16 hi + lo, the NaN guard on
// K in dq and on Q and dO in dk/dv) or the CUDA-core pair
// `masked_dq_kernel` + `masked_dkv_kernel` (float32, D 256).

#include "flash_masked.cuh"

using ptt::masked::Operand;
using ptt::masked::Params;
using ptt::masked::SegmentMask;

namespace {

Params make_params(const void* q, const void* k, const void* v, int H,
                   int tq, int tk, long long q_ss, long long q_sh,
                   long long k_ss, long long k_sh, long long v_ss,
                   long long v_sh, float scale) {
  Params p{};
  p.q = Operand{q, 0, q_ss, q_sh};
  p.k = Operand{k, 0, k_ss, k_sh};
  p.v = Operand{v, 0, v_ss, v_sh};
  p.B = 1;
  p.H = H;
  p.Sq = tq;
  p.Sk = tk;
  p.scale = scale;
  return p;
}

}  // namespace

// q [tq, H, hd], k and v [tk, H, hd], strided (token and head strides in
// elements, hd contiguous), one dtype (0 = float32, 1 = bfloat16); o
// [tq, H, hd] contiguous; lse [H, tq] float32. seg/pos int32 [tq] and
// [tk]; q_ranges int32 [n_q_ranges, 2], the keys [lo, hi) of each 64-row
// q tile (n_q_ranges must be ceil(tq / 64)). route: 0 the CUDA-core
// kernel, 1 the tensor-core kernel (bf16, hd 64 or 128, q, k, v 16-byte
// aligned with strides a multiple of 8). Returns the CUDA error code of the
// launch (0 on success); cudaErrorInvalidValue for inputs the route does
// not take.
extern "C" int flash_varlen_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* seg_q, const void* pos_q, const void* seg_k,
    const void* pos_k, const void* q_ranges, int n_q_ranges, int H, int tq,
    int tk, int hd, long long q_ss, long long q_sh, long long k_ss,
    long long k_sh, long long v_ss, long long v_sh, float scale,
    int causal, int dtype, int route, void* stream) {
  if (tq <= 0 || n_q_ranges != (tq + ptt::masked::kBQ - 1) / ptt::masked::kBQ)
    return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, H, tq, tk, q_ss, q_sh, k_ss, k_sh, v_ss,
                         v_sh, scale);
  p.o = o;
  p.lse = static_cast<float*>(lse);
  const SegmentMask m{static_cast<const int*>(seg_q),
                      static_cast<const int*>(pos_q),
                      static_cast<const int*>(seg_k),
                      static_cast<const int*>(pos_k),
                      static_cast<const int2*>(q_ranges), nullptr, causal};
  return ptt::masked::run_fwd(dtype, hd, route, p, m, (cudaStream_t)stream);
}

// The backward from the forward's lse and delta = rowsum(dO * O) (float32
// [H, tq], computed by the caller): dq [tq, H, hd], dk and dv [tk, H, hd],
// contiguous, in the inputs' dtype. dout is strided like q. k_ranges int32
// [n_k_ranges, 2] holds the q rows [lo, hi) of each k tile of the dk/dv
// kernel (64 keys, 32 at hd 256; n_k_ranges must match). route: 0 the
// CUDA-core pair, 1 the tensor-core pair (bf16, hd 64 or 128, q, k, v and
// dout 16-byte aligned with strides a multiple of 8). Launches the dq
// kernel, then the dk/dv kernel, on `stream`; returns the CUDA error code
// (cudaErrorInvalidValue for inputs the route does not take).
extern "C" int flash_varlen_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    const void* seg_q, const void* pos_q, const void* seg_k,
    const void* pos_k, const void* q_ranges, int n_q_ranges,
    const void* k_ranges, int n_k_ranges, int H, int tq, int tk, int hd,
    long long q_ss, long long q_sh, long long k_ss, long long k_sh,
    long long v_ss, long long v_sh, long long do_ss, long long do_sh,
    float scale, int causal, int dtype, int route, void* stream) {
  if (tq <= 0 || tk <= 0 ||
      n_q_ranges != (tq + ptt::masked::kBQ - 1) / ptt::masked::kBQ ||
      n_k_ranges != ptt::masked::dkv_tiles(hd, tk))
    return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, H, tq, tk, q_ss, q_sh, k_ss, k_sh, v_ss,
                         v_sh, scale);
  p.dout = Operand{dout, 0, do_ss, do_sh};
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  const SegmentMask m{static_cast<const int*>(seg_q),
                      static_cast<const int*>(pos_q),
                      static_cast<const int*>(seg_k),
                      static_cast<const int*>(pos_k),
                      static_cast<const int2*>(q_ranges),
                      static_cast<const int2*>(k_ranges), causal};
  return ptt::masked::run_bwd(dtype, hd, route, p, m,
                              (cudaStream_t)stream);
}
