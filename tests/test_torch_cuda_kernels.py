"""The port's CUDA kernels against their plain PyTorch versions, on a card.

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips without a card. This file imports neither JAX nor the JAX package,
so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest

Tolerances: float32 1e-4 (summation order only); bf16 2e-2 (both sides
compute in float32 from the same bf16 inputs and round the output to
bf16). The backward's gradients are held element by element to
|out - ref| <= rtol |ref| + atol * max|ref|: rtol 0 and atol 1e-4 in
float32; rtol 2^-7 (one bf16 ulp) and atol 1e-3 in bf16, where the float32
sums both sides round differ in summation order over S terms whose
cancellation (dp - delta) leaves small elements with a larger relative
error.
"""
import ctypes

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels.flash_attention import (
    _flash_bhsd, _flash_bhsd_bwd, flash_attention_bwd_plain,
    flash_attention_fwd_plain)
from paddle_tpu_torch.nn.functional.flash_attention import (
    flash_attention, scaled_dot_product_attention)
from paddle_tpu_torch.kernels.flash_sparse_mask import (
    flash_sparse_mask_bwd, flash_sparse_mask_bwd_plain, flash_sparse_mask_fwd,
    flash_sparse_mask_fwd_plain)
from paddle_tpu_torch.kernels.flash_varlen import (
    KEYLESS_LSE, flash_varlen_bwd, flash_varlen_bwd_plain, flash_varlen_fwd,
    flash_varlen_fwd_plain, segments_from_cu)
from paddle_tpu_torch.nn.functional import (flash_attention_with_sparse_mask,
                                            flash_attn_unpadded,
                                            flash_attn_varlen_qkvpacked)
from paddle_tpu_torch.kernels import grouped_matmul as gmm_mod
from paddle_tpu_torch.kernels.grouped_matmul import (
    _ref_dw, _ref_fwd, gm_dw_route, gm_route, grouped_matmul,
    grouped_matmul_dw,
    grouped_matmul_fwd, grouped_metadata)
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import quant_matmul as qmm_mod
from paddle_tpu_torch.kernels.quant_matmul import (
    _launch, quant_grouped_matmul, quant_grouped_matmul_plain, quant_matmul,
    quant_matmul_plain, quantize_weight_blockwise)
from paddle_tpu_torch.kernels.fused_elementwise import (
    causal_softmax_bwd, causal_softmax_bwd_plain, causal_softmax_fwd,
    causal_softmax_fwd_plain, rope, rope_plain)
from paddle_tpu_torch.kernels.rms_norm import (
    rms_norm_bwd, rms_norm_bwd_plain, rms_norm_fwd, rms_norm_fwd_plain)
from paddle_tpu_torch.incubate import softmax_mask_fuse_upper_triangle
from paddle_tpu_torch.incubate.nn.functional import (
    fused_rms_norm, fused_rotary_position_embedding)
from paddle_tpu_torch.models.decode import CachedDecoder
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models.paged_decode import PagedDecoder
from paddle_tpu_torch.kernels.ragged_paged_attention import (
    decode_cluster_size, kv_quantize_rows, merge_partials,
    partials_cluster_size, ragged_paged_attention,
    ragged_paged_attention_partials,
    ragged_paged_attention_partials_plain, ragged_paged_attention_plain,
    ragged_paged_attention_quant, ragged_paged_attention_quant_plain)

TOLS = ((torch.float32, 1e-4), (torch.bfloat16, 2e-2))


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _ragged_inputs(dev, seed, nh, nkv, hd, bs, mb, lens):
    rng = np.random.default_rng(seed)
    S = len(lens)
    nb = S * mb + 1
    kp = torch.from_numpy(rng.standard_normal((nb, bs, nkv, hd))
                          .astype(np.float32)).to(dev)
    vp = torch.from_numpy(rng.standard_normal((nb, bs, nkv, hd))
                          .astype(np.float32)).to(dev)
    q = torch.from_numpy(rng.standard_normal((S, nh, hd))
                         .astype(np.float32)).to(dev)
    tables = torch.from_numpy((rng.permutation(nb - 1)[:S * mb] + 1)
                              .reshape(S, mb).astype(np.int32)).to(dev)
    return q, kp, vp, tables, torch.tensor(lens, dtype=torch.int32,
                                           device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("nh,nkv,hd", [(32, 32, 128), (32, 8, 128),
                                       (8, 1, 64), (16, 4, 256)])
def test_ragged_kernel_matches_plain(cuda_device, nh, nkv, hd):
    bs, mb = 16, 8
    lens = [0, bs - 1, bs, 77, mb * bs - 1]
    q, kp, vp, tables, seq = _ragged_inputs(cuda_device, nh + hd, nh, nkv,
                                            hd, bs, mb, lens)
    before = ragged_paged_attention.launches
    for dt, tol in TOLS:
        args = (q.to(dt), kp.to(dt), vp.to(dt), tables, seq)
        out = ragged_paged_attention(*args, scale=hd ** -0.5)
        ref = ragged_paged_attention_plain(*args, hd ** -0.5)
        torch.cuda.synchronize()
        assert out.dtype == dt
        assert (out.float() - ref.float()).abs().max().item() < tol
    assert ragged_paged_attention.launches == before + 2


@pytest.mark.cuda
def test_ragged_kernel_never_reads_past_seq_lens(cuda_device):
    bs, mb, nh, nkv, hd = 16, 4, 8, 2, 128
    lens = [3, 17, 40, 0]
    q, kp, vp, tables, seq = _ragged_inputs(cuda_device, 5, nh, nkv, hd,
                                            bs, mb, lens)
    clean = ragged_paged_attention(q, kp, vp, tables, seq)
    pos = torch.arange(mb * bs, device=cuda_device)
    dead = pos[None, :] > seq.long()[:, None]
    rows = tables.long().repeat_interleave(bs, dim=1)
    lanes = (pos % bs)[None, :].expand(len(lens), -1)
    kp[rows[dead], lanes[dead]] = float("nan")
    vp[rows[dead], lanes[dead]] = float("nan")
    kp[0] = float("nan")
    live_blk = torch.arange(mb, device=cuda_device)[None, :] <= \
        (seq.long() // bs)[:, None]
    garbage = torch.where(live_blk, tables, 1 << 30)
    out = ragged_paged_attention(q, kp, vp, garbage, seq)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert torch.equal(out, clean)


@pytest.mark.cuda
def test_ragged_kernel_rejects_what_it_does_not_take(cuda_device):
    q, kp, vp, tables, seq = _ragged_inputs(cuda_device, 1, 4, 4, 32, 16,
                                            2, [3])
    with pytest.raises(ValueError):
        ragged_paged_attention(q, kp, vp, tables, seq)     # hd 32
    q, kp, vp, tables, seq = _ragged_inputs(cuda_device, 1, 4, 4, 64, 16,
                                            2, [3])
    with pytest.raises(TypeError):
        ragged_paged_attention(q, kp, vp, tables.long(), seq)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(cuda_device, d, causal):
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((3, 200, d))
                                .astype(np.float32)).to(cuda_device)
               for _ in range(3))
    before = _flash_bhsd.launches
    for dt, tol in TOLS:
        o, lse = _flash_bhsd(q.to(dt), k.to(dt), v.to(dt), causal,
                             d ** -0.5)
        ro, rlse = flash_attention_fwd_plain(q.to(dt), k.to(dt), v.to(dt),
                                             causal, d ** -0.5)
        torch.cuda.synchronize()
        assert o.dtype == dt and lse.dtype == torch.float32
        assert (o.float() - ro.float()).abs().max().item() < tol
        assert (lse - rlse).abs().max().item() < tol
    assert _flash_bhsd.launches == before + 2


@pytest.mark.cuda
def test_flash_kernel_is_forward_only(cuda_device):
    """The forward wrapper computes values only: given a tensor that needs
    a gradient under grad mode it raises and points at flash_attention,
    whose autograd Function carries the gradient; it rejects a head dim it
    has no kernel for."""
    q = torch.randn(2, 128, 64, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="flash_attention for gradients"):
        _flash_bhsd(q, q.detach(), q.detach(), True)
    with torch.no_grad():
        o, lse = _flash_bhsd(q, q, q, True)
    assert o.grad_fn is None and lse.grad_fn is None
    with pytest.raises(ValueError):
        _flash_bhsd(*(torch.randn(2, 128, 48, device=cuda_device),) * 3,
                    True)


# the attention functionals' routing rule: what no kernel covers (head dim
# 32 or 96, float16) runs the plain version under autograd on the card and
# counts one "plain" route; outputs and gradients against the same call on
# the CPU, element by element to 2^-7 |ref| + 1e-4 (outputs) and 2^-7 |ref|
# + 1e-3 of the largest (gradients): both compute in float32 from the same
# values and round to the input dtype, in another summation order
FALLBACK_CASES = [(32, torch.bfloat16, "plain"), (96, torch.bfloat16,
                                                  "plain"),
                  (128, torch.float16, "plain"), (128, torch.bfloat16,
                                                  "kernel")]


def _fallback_call(which, leaves, d):
    b, s, h = 2, 200, 2
    if which == "flash_attention":
        return flash_attention(*leaves, causal=True)[0]
    if which == "flash_attn_unpadded":
        cu = torch.tensor([0, 70, 200, 333, 400], dtype=torch.int32,
                          device=leaves[0].device)
        return flash_attn_unpadded(*(t.reshape(b * s, h, d) for t in leaves),
                                   cu, cu, 133, 133, d ** -0.5, causal=True)
    start = torch.tensor([70] * 70 + [200] * 130, dtype=torch.int32,
                         device=leaves[0].device)
    return flash_attention_with_sparse_mask(*leaves, start, is_causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["flash_attention", "flash_attn_unpadded",
                                   "flash_attention_with_sparse_mask"])
@pytest.mark.parametrize("d,dtype,route", FALLBACK_CASES)
def test_attention_functionals_route_by_dtype_and_head_dim(cuda_device,
                                                           which, d, dtype,
                                                           route):
    fn = {"flash_attention": flash_attention,
          "flash_attn_unpadded": flash_attn_unpadded,
          "flash_attention_with_sparse_mask":
              flash_attention_with_sparse_mask}[which]
    rng = np.random.default_rng(d + len(which))
    arrays = [rng.standard_normal((2, 200, 2, d)).astype(np.float32)
              for _ in range(4)]
    grads, outs = [], []
    for dev in (cuda_device, torch.device("cpu")):
        leaves = [torch.from_numpy(a).to(dev, dtype).requires_grad_()
                  for a in arrays[:3]]
        before = dict(fn.route_launches)
        out = _fallback_call(which, leaves, d)
        assert fn.route_launches[route] == before[route] + 1
        g = torch.from_numpy(arrays[3]).to(dev, dtype).reshape(out.shape)
        (out.float() * g.float()).sum().backward()
        outs.append(out.detach().cpu().float())
        grads.append([t.grad.cpu().float() for t in leaves])
    assert torch.isfinite(outs[0]).all()
    err = (outs[0] - outs[1]).abs()
    assert (err <= 2.0 ** -7 * outs[1].abs() + 1e-4).all(), err.max().item()
    for got, ref in zip(*grads):
        lim = 2.0 ** -7 * ref.abs() + 1e-3 * ref.abs().max()
        assert ((got - ref).abs() <= lim).all(), \
            (got - ref).abs().max().item()


BWD_TOLS = ((torch.float32, 0.0, 1e-4), (torch.bfloat16, 2.0 ** -7, 1e-3))


def _bwd_close(out, ref, rtol, atol):
    d = (out.float() - ref.float()).abs()
    lim = rtol * ref.float().abs() + atol * ref.float().abs().max()
    return bool((d <= lim).all()), d.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [200, 256])
def test_flash_bwd_kernel_matches_plain(cuda_device, d, causal, s):
    rng = np.random.default_rng(d + s + causal)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((3, s, d))
                                    .astype(np.float32)).to(cuda_device)
                   for _ in range(4))
    scale = d ** -0.5
    before = _flash_bhsd_bwd.launches
    for dt, rtol, atol in BWD_TOLS:
        qt, kt, vt, dot = (x.to(dt) for x in (q, k, v, do))
        o, lse = flash_attention_fwd_plain(qt, kt, vt, causal, scale)
        # bf16 at D 64 and 128 takes the tensor cores, the rest the CUDA
        # cores
        route = "wgmma" if dt == torch.bfloat16 and d < 256 else "cuda_core"
        routed = _flash_bhsd_bwd.route_launches[route]
        got = _flash_bhsd_bwd(qt, kt, vt, o, lse, dot, causal, scale)
        assert _flash_bhsd_bwd.route_launches[route] == routed + 1
        ref = flash_attention_bwd_plain(qt, kt, vt, o, lse, dot, causal,
                                        scale)
        torch.cuda.synchronize()
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            assert g.dtype == dt
            ok, err = _bwd_close(g, r, rtol, atol)
            assert ok, f"{name} {dt}: max abs err {err}"
    assert _flash_bhsd_bwd.launches == before + 2


@pytest.mark.cuda
def test_flash_bwd_takes_a_strided_do(cuda_device):
    """autograd hands dO over non-contiguous: the wrapper makes it
    contiguous, the kernel never sees the strides."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((4, 130, 64))
                                .astype(np.float32)).to(cuda_device)
               for _ in range(3))
    do_t = torch.from_numpy(rng.standard_normal((64, 130, 4))
                            .astype(np.float32)).to(cuda_device)
    do = do_t.permute(2, 1, 0)
    assert not do.is_contiguous()
    o, lse = _flash_bhsd(q, k, v, True)
    got = _flash_bhsd_bwd(q, k, v, o, lse, do, True)
    ref = flash_attention_bwd_plain(q, k, v, o, lse, do.contiguous(), True,
                                    64 ** -0.5)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert _bwd_close(g, r, 0.0, 1e-4)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_autograd_matches_plain_autograd(cuda_device,
                                                         causal):
    """[B, S, H, D] through the autograd Function (both flash kernels)
    against autograd through the plain attention, float32, GQA-repeated
    heads included."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(21)
    b, s, h, hkv, d = 2, 192, 8, 2, 64
    qn = rng.standard_normal((b, s, h, d)).astype(np.float32)
    kn, vn = (rng.standard_normal((b, s, hkv, d)).astype(np.float32)
              for _ in range(2))
    gn = rng.standard_normal((b, s, h, d)).astype(np.float32)
    grads = []
    for flash in (True, False):
        q, k, v = (torch.from_numpy(a).to(cuda_device).requires_grad_()
                   for a in (qn, kn, vn))
        kr, vr = (x.repeat_interleave(h // hkv, dim=2) for x in (k, v))
        if flash:
            out, _ = flash_attention(q, kr, vr, causal=causal)
        else:
            out = scaled_dot_product_attention(q, kr, vr, is_causal=causal)
        out.backward(torch.from_numpy(gn).to(cuda_device))
        grads.append((out.detach(), q.grad, k.grad, v.grad))
    torch.cuda.synchronize()
    for got, ref in zip(*grads):
        assert _bwd_close(got, ref, 0.0, 1e-4)[0]


def _bwd_inputs(dev, seed, shape, dt):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dev, dt) for _ in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [64, 200, 1000, 2048])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_wgmma_matches_plain(cuda_device, d, s, causal):
    """The tensor-core pair (bf16, P and dS as hi + lo) against the plain
    version on the forward's own o and lse: one 64-tile, tails that no
    64-tile divides (200, 1000) and the train length, held by _bwd_close
    at BWD_TOLS's bf16 rule."""
    q, k, v, do = _bwd_inputs(cuda_device, 5 * s + d + causal, (3, s, d),
                              torch.bfloat16)
    scale = d ** -0.5
    o, lse = _flash_bhsd(q, k, v, causal, scale)
    before = _flash_bhsd_bwd.route_launches["wgmma"]
    got = _flash_bhsd_bwd(q, k, v, o, lse, do, causal, scale)
    ref = flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale)
    torch.cuda.synchronize()
    assert _flash_bhsd_bwd.route_launches["wgmma"] == before + 1
    _, rtol, atol = BWD_TOLS[1]
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == torch.bfloat16 and g.shape == r.shape
        ok, err = _bwd_close(g, r, rtol, atol)
        assert ok, f"{name}: max abs err {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_wgmma_keeps_heads_apart(cuda_device, d, causal):
    """NaN in every input of head 1 (q, k, v, dO, o and lse) at S 200,
    where the last tile of a head ends 56 rows short of 64: heads 0 and
    2 get bit for bit the gradients of a clean run. A tile that read past
    S into the next head's rows would carry the NaN over."""
    q, k, v, do = _bwd_inputs(cuda_device, d + causal, (3, 200, d),
                              torch.bfloat16)
    o, lse = _flash_bhsd(q, k, v, causal)
    clean = _flash_bhsd_bwd(q, k, v, o, lse, do, causal)
    for t in (q, k, v, do, o, lse):
        t[1] = float("nan")
    dirty = _flash_bhsd_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    for c, g in zip(clean, dirty):
        assert torch.isnan(g[1]).any()
        assert torch.equal(g[0], c[0]) and torch.equal(g[2], c[2])


@pytest.mark.cuda
def test_flash_bwd_wgmma_takes_a_strided_do(cuda_device):
    """test_flash_bwd_takes_a_strided_do in bf16, on the tensor cores: the
    wrapper makes the permuted dO contiguous before the route is chosen."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((4, 130, 64))
                                .astype(np.float32)).to(cuda_device,
                                                        torch.bfloat16)
               for _ in range(3))
    do_t = torch.from_numpy(rng.standard_normal((64, 130, 4))
                            .astype(np.float32)).to(cuda_device,
                                                    torch.bfloat16)
    do = do_t.permute(2, 1, 0)
    assert not do.is_contiguous()
    o, lse = _flash_bhsd(q, k, v, True)
    before = _flash_bhsd_bwd.route_launches["wgmma"]
    got = _flash_bhsd_bwd(q, k, v, o, lse, do, True)
    ref = flash_attention_bwd_plain(q, k, v, o, lse, do.contiguous(), True,
                                    64 ** -0.5)
    torch.cuda.synchronize()
    assert _flash_bhsd_bwd.route_launches["wgmma"] == before + 1
    for g, r in zip(got, ref):
        assert _bwd_close(g, r, *BWD_TOLS[1][1:])[0]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_autograd_bf16_takes_the_wgmma_route(cuda_device,
                                                             causal):
    """[B, S, H, D] bf16 through the autograd Function, GQA-repeated heads
    included: the forward and the backward run on the tensor cores once
    each, and the leaves'
    gradients equal the plain backward on the forward's own o and lse
    (heads folded as the Function folds them, the repeated heads' kv
    gradients summed), by BWD_TOLS's bf16 rule."""
    rng = np.random.default_rng(22)
    b, s, h, hkv, d = 2, 192, 8, 2, 64
    qn = rng.standard_normal((b, s, h, d)).astype(np.float32)
    kn, vn = (rng.standard_normal((b, s, hkv, d)).astype(np.float32)
              for _ in range(2))
    gn = rng.standard_normal((b, s, h, d)).astype(np.float32)
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               .requires_grad_() for a in (qn, kn, vn))
    g = torch.from_numpy(gn).to(cuda_device, torch.bfloat16)
    before = _flash_bhsd_bwd.route_launches["wgmma"]
    fwd_before = _flash_bhsd.route_launches["wgmma"]
    out, _ = flash_attention(q, k.repeat_interleave(h // hkv, dim=2),
                             v.repeat_interleave(h // hkv, dim=2),
                             causal=causal)
    assert _flash_bhsd.route_launches["wgmma"] == fwd_before + 1
    out.backward(g)
    assert _flash_bhsd_bwd.route_launches["wgmma"] == before + 1

    def fold(x):
        return x.detach().repeat_interleave(h // x.shape[2], dim=2) \
            .transpose(1, 2).reshape(b * h, s, d).contiguous()

    fq, fk, fv, fg = (fold(x) for x in (q, k, v, g))
    with torch.no_grad():
        o, lse = _flash_bhsd(fq, fk, fv, causal)
        rq, rk, rv = flash_attention_bwd_plain(fq, fk, fv, o, lse, fg,
                                               causal, d ** -0.5)

    def unfold(x, heads):
        x = x.float().reshape(b, h, s, d).transpose(1, 2)
        return x.reshape(b, s, heads, h // heads, d).sum(3)

    torch.cuda.synchronize()
    for got, ref in ((q.grad, unfold(rq, h)), (k.grad, unfold(rk, hkv)),
                     (v.grad, unfold(rv, hkv))):
        ok, err = _bwd_close(got, ref, *BWD_TOLS[1][1:])
        assert ok, f"max abs err {err}"


# chip_smoke.py's rule for a bf16 forward: o to one bf16 ulp of the value
# plus 1e-4, the float32 lse to 1e-4 (summation order only)
FWD_RTOL, FWD_ATOL, LSE_ATOL = 2.0 ** -7, 1e-4, 1e-4


def _fwd_errs(o, lse, ro, rlse):
    """(largest ratio of an element's o error to FWD_RTOL |ref| + FWD_ATOL,
    largest lse error)."""
    d = (o.float() - ro.float()).abs()
    lim = FWD_RTOL * ro.float().abs() + FWD_ATOL
    return (d / lim).max().item(), (lse - rlse).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [64, 200, 1000, 2048])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_wgmma_matches_plain(cuda_device, d, s, causal):
    """The tensor-core forward (bf16, P as hi + lo) against the plain
    version: one 64-tile, tails that no 64-tile divides (200, 1000) and
    the train length, at chip_smoke.py's bf16 rule."""
    q, k, v = _bwd_inputs(cuda_device, 7 * s + d + causal, (3, s, d),
                          torch.bfloat16)[:3]
    scale = d ** -0.5
    before = _flash_bhsd.route_launches["wgmma"]
    o, lse = _flash_bhsd(q, k, v, causal, scale)
    ro, rlse = flash_attention_fwd_plain(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert _flash_bhsd.route_launches["wgmma"] == before + 1
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ratio, lse_err = _fwd_errs(o, lse, ro, rlse)
    assert ratio <= 1.0, f"o: {ratio} x the bf16 rule"
    assert lse_err <= LSE_ATOL, f"lse: max abs err {lse_err}"


@pytest.mark.cuda
@pytest.mark.parametrize("dt,d", [(torch.bfloat16, 256), (torch.float32, 64),
                                  (torch.float32, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_cuda_core_route(cuda_device, dt, d, causal):
    """bf16 at D 256 and float32 keep the CUDA-core kernel, held to the
    bf16 rule and to float32's 1e-4 on o and lse."""
    q, k, v = _bwd_inputs(cuda_device, d + causal, (3, 200, d), dt)[:3]
    before = _flash_bhsd.route_launches["cuda_core"]
    o, lse = _flash_bhsd(q, k, v, causal)
    ro, rlse = flash_attention_fwd_plain(q, k, v, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert _flash_bhsd.route_launches["cuda_core"] == before + 1
    if dt == torch.bfloat16:
        ratio, lse_err = _fwd_errs(o, lse, ro, rlse)
        assert ratio <= 1.0, f"o: {ratio} x the bf16 rule"
    else:
        assert (o - ro).abs().max().item() <= 1e-4
        lse_err = (lse - rlse).abs().max().item()
    assert lse_err <= LSE_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_wgmma_keeps_heads_apart(cuda_device, d, causal):
    """At S 200, where a head's last tile ends 56 rows short of 64: each
    head of a [3, 200, D] call gets bit for bit what that head alone gets,
    and NaN in every input of head 1 leaves heads 0 and 2 bit for bit. A
    tile that read or wrote rows past S would cross into the next
    head."""
    q, k, v = _bwd_inputs(cuda_device, 3 * d + causal, (3, 200, d),
                          torch.bfloat16)[:3]
    before = _flash_bhsd.route_launches["wgmma"]
    o, lse = _flash_bhsd(q, k, v, causal)
    for h in range(3):
        oh, lh = _flash_bhsd(q[h:h + 1], k[h:h + 1], v[h:h + 1], causal)
        assert torch.equal(oh[0], o[h]) and torch.equal(lh[0], lse[h])
    for t in (q, k, v):
        t[1] = float("nan")
    o2, lse2 = _flash_bhsd(q, k, v, causal)
    torch.cuda.synchronize()
    assert _flash_bhsd.route_launches["wgmma"] == before + 5
    assert torch.isnan(o2[1]).any() and torch.isnan(lse2[1]).any()
    for h in (0, 2):
        assert torch.equal(o2[h], o[h]) and torch.equal(lse2[h], lse[h])


# -- block-scaled weight matmul -------------------------------------------------

def _qmm_close(out, ref):
    """Element by element within one bf16 ulp (2^-7 |ref|) in bf16, or
    1e-5 in float32, plus 1e-5 of the largest |ref| for the summation
    order over K."""
    d = (out.float() - ref.float()).abs()
    rtol = 2.0 ** -7 if out.dtype == torch.bfloat16 else 1e-5
    lim = rtol * ref.float().abs() + 1e-5 * ref.float().abs().max()
    return bool((d <= lim).all()), d.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 8, 20, 100])
@pytest.mark.parametrize("n,k,block_k", [(72, 256, None), (40, 192, None),
                                         (33, 210, 105), (16, 96, 12)])
@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
def test_quant_matmul_kernel_matches_plain(cuda_device, m, n, k, block_k,
                                           qdtype):
    """All four kernels (for M <= 32, gemv_tc for bf16 x with blocks of
    whole k16 steps (128, 96), rows otherwise (float32 x; blocks 105 and
    12); above, wgmma for bf16 x with blocks of whole 64-deep stages,
    tiles otherwise), blocks below 128 and not a multiple of 8, K not a
    multiple of 8 (the element-wise path), float32 and bfloat16 x."""
    rng = np.random.default_rng(m * 1000 + n + k)
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    codes, scales = quantize_weight_blockwise(w.to(cuda_device), block_k,
                                              qdtype)
    before = quant_matmul.launches
    for dt in (torch.float32, torch.bfloat16):
        xt = x.to(cuda_device, dt)
        out = quant_matmul(xt, codes, scales)
        ref = quant_matmul_plain(xt, codes, scales)
        torch.cuda.synchronize()
        assert out.dtype == dt and out.shape == (m, n)
        ok, err = _qmm_close(out, ref)
        assert ok, f"{dt}: max abs err {err}"
    assert quant_matmul.launches == before + 2


@pytest.mark.cuda
def test_quant_matmul_takes_leading_dims_and_offset_views(cuda_device):
    """A [2, 3, K] x, and an x that starts 4 bytes into its storage (the
    kernel then takes its element-wise path)."""
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.standard_normal((24, 128)).astype(np.float32))
    codes, scales = quantize_weight_blockwise(w.to(cuda_device))
    x = torch.from_numpy(rng.standard_normal((2, 3, 128)).astype(
        np.float32)).to(cuda_device)
    out = quant_matmul(x, codes, scales)
    assert out.shape == (2, 3, 24)
    assert _qmm_close(out, quant_matmul_plain(x, codes, scales))[0]
    flat = torch.zeros(1 + 5 * 128, device=cuda_device)
    xo = flat[1:].view(5, 128)
    xo.copy_(x.reshape(-1, 128)[:5])
    assert xo.data_ptr() % 16 != 0
    out = quant_matmul(xo, codes, scales)
    assert _qmm_close(out, quant_matmul_plain(xo, codes, scales))[0]
    with pytest.raises(TypeError):
        quant_matmul(x.double(), codes, scales)


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
def test_quantized_linear_launches_wgmma_and_equals_plain(cuda_device,
                                                          qdtype):
    """The mp layers' quantized product (quantized_linear, bf16 x of 3 x 40
    rows: past the GEMVs) launches the wgmma kernel once and equals the
    plain version on the same quantized operands; its straight-through
    gradients are float32 products against the bf16 weight."""
    rng = np.random.default_rng(11)
    w = torch.from_numpy(rng.standard_normal((96, 256)).astype(np.float32)
                         * 0.05).to(cuda_device, torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((3, 40, 256)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    w.requires_grad_()
    x.requires_grad_()
    before = dict(quant_matmul.route_launches)
    y = qmm_mod.quantized_linear(x, w, qdtype=qdtype)
    assert {r: c - before[r] for r, c in
            quant_matmul.route_launches.items()} == \
        {**dict.fromkeys(before, 0), "wgmma": 1}
    codes, scales = quantize_weight_blockwise(w.detach(), None, qdtype)
    xq = x.detach()
    if qdtype == "fp8":
        xs = x.detach().float().abs().amax() / qmm_mod.FP8_MAX
        xq = ((x.detach().float() / xs).to(torch.float8_e4m3fn).float()
              * xs).to(torch.bfloat16)
    ref = quant_matmul_plain(xq.reshape(-1, 256), codes, scales)
    torch.cuda.synchronize()
    ok, err = _qmm_close(y.reshape(-1, 96), ref)
    assert ok, f"max abs err {err}"
    g = torch.ones_like(y)
    y.backward(g)
    dx = (g.reshape(-1, 96).float() @ w.detach().float()).to(torch.bfloat16)
    assert torch.equal(x.grad.reshape(-1, 256), dx)
    dw = (g.reshape(-1, 96).float().t()
          @ x.detach().reshape(-1, 256).float()).to(torch.bfloat16)
    assert torch.equal(w.grad, dw)


# -- the tensor-core primitives and the wgmma product ----------------------------

# both entries of csrc/wgmma_selftest.cu: the library is loaded once, with
# every signature
_SELFTEST_SIG = {"wgmma_selftest": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                 + [ctypes.c_void_p],
                 "wgmma_chain_selftest": [ctypes.c_void_p] * 4
                 + [ctypes.c_int] + [ctypes.c_void_p],
                 "mma_codes_selftest": [ctypes.c_void_p] * 4
                 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
                 "split3_selftest": [ctypes.c_void_p] * 4
                 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
                 "ss_tb_selftest": [ctypes.c_void_p] * 3 + [ctypes.c_int]
                 + [ctypes.c_void_p],
                 "ss_tatb_selftest": [ctypes.c_void_p] * 3 + [ctypes.c_int]
                 + [ctypes.c_void_p]}


@pytest.mark.cuda
@pytest.mark.parametrize("k,bk", [(64, 64), (256, 128)])
def test_wgmma_one_tile_matches_matmul(cuda_device, k, bk):
    """csrc/wgmma.cuh on one 64 x 128 tile: one m64n128k16 wgmma over K 64
    from cp.async'd, 128B-swizzled tiles, then K 256 in two K-blocks with
    distinct per-row scales on the accumulator, against torch.matmul in
    float32. A is int8-valued (as the codes), B normal bf16 (as x); the
    products are exact, so only the float32 summation order differs: 1e-5
    of the largest output. A wrong descriptor, swizzle or fragment layout
    moves outputs by their own size."""
    rng = np.random.default_rng(k)
    a = torch.from_numpy(rng.integers(-127, 128, (64, k)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((128, k)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    kb = k // bk
    scales = torch.from_numpy(rng.uniform(0.5, 2.0, (64, kb)).astype(
        np.float32)).to(cuda_device)
    if kb == 1:
        scales.fill_(1.0)
    out = torch.empty(64, 128, device=cuda_device)
    lib = _build.load("wgmma_selftest", _SELFTEST_SIG)
    rc = lib.wgmma_selftest(a.data_ptr(), b.data_ptr(), scales.data_ptr(),
                            out.data_ptr(), k, bk,
                            torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"CUDA error {rc}"
    ref = torch.zeros(64, 128, device=cuda_device)
    for j in range(kb):
        blk = slice(j * bk, (j + 1) * bk)
        ref += scales[:, j:j + 1] * torch.matmul(a[:, blk].float(),
                                                 b[:, blk].float().t())
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), f"max abs err {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_wgmma_chained_tile_matches_matmul(cuda_device, d):
    """csrc/wgmma.cuh's SS m64n64k16, MN-major descriptor, RS form with B
    transposed and accumulator-to-A-fragment rule on one tile chained as
    the flash backward's dk/dv kernel chains them: X = K Q^T by SS wgmmas
    over D, 0.1 X split into hi + lo bf16 fragments in registers, then (0.1
    X) dO with dO read MN-major, hi then lo into one accumulator. Against
    float64 matmuls of the same bf16 values within 1e-5 of the largest
    output: the hi + lo pair carries 0.1 X to about 2^-17 of itself,
    while a wrong descriptor, transpose or fragment rule moves outputs by
    their own size."""
    rng = np.random.default_rng(d + 1)
    k, q, do = (torch.from_numpy(rng.standard_normal((64, d)).astype(
        np.float32)).to(cuda_device, torch.bfloat16) for _ in range(3))
    out = torch.empty(64, d, device=cuda_device)
    lib = _build.load("wgmma_selftest", _SELFTEST_SIG)
    rc = lib.wgmma_chain_selftest(k.data_ptr(), q.data_ptr(), do.data_ptr(),
                                  out.data_ptr(), d,
                                  torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"CUDA error {rc}"
    ref = (0.1 * (k.double() @ q.double().t())) @ do.double()
    torch.cuda.synchronize()
    err = (out.double() - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), f"max abs err {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("m", [33, 64, 100, 257, 1024])
@pytest.mark.parametrize("n,k,block_k", [(72, 256, None), (4100, 4096, 128),
                                         (4096, 11008, 128), (96, 192, 64),
                                         (40, 320, 64)])
@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
def test_quant_matmul_wgmma_matches_plain(cuda_device, m, n, k, block_k,
                                          qdtype):
    """The tensor-core route (bf16 x, M > 32): partial m- and n-tiles, N
    not a multiple of 8 (4100: element stores at the edge), blocks of one
    64-deep stage (several K-blocks, a scale each) and the serve shapes (K
    4096 and 11008 at bk 128), int8 and fp8 codes, held to the plain
    version by _qmm_close."""
    rng = np.random.default_rng(m * 7 + n + k)
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32))
    codes, scales = quantize_weight_blockwise(w.to(cuda_device), block_k,
                                              qdtype)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    before = quant_matmul.route_launches["wgmma"]
    out = quant_matmul(x, codes, scales)
    ref = quant_matmul_plain(x, codes, scales)
    torch.cuda.synchronize()
    assert quant_matmul.route_launches["wgmma"] == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    ok, err = _qmm_close(out, ref)
    assert ok, f"max abs err {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,block_k", [(40, 160, 16), (40, 192, 96)])
def test_quant_matmul_blocks_short_of_a_stage_take_the_tiled_route(
        cuda_device, n, k, block_k):
    """bf16 x past the GEMV with blocks that are not whole 64-deep stages:
    the CUDA-core tile, held to the plain version by _qmm_close."""
    rng = np.random.default_rng(n + k)
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32))
    codes, scales = quantize_weight_blockwise(w.to(cuda_device), block_k)
    x = torch.from_numpy(rng.standard_normal((100, k)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    before = quant_matmul.route_launches["tiled"]
    out = quant_matmul(x, codes, scales)
    ref = quant_matmul_plain(x, codes, scales)
    torch.cuda.synchronize()
    assert quant_matmul.route_launches["tiled"] == before + 1
    ok, err = _qmm_close(out, ref)
    assert ok, f"max abs err {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
def test_quant_matmul_wgmma_takes_every_code_exactly(cuda_device, qdtype):
    """Every int8 code and every finite e4m3 code (subnormals included)
    through the kernel's conversion to bf16: with unit scales and one-hot
    rows of x, out[m, n] is codes[n, m] itself, bit for bit."""
    k = n = 256
    idx = torch.arange(n)[:, None] + torch.arange(k)[None, :]
    if qdtype == "int8":
        codes = (idx % 255 - 127).to(torch.int8)
    else:
        every = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(
            torch.float8_e4m3fn)
        every = every[torch.isfinite(every.float())]
        codes = every[idx % every.numel()]
    codes = codes.contiguous().to(cuda_device)
    scales = torch.ones(n, k // 128, device=cuda_device)
    x = torch.eye(k, device=cuda_device, dtype=torch.bfloat16)
    before = quant_matmul.route_launches["wgmma"]
    out = quant_matmul(x, codes, scales)
    torch.cuda.synchronize()
    assert quant_matmul.route_launches["wgmma"] == before + 1
    assert torch.equal(out.float(), codes.float().t())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [100, 257])
def test_quant_matmul_wgmma_never_reads_rows_past_m(cuda_device, m):
    """x is a view of M rows of a wider buffer whose further rows are NaN,
    and M leaves the last 128-row tile partial: the output is the same
    bits as from a clean copy of x."""
    rng = np.random.default_rng(m)
    k, n = 384, 136
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32))
    codes, scales = quantize_weight_blockwise(w.to(cuda_device))
    buf = torch.full((256 * ((m + 255) // 256), k), float("nan"),
                     device=cuda_device, dtype=torch.bfloat16)
    x = buf[:m]
    x.copy_(torch.from_numpy(rng.standard_normal((m, k)).astype(
        np.float32)).to(cuda_device, torch.bfloat16))
    before = quant_matmul.route_launches["wgmma"]
    out = quant_matmul(x, codes, scales)
    clean = quant_matmul(x.clone(), codes, scales)
    torch.cuda.synchronize()
    assert quant_matmul.route_launches["wgmma"] == before + 2
    assert torch.isfinite(out).all()
    assert torch.equal(out.view(torch.int16), clean.view(torch.int16))


# -- the tensor-core GEMV (gemv_tc) ---------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("k,bk", [(256, 128), (96, 16)])
def test_mma_codes_one_tile_matches_matmul(cuda_device, k, bk):
    """csrc/mma.cuh on one m16n8 tile as the tensor-core GEMV uses it: 16
    rows of int8 codes read as A fragments straight from their contiguous
    rows under the k permutation, 8 rows of bf16 x as B at the same
    physical k, one mma.sync m16n8k16 a k16 step, a float32 partial a
    K-block with distinct per-row scales on the accumulator (two blocks of
    128, or six of 16), against torch.matmul in float32. The products are
    exact, so only the summation order differs: 1e-5 of the largest
    output. A wrong fragment rule or permutation moves outputs by their
    own size."""
    rng = np.random.default_rng(k + bk)
    a = torch.from_numpy(rng.integers(-127, 128, (16, k)).astype(
        np.int8)).to(cuda_device)
    x = torch.from_numpy(rng.standard_normal((8, k)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    kb = k // bk
    scales = torch.from_numpy(rng.uniform(0.5, 2.0, (16, kb)).astype(
        np.float32)).to(cuda_device)
    out = torch.empty(16, 8, device=cuda_device)
    lib = _build.load("wgmma_selftest", _SELFTEST_SIG)
    rc = lib.mma_codes_selftest(a.data_ptr(), x.data_ptr(),
                                scales.data_ptr(), out.data_ptr(), k, bk,
                                torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"CUDA error {rc}"
    ref = torch.zeros(16, 8, device=cuda_device)
    for j in range(kb):
        blk = slice(j * bk, (j + 1) * bk)
        ref += scales[:, j:j + 1] * torch.matmul(a[:, blk].float(),
                                                 x[:, blk].float().t())
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), f"max abs err {err}"


def _gemv_inputs(dev, seed, m, n, k, block_k, qdtype="int8"):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32))
    codes, scales = quantize_weight_blockwise(w.to(dev), block_k, qdtype)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(
        np.float32)).to(dev, torch.bfloat16)
    return x, codes, scales


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 8, 16, 20, 32])
@pytest.mark.parametrize("n,k,block_k", [(4100, 4096, 128),
                                         (4096, 11008, 128), (200, 320, 64),
                                         (72, 256, 16)])
@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
def test_quant_matmul_gemv_tc_matches_plain(cuda_device, m, n, k, block_k,
                                            qdtype):
    """The tensor-core GEMV (bf16 x, M <= 32): one, two and four n8 tiles
    of x with rows past M zero, N not a multiple of 16 or of the block's
    128 columns, the serve shapes (K 4096 and 11008 at bk 128, cut into as
    many K-slices as fit on the card at once, at most 7), blocks of 64 and
    of one k16 step, int8 and fp8 codes, held to the plain version by
    _qmm_close."""
    x, codes, scales = _gemv_inputs(cuda_device, m * 7 + n + k, m, n, k,
                                    block_k, qdtype)
    before = quant_matmul.route_launches["gemv_tc"]
    out = quant_matmul(x, codes, scales)
    ref = quant_matmul_plain(x, codes, scales)
    torch.cuda.synchronize()
    assert quant_matmul.route_launches["gemv_tc"] == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    ok, err = _qmm_close(out, ref)
    assert ok, f"max abs err {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
def test_quant_matmul_gemv_tc_takes_every_code_exactly(cuda_device, qdtype):
    """Every int8 code and every finite e4m3 code (subnormals included)
    through the GEMV's conversion to bf16: with unit scales and one-hot
    rows of x, 32 rows of the identity at a time, out[m, n] is codes[n, r0
    + m] itself, bit for bit."""
    k = n = 256
    idx = torch.arange(n)[:, None] + torch.arange(k)[None, :]
    if qdtype == "int8":
        codes = (idx % 255 - 127).to(torch.int8)
    else:
        every = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(
            torch.float8_e4m3fn)
        every = every[torch.isfinite(every.float())]
        codes = every[idx % every.numel()]
    codes = codes.contiguous().to(cuda_device)
    scales = torch.ones(n, k // 128, device=cuda_device)
    eye = torch.eye(k, device=cuda_device, dtype=torch.bfloat16)
    before = quant_matmul.route_launches["gemv_tc"]
    for r0 in range(0, k, 32):
        out = quant_matmul(eye[r0:r0 + 32], codes, scales)
        torch.cuda.synchronize()
        assert torch.equal(out.float(), codes.float().t()[r0:r0 + 32])
    assert quant_matmul.route_launches["gemv_tc"] == before + k // 32


@pytest.mark.cuda
@pytest.mark.parametrize("m", [3, 20])
def test_quant_matmul_gemv_tc_never_reads_rows_past_m(cuda_device, m):
    """x is a view of M rows of a 32-row buffer whose further rows are
    NaN: the output is the same bits as from a clean copy of x."""
    rng = np.random.default_rng(m)
    k, n = 384, 136
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32))
    codes, scales = quantize_weight_blockwise(w.to(cuda_device))
    buf = torch.full((32, k), float("nan"), device=cuda_device,
                     dtype=torch.bfloat16)
    x = buf[:m]
    x.copy_(torch.from_numpy(rng.standard_normal((m, k)).astype(
        np.float32)).to(cuda_device, torch.bfloat16))
    before = quant_matmul.route_launches["gemv_tc"]
    out = quant_matmul(x, codes, scales)
    clean = quant_matmul(x.clone(), codes, scales)
    torch.cuda.synchronize()
    assert quant_matmul.route_launches["gemv_tc"] == before + 2
    assert torch.isfinite(out).all()
    assert torch.equal(out.view(torch.int16), clean.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(11008, 4096), (4096, 11008)])
def test_quant_matmul_gemv_tc_gives_the_same_bits_twice(cuda_device, n, k):
    """The K-slices of a column tile are summed in a fixed order, without
    atomics: two calls on the same inputs give the same bits (N 11008:
    86 column tiles, few slices; N 4096: 32 tiles, up to 7 slices)."""
    x, codes, scales = _gemv_inputs(cuda_device, n + k, 8, n, k, 128)
    first = quant_matmul(x, codes, scales)
    second = quant_matmul(x, codes, scales)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


@pytest.mark.cuda
def test_quant_matmul_gemv_tc_takes_leading_dims(cuda_device):
    """A [2, 3, K] x is 6 rows of the GEMV, [2, 3, N] out."""
    x, codes, scales = _gemv_inputs(cuda_device, 5, 6, 72, 256, None)
    x = x.reshape(2, 3, 256)
    before = quant_matmul.route_launches["gemv_tc"]
    out = quant_matmul(x, codes, scales)
    ref = quant_matmul_plain(x, codes, scales)
    torch.cuda.synchronize()
    assert quant_matmul.route_launches["gemv_tc"] == before + 1
    assert out.shape == (2, 3, 72)
    ok, err = _qmm_close(out, ref)
    assert ok, f"max abs err {err}"


@pytest.mark.cuda
def test_quant_matmul_route_launches_count_each_kernel(cuda_device):
    """Each call adds one to its route's count and to the total: bf16 x
    with blocks of k16 steps and aligned data on gemv_tc; float32 x, a
    block of 12 and an x 2 bytes into its storage on rows; 33 bf16 rows
    on wgmma, 33 float32 rows on tiled."""
    x, codes, scales = _gemv_inputs(cuda_device, 6, 33, 40, 192, 96)
    _, codes12, scales12 = _gemv_inputs(cuda_device, 7, 1, 40, 192, 12)
    flat = torch.zeros(1 + 8 * 192, device=cuda_device, dtype=torch.bfloat16)
    xo = flat[1:].view(8, 192)
    xo.copy_(x[:8])
    calls = [(x[:8], codes, scales, "gemv_tc"),
             (x[:1], codes, scales, "gemv_tc"),
             (x[:8].float(), codes, scales, "rows"),
             (x[:8], codes12, scales12, "rows"),
             (xo, codes, scales, "rows"),
             (x, codes, scales, "tiled"),      # bk 96: not whole stages
             (x.float(), codes, scales, "tiled")]
    _, codes64, scales64 = _gemv_inputs(cuda_device, 8, 1, 40, 192, 64)
    calls.append((x, codes64, scales64, "wgmma"))
    counts = dict(quant_matmul.route_launches)
    total = quant_matmul.launches
    for xi, c, sc, route in calls:
        out = quant_matmul(xi, c, sc)
        counts[route] += 1
        assert quant_matmul.route_launches == counts, route
        assert _qmm_close(out, quant_matmul_plain(xi, c, sc))[0], route
    assert quant_matmul.launches == total + len(calls)


@pytest.mark.cuda
def test_quant_matmul_gemv_tc_refuses_what_it_does_not_take(cuda_device):
    """The kernel refuses float32 x, more than 32 rows, a block of 12 and
    an unaligned x: the launch raises, and nothing runs another kernel in
    its place."""
    x, codes, scales = _gemv_inputs(cuda_device, 9, 33, 40, 192, 96)
    _, codes12, scales12 = _gemv_inputs(cuda_device, 10, 1, 40, 192, 12)
    out = torch.empty(33, 40, device=cuda_device, dtype=torch.bfloat16)
    flat = torch.zeros(1 + 8 * 192, device=cuda_device, dtype=torch.bfloat16)
    xo = flat[1:].view(8, 192)
    for xi, c, sc in ((x[:8].float(), codes, scales), (x, codes, scales),
                      (x[:8], codes12, scales12), (xo, codes, scales)):
        o = out[:xi.shape[0]].to(xi.dtype)
        with pytest.raises(RuntimeError, match="gemv_tc"):
            _launch("gemv_tc", xi, c, sc, o)


# -- int8 KV pool and split-context attention -----------------------------------

def _quant_inputs(dev, seed, nh, nkv, hd, bs, mb, lens):
    q, kp, vp, tables, seq = _ragged_inputs(dev, seed, nh, nkv, hd, bs, mb,
                                            lens)
    kc, ks = kv_quantize_rows(kp)
    vc, vs = kv_quantize_rows(vp)
    return q, kc, ks, vc, vs, tables, seq


@pytest.mark.cuda
@pytest.mark.parametrize("nh,nkv,hd", [(32, 32, 128), (32, 8, 128),
                                       (8, 1, 64), (16, 4, 256)])
def test_ragged_quant_kernel_matches_plain(cuda_device, nh, nkv, hd):
    bs, mb = 16, 8
    lens = [0, bs - 1, bs, 77, mb * bs - 1]
    q, kc, ks, vc, vs, tables, seq = _quant_inputs(
        cuda_device, nh + hd + 1, nh, nkv, hd, bs, mb, lens)
    before = ragged_paged_attention_quant.launches
    for dt, tol in TOLS:
        args = (q.to(dt), kc, ks, vc, vs, tables, seq)
        out = ragged_paged_attention_quant(*args, scale=hd ** -0.5)
        ref = ragged_paged_attention_quant_plain(*args, hd ** -0.5)
        torch.cuda.synchronize()
        assert out.dtype == dt
        assert (out.float() - ref.float()).abs().max().item() < tol
    assert ragged_paged_attention_quant.launches == before + 2


@pytest.mark.cuda
def test_ragged_quant_kernel_never_reads_past_seq_lens(cuda_device):
    """Code 127 and NaN scales at every position past each seq_len,
    inside the live block too, and garbage table entries past it."""
    bs, mb, nh, nkv, hd = 16, 4, 8, 2, 128
    lens = [3, 17, 40, 0]
    q, kc, ks, vc, vs, tables, seq = _quant_inputs(cuda_device, 6, nh, nkv,
                                                   hd, bs, mb, lens)
    clean = ragged_paged_attention_quant(q, kc, ks, vc, vs, tables, seq)
    pos = torch.arange(mb * bs, device=cuda_device)
    dead = pos[None, :] > seq.long()[:, None]
    rows = tables.long().repeat_interleave(bs, dim=1)
    lanes = (pos % bs)[None, :].expand(len(lens), -1)
    for codes, scales in ((kc, ks), (vc, vs)):
        codes[rows[dead], lanes[dead]] = 127
        scales[rows[dead], lanes[dead]] = float("nan")
        scales[0] = float("nan")
    live_blk = torch.arange(mb, device=cuda_device)[None, :] <= \
        (seq.long() // bs)[:, None]
    garbage = torch.where(live_blk, tables, 1 << 30)
    out = ragged_paged_attention_quant(q, kc, ks, vc, vs, garbage, seq)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert torch.equal(out, clean)


# -- the clustered decode body (csrc/ragged_decode.cuh), both pools -------------
#
# Held element by element: float32 |out - ref| <= 1e-4 (summation order
# only: the kernel sums each split's keys online, the plain version the
# whole window at once); bf16 q and output one bf16 ulp, 2^-7 |ref| + 1e-4
# (both compute in float32 from the same inputs and round once).

def _decode_close(out, ref):
    d = (out.float() - ref.float()).abs()
    rtol = 2.0 ** -7 if out.dtype == torch.bfloat16 else 0.0
    return bool((d <= rtol * ref.float().abs() + 1e-4).all())


def _decode_call(kind, dev, seed, nh, nkv, hd, bs, mb, lens, dt):
    """(kernel, plain) closures of one kernel on seeded inputs: the bf16 or
    float32 pool, or the int8 pool with q of dtype dt."""
    if kind == "rows":
        q, kp, vp, tables, seq = _ragged_inputs(dev, seed, nh, nkv, hd, bs,
                                                mb, lens)
        args = (q.to(dt), kp.to(dt), vp.to(dt), tables, seq)
        return (lambda: ragged_paged_attention(*args, scale=hd ** -0.5),
                lambda: ragged_paged_attention_plain(*args, hd ** -0.5))
    q, kc, ks, vc, vs, tables, seq = _quant_inputs(dev, seed, nh, nkv, hd,
                                                   bs, mb, lens)
    args = (q.to(dt), kc, ks, vc, vs, tables, seq)
    return (lambda: ragged_paged_attention_quant(*args, scale=hd ** -0.5),
            lambda: ragged_paged_attention_quant_plain(*args, hd ** -0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rows", "quant"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nrep", [1, 2, 4, 8])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_ragged_decode_matches_plain(cuda_device, kind, dt, nrep, hd):
    """Every instance of the body: lengths at the edges of a page (16
    tokens) and of a stage, one token, the whole table."""
    bs, mb, nkv = 16, 8, 2
    lens = [0, 1, bs - 1, bs, 77, mb * bs - 1]
    kernel, plain = _decode_call(kind, cuda_device, hd + nrep, nkv * nrep,
                                 nkv, hd, bs, mb, lens, dt)
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    assert out.dtype == dt
    assert _decode_close(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rows", "quant"])
def test_ragged_decode_empty_splits(cuda_device, kind):
    """Few clusters take the largest size, so one- and two-token windows
    leave most ranks of their cluster without a token."""
    nh = nkv = 4
    hd, bs, mb = 128, 16, 8
    C = decode_cluster_size(3, nh, nkv, hd, torch.bfloat16,
                            quant=kind == "quant")
    assert C == 8
    kernel, plain = _decode_call(kind, cuda_device, 3, nh, nkv, hd, bs, mb,
                                 [0, 1, 20], torch.bfloat16)
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert _decode_close(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rows", "quant"])
@pytest.mark.parametrize("nh,nkv", [(32, 32), (32, 8)])
def test_ragged_decode_gives_the_same_bits_twice(cuda_device, kind, nh, nkv):
    """The serve's shapes: 8 slots, hd 128, pages of 64 (rank-order merge,
    no atomics)."""
    bs, mb = 64, 32
    lens = [0, 63, 64, 300, 1000, 1500, 2000, 2047]
    kernel, _ = _decode_call(kind, cuda_device, nh + nkv, nh, nkv, 128, bs,
                             mb, lens, torch.bfloat16)
    a, b = kernel(), kernel()
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rows", "quant"])
def test_ragged_decode_replays_in_a_cuda_graph(cuda_device, kind):
    """One launch a call, captured in a CUDA graph: the replay writes what
    an eager call gives, and the wrapper counts the captured launch."""
    nh, nkv, bs, mb = 16, 4, 16, 8
    kernel, _ = _decode_call(kind, cuda_device, 7, nh, nkv, 128, bs, mb,
                             [5, 40, 127], torch.bfloat16)
    wrapper = (ragged_paged_attention if kind == "rows"
               else ragged_paged_attention_quant)
    eager = kernel()
    torch.cuda.synchronize()
    before = wrapper.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = kernel()
    assert wrapper.launches == before + 1
    captured.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


def _partials_close(o, lse, ro, rlse):
    """Per-shard o and lse against the plain partials: float32 1e-4 (the
    sums' order); an empty shard's o exactly 0 and its lse the plain
    version's, bit for bit."""
    live = rlse > -1e29
    assert torch.equal(live, lse > -1e29)
    assert (o - ro).abs().max().item() < 1e-4
    if live.any():
        assert (lse - rlse)[live].abs().max().item() < 1e-4
    assert (o[~live] == 0).all()
    assert torch.equal(lse[~live], rlse[~live])


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 2, 3, 8])
@pytest.mark.parametrize("nrep", [1, 2, 4, 8])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_partials_kernel_matches_plain(cuda_device, shards, nrep, hd):
    """Every instance of the partials (hd x nrep x dtype), 8 blocks in 1-8
    shards (3: the last narrower): per-shard o and lse against the plain
    partials (empty shards included), the merged result against the
    unsharded kernel."""
    bs, mb, nkv = 16, 8, 4
    nh = nkv * nrep
    lens = [0, bs - 1, bs, 77, mb * bs - 1]
    q, kp, vp, tables, seq = _ragged_inputs(cuda_device, shards + hd + nrep,
                                            nh, nkv, hd, bs, mb, lens)
    before = ragged_paged_attention_partials.launches
    for dt, tol in TOLS:
        args = (q.to(dt), kp.to(dt), vp.to(dt), tables, seq)
        o, lse = ragged_paged_attention_partials(*args, shards)
        ro, rlse = ragged_paged_attention_partials_plain(*args, shards,
                                                         hd ** -0.5)
        torch.cuda.synchronize()
        assert o.dtype == lse.dtype == torch.float32
        assert o.shape == ro.shape and lse.shape == rlse.shape
        _partials_close(o, lse, ro, rlse)
        merged = merge_partials(o, lse, dt)
        whole = ragged_paged_attention(*args)
        assert _decode_close(merged, whole)
        assert (merged.float() - whole.float()).abs().max().item() < tol
    assert ragged_paged_attention_partials.launches == before + 2


def _partials_inputs(dev, seed, nh, nkv, lens, dt=torch.bfloat16, hd=128,
                     bs=16, mb=8):
    q, kp, vp, tables, seq = _ragged_inputs(dev, seed, nh, nkv, hd, bs, mb,
                                            lens)
    return q.to(dt), kp.to(dt), vp.to(dt), tables, seq


@pytest.mark.cuda
def test_partials_kernel_clusters_and_empty_ranks(cuda_device):
    """A shape whose rule takes clusters (1 slot, 4 kv heads, 2 shards: 8
    clusters), so that short windows leave ranks, and the second shard,
    without a token."""
    C = partials_cluster_size(1, 4, 4, 128, 2, torch.bfloat16)
    assert C > 1
    for lens in ([0], [20], [64], [127]):
        args = _partials_inputs(cuda_device, 30 + lens[0], 4, 4, lens)
        o, lse = ragged_paged_attention_partials(*args, 2)
        ro, rlse = ragged_paged_attention_partials_plain(*args, 2,
                                                         128 ** -0.5)
        torch.cuda.synchronize()
        assert torch.isfinite(o).all() and torch.isfinite(lse).all()
        _partials_close(o, lse, ro, rlse)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_partials_kernel_never_reads_past_seq_lens(cuda_device, dt):
    """NaN in every pool row past each seq_len (inside the live page too)
    and in pages past it, garbage table entries past the live one: the
    partials equal the clean run's bit for bit."""
    bs, mb, nh, nkv, hd = 16, 8, 8, 2, 128
    lens = [3, 17, 40, 0, 100]
    q, kp, vp, tables, seq = _partials_inputs(cuda_device, 9, nh, nkv, lens,
                                              dt, hd, bs, mb)
    clean = ragged_paged_attention_partials(q, kp, vp, tables, seq, 3)
    pos = torch.arange(mb * bs, device=cuda_device)
    dead = pos[None, :] > seq.long()[:, None]
    rows = tables.long().repeat_interleave(bs, dim=1)
    lanes = (pos % bs)[None, :].expand(len(lens), -1)
    kp[rows[dead], lanes[dead]] = float("nan")
    vp[rows[dead], lanes[dead]] = float("nan")
    kp[0] = float("nan")
    vp[0] = float("nan")
    live_blk = torch.arange(mb, device=cuda_device)[None, :] <= \
        (seq.long() // bs)[:, None]
    garbage = torch.where(live_blk, tables, 1 << 30)
    o, lse = ragged_paged_attention_partials(q, kp, vp, garbage, seq, 3)
    torch.cuda.synchronize()
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert torch.equal(o, clean[0]) and torch.equal(lse, clean[1])


@pytest.mark.cuda
@pytest.mark.parametrize("nh,nkv", [(32, 32), (32, 8)])
def test_partials_kernel_gives_the_same_bits_twice(cuda_device, nh, nkv):
    """serve_long's shapes: 4 slots, hd 128, pages of 64, 64 blocks in 4
    shards (rank-order merges, no atomics)."""
    lens = [100, 4095, 1500, 3000]
    args = _partials_inputs(cuda_device, nh + nkv, nh, nkv, lens, hd=128,
                            bs=64, mb=64)
    a, b = (ragged_paged_attention_partials(*args, 4) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_partials_kernel_replays_in_a_cuda_graph(cuda_device):
    """One launch a call, captured in a CUDA graph: the replay writes what
    an eager call gives, and the wrapper counts the captured launch."""
    args = _partials_inputs(cuda_device, 8, 16, 4, [5, 40, 127])
    eager = ragged_paged_attention_partials(*args, 3)
    torch.cuda.synchronize()
    before = ragged_paged_attention_partials.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        o, lse = ragged_paged_attention_partials(*args, 3)
    assert ragged_paged_attention_partials.launches == before + 1
    o.zero_()
    lse.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(o, eager[0]) and torch.equal(lse, eager[1])


# -- the grouped (MoE expert) kernels -------------------------------------------
#
# Held element by element against the plain versions on the rows a route
# points at (padding rows are unspecified): float32 to 1e-6 |ref| + 1e-5 of
# the largest output (summation order over K, or over a group's rows for
# dw), bf16 to one bf16 ulp (2^-7 |ref|) plus the same.


def _grouped_inputs(dev, seed, t, k, n, e, bm, dtype, empty=None):
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.full(e, 0.5))          # skewed routing
    if empty is not None:
        p[empty] = 0
        p /= p.sum()
    ids = torch.from_numpy(rng.choice(e, t, p=p).astype(np.int32)).to(dev)
    md = grouped_metadata(ids, e, bm)
    tp = md["row_src"].shape[0]

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev).to(dtype)

    return md, rnd(tp, k), rnd(e, k, n), rnd(e, n), rnd(tp, n)


def _offset_view(t):
    """A copy of t one element past a 16-byte boundary: the tensor-core
    routes refuse it, so it takes the CUDA-core kernels."""
    flat = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
    return flat[1:].view_as(t).copy_(t)


def _grouped_close(out, ref, rows, bf16):
    o, r = out.float()[rows], ref.float()[rows]
    lim = 1e-5 * r.abs().max() + (2.0 ** -7 if bf16 else 1e-6) * r.abs()
    assert ((o - r).abs() <= lim).all(), (o - r).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["aligned", "offset"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,k,n,e,bm", [(300, 64, 96, 4, 8),
                                        (1000, 130, 36, 8, 128),
                                        (2048, 256, 512, 8, 128)])
def test_grouped_kernels_match_plain(cuda_device, dtype, t, k, n, e, bm,
                                     layout):
    """Forward with and without bias, the transposed forward (dx) and dw,
    on a skewed routing with one empty expert; with x and dy as views one
    element off a 16-byte boundary ("offset") every launch takes the
    CUDA-core kernels, dw's route counted."""
    md, x, w, b, dy = _grouped_inputs(cuda_device, t + k, t, k, n, e, bm,
                                      dtype, empty=1)
    if layout == "offset":
        x, dy = _offset_view(x), _offset_view(dy)
    dw_route = gm_dw_route(dtype, k, n, (x.data_ptr(), dy.data_ptr()))
    assert layout == "aligned" or dw_route == "cuda_core"
    off, cnt = md["offsets"], md["counts"]
    rows = md["dest"].long()
    bf16 = dtype == torch.bfloat16
    f0, d0 = grouped_matmul_fwd.launches, grouped_matmul_dw.launches
    r0 = dict(grouped_matmul_dw.route_launches)
    for bias in (b, None):
        out = grouped_matmul_fwd(x, w, bias, off, cnt, bm)
        ref = _ref_fwd(x, w, bias, off, cnt, bm, dtype)
        torch.cuda.synchronize()
        assert out.dtype == dtype
        _grouped_close(out, ref, rows, bf16)
    dx = grouped_matmul_fwd(dy, w, None, off, cnt, bm, transpose_w=True)
    ref = _ref_fwd(dy, w, None, off, cnt, bm, dtype, transpose_w=True)
    _grouped_close(dx, ref, rows, bf16)
    dw = grouped_matmul_dw(x, dy, off, cnt, bm, e)
    ref = _ref_dw(x, dy, off, cnt, bm, e)
    torch.cuda.synchronize()
    assert dw.dtype == torch.float32 and (dw[1] == 0).all()
    _grouped_close(dw, ref, slice(None), False)
    assert grouped_matmul_fwd.launches == f0 + 3
    assert grouped_matmul_dw.launches == d0 + 1
    assert grouped_matmul_dw.route_launches[dw_route] == r0[dw_route] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["aligned", "offset"])
def test_grouped_kernels_never_read_dead_rows(cuda_device, layout):
    """NaN in every row that is not a route's (padding inside a group's
    last tile, whole tiles past the groups): the routed outputs equal the
    clean run's, and dw stays finite and equal, on the tensor cores
    ("aligned") and, with x and dy one element off a 16-byte boundary, on
    the CUDA cores ("offset")."""
    md, x, w, b, dy = _grouped_inputs(cuda_device, 5, 700, 96, 160, 8, 128,
                                      torch.float32, empty=3)
    if layout == "offset":
        x, dy = _offset_view(x), _offset_view(dy)
    dw_route = {"aligned": "wgmma", "offset": "cuda_core"}[layout]
    assert gm_dw_route(x.dtype, 96, 160, (x.data_ptr(), dy.data_ptr())) \
        == dw_route
    r0 = grouped_matmul_dw.route_launches[dw_route]
    off, cnt = md["offsets"], md["counts"]
    valid = md["row_valid"]
    rows = md["dest"].long()
    clean = grouped_matmul_fwd(x, w, b, off, cnt, 128)
    dw_clean = grouped_matmul_dw(x, dy, off, cnt, 128, 8)
    x[~valid] = float("nan")
    dy[~valid] = float("nan")
    out = grouped_matmul_fwd(x, w, b, off, cnt, 128)
    dw = grouped_matmul_dw(x, dy, off, cnt, 128, 8)
    torch.cuda.synchronize()
    assert grouped_matmul_dw.route_launches[dw_route] == r0 + 2
    assert torch.equal(out[rows], clean[rows])
    assert torch.isfinite(dw).all() and torch.equal(dw, dw_clean)


@pytest.mark.cuda
def test_grouped_matmul_autograd_runs_the_kernels(cuda_device):
    md, x, w, b, _ = _grouped_inputs(cuda_device, 6, 500, 64, 128, 4, 128,
                                     torch.float32)
    ts = [t.clone().requires_grad_() for t in (x, w, b)]
    f0, d0 = grouped_matmul_fwd.launches, grouped_matmul_dw.launches
    out = grouped_matmul(*ts, group_offsets=md["offsets"],
                         group_counts=md["counts"], bm=128)
    out[md["dest"].long()].square().sum().backward()
    assert grouped_matmul_fwd.launches == f0 + 2      # forward and dx
    assert grouped_matmul_dw.launches == d0 + 1
    cpu = [t.detach().cpu().requires_grad_() for t in (x, w, b)]
    md_cpu = {k: v.cpu() for k, v in md.items()}
    ref = grouped_matmul(*cpu, group_offsets=md_cpu["offsets"],
                         group_counts=md_cpu["counts"], bm=128)
    ref[md_cpu["dest"].long()].square().sum().backward()
    valid = md_cpu["row_valid"]
    for t, c in zip(ts, cpu):
        g, r = t.grad.cpu(), c.grad
        if g.shape[0] == valid.shape[0]:
            g, r = g[valid], r[valid]
        assert (g - r).abs().max() <= 1e-5 * r.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n,block_k,bm,route", [
    (256, 96, None, 128, "wgmma"),
    (192, 520, 64, 128, "wgmma"),
    (768, 3072, 128, 128, "wgmma"),       # the MoE path's up projection
    (3072, 768, 128, 128, "wgmma"),       # and its down projection
    (768, 520, 64, 256, "wgmma"),
    (384, 520, 192, 128, "wgmma"),
    (130, 40, 65, 128, "cuda_core"),
    (192, 96, 96, 128, "cuda_core"),      # blocks of 1.5 stages
    (256, 96, 128, 64, "cuda_core")])     # 128-row tiles straddle groups
def test_quant_grouped_kernel_matches_plain(cuda_device, qdtype, dtype, k,
                                            n, block_k, bm, route):
    """Each route of `gq_route` against the plain version on a skewed
    routing of 900 routes with an empty expert (a partial last tile in
    every group): float32 x as three exact bf16 pieces on the tensor
    cores, bf16 x as it is."""
    md, x, w, _, _ = _grouped_inputs(cuda_device, k + n, 900, k, n, 8, bm,
                                     dtype, empty=0)
    codes, scales = quantize_weight_blockwise(w.float().transpose(1, 2),
                                              block_k, qdtype)
    before = quant_grouped_matmul.launches
    r0 = dict(quant_grouped_matmul.route_launches)
    out = quant_grouped_matmul(x, codes, scales, group_offsets=md["offsets"],
                               group_counts=md["counts"], bm=bm)
    ref = quant_grouped_matmul_plain(x, codes, scales, md["offsets"],
                                     md["counts"], bm)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    assert quant_grouped_matmul.launches == before + 1
    assert quant_grouped_matmul.route_launches[route] == r0[route] + 1
    _grouped_close(out, ref, md["dest"].long(), dtype == torch.bfloat16)


@pytest.mark.cuda
def test_quant_grouped_misaligned_x_takes_the_cuda_cores(cuda_device):
    """x 4 bytes off a 16-byte boundary: "cuda_core", right all the same;
    the C entry refuses the tensor-core route for it (error 1)."""
    md, x, w, _, _ = _grouped_inputs(cuda_device, 3, 500, 256, 96, 4, 128,
                                     torch.float32)
    codes, scales = quantize_weight_blockwise(w.transpose(1, 2))
    flat = torch.empty(1 + x.numel(), device=cuda_device)
    xo = flat[1:].view_as(x)
    xo.copy_(x)
    assert xo.data_ptr() % 16 == 4
    kw = dict(group_offsets=md["offsets"], group_counts=md["counts"],
              bm=128)
    r0 = quant_grouped_matmul.route_launches["cuda_core"]
    out = quant_grouped_matmul(xo, codes, scales, **kw)
    assert quant_grouped_matmul.route_launches["cuda_core"] == r0 + 1
    ref = quant_grouped_matmul_plain(xo, codes, scales, md["offsets"],
                                     md["counts"], 128)
    _grouped_close(out, ref, md["dest"].long(), False)
    lib = _build.load("quant_grouped_matmul", qmm_mod._GQ_SIG)
    e, n, k = codes.shape
    rc = lib.quant_grouped_matmul_fwd(
        xo.data_ptr(), codes.data_ptr(), scales.data_ptr(), out.data_ptr(),
        md["offsets"].data_ptr(), md["counts"].data_ptr(), e, x.shape[0], k,
        n, scales.shape[2], k // scales.shape[2], 128, 0, 0, 1,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 1


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_grouped_wgmma_dead_rows_inf_and_repeat(cuda_device, qdtype,
                                                      dtype):
    """On the tensor-core route: two launches give the same bits; NaN in
    every row that is not a route's (padding in a group's last tile, the
    tiles past the groups) leaves the routed rows bit for bit as they
    were; an x row of +inf and a single -inf give what the plain version
    gives (inf, -inf or NaN in the same places, the rest within the
    rule)."""
    md, x, w, _, _ = _grouped_inputs(cuda_device, 17, 700, 768, 520, 8, 128,
                                     dtype, empty=3)
    codes, scales = quantize_weight_blockwise(w.float().transpose(1, 2),
                                              None, qdtype)
    kw = dict(group_offsets=md["offsets"], group_counts=md["counts"],
              bm=128)
    rows = md["dest"].long()
    r0 = quant_grouped_matmul.route_launches["wgmma"]
    clean = quant_grouped_matmul(x, codes, scales, **kw)
    again = quant_grouped_matmul(x, codes, scales, **kw)
    assert torch.equal(clean[rows], again[rows])
    xp = x.clone()
    xp[~md["row_valid"]] = float("nan")
    poisoned = quant_grouped_matmul(xp, codes, scales, **kw)
    assert torch.isfinite(poisoned[rows]).all()
    assert torch.equal(poisoned[rows], clean[rows])
    xi = x.clone()
    xi[rows[5]] = float("inf")
    xi[rows[6], 3] = float("-inf")
    out = quant_grouped_matmul(xi, codes, scales, **kw)[rows].float()
    ref = quant_grouped_matmul_plain(xi, codes, scales, md["offsets"],
                                     md["counts"], 128)[rows].float()
    torch.cuda.synchronize()
    assert quant_grouped_matmul.route_launches["wgmma"] == r0 + 4
    fin = torch.isfinite(ref)
    assert not fin[5].any() and not fin[6].all()
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    assert torch.equal(out[~fin].nan_to_num(0.0), ref[~fin].nan_to_num(0.0))
    _grouped_close(torch.where(fin, out, 0.0), torch.where(fin, ref, 0.0),
                   slice(None), dtype == torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("k,bk", [(64, 64), (256, 128), (768, 64)])
def test_split3_one_tile_matches_matmul(cuda_device, k, bk):
    """csrc/wgmma.cuh's `split3_store8` on one 64 x 128 tile: float32 b
    split into hi, mid and lo bf16 tiles, three chained m64n128k16 wgmmas a
    k16 step against int8-valued A, per-row scales a K-block on the
    accumulator, against float64 matmuls of the same values. b's rows span
    2^-40 to 2^40 of unit size; each column is held to 1e-6 |ref| + 1e-5 of
    its largest output, the float32 rule: the products are exact, only the
    float32 sums differ. One b row holds a +inf and one a NaN whose payload
    sits in the low 16 bits: their columns are inf, -inf or NaN exactly
    where float64 gives them."""
    rng = np.random.default_rng(k + bk)
    a = torch.from_numpy(rng.integers(-127, 128, (64, k)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    b = rng.standard_normal((128, k)).astype(np.float32)
    b *= (2.0 ** rng.integers(-40, 41, (128, 1))).astype(np.float32)
    b[7, 5] = np.inf
    b[9, k - 1] = np.array([0x7F800001], dtype=np.uint32).view(np.float32)[0]
    b = torch.from_numpy(b).to(cuda_device)
    scales = torch.from_numpy(rng.uniform(0.5, 2.0, (64, k // bk)).astype(
        np.float32)).to(cuda_device)
    out = torch.empty(64, 128, device=cuda_device)
    lib = _build.load("wgmma_selftest", _SELFTEST_SIG)
    rc = lib.split3_selftest(a.data_ptr(), b.data_ptr(), scales.data_ptr(),
                             out.data_ptr(), k, bk,
                             torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"CUDA error {rc}"
    ref = torch.zeros(64, 128, device=cuda_device, dtype=torch.float64)
    for j in range(k // bk):
        blk = slice(j * bk, (j + 1) * bk)
        ref += scales[:, j:j + 1].double() * torch.matmul(
            a[:, blk].double(), b[:, blk].double().t())
    torch.cuda.synchronize()
    out = out.double()
    fin = torch.isfinite(ref)
    assert not fin[:, 7].all() and torch.isnan(ref[:, 9]).all()
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    assert torch.equal(out[~fin].nan_to_num(0.0), ref[~fin].nan_to_num(0.0))
    ref_f, out_f = torch.where(fin, ref, 0.0), torch.where(fin, out, 0.0)
    lim = 1e-6 * ref_f.abs() + 1e-5 * ref_f.abs().amax(0, keepdim=True)
    assert ((out_f - ref_f).abs() <= lim).all(), \
        ((out_f - ref_f).abs() / lim).max().item()


# -- packed (varlen) and FlashMask attention ------------------------------------
#
# Outputs and lse held as the dense flash kernels' (TOLS), gradients as the
# dense backward's (BWD_TOLS): both sides compute in float32 from the same
# inputs and differ in summation order only.

VARLEN_PACKS = {
    # documents no tile divides, total 1000
    "total_1000": ((1, 63, 64, 65, 300, 7, 500), None, True),
    # an empty document in the middle and one at the end
    "empty_docs": ((200, 0, 150, 90, 0), None, True),
    # unequal packs, not causal, with an empty k document: keyless q rows
    "unequal_keyless": ((120, 77, 200, 64), (90, 0, 130, 300), False),
}


def _varlen_inputs(dev, seed, lq, lk, h, d):
    rng = np.random.default_rng(seed)
    cu_q = torch.tensor(np.cumsum([0] + list(lq)), dtype=torch.int32,
                        device=dev)
    cu_k = torch.tensor(np.cumsum([0] + list(lk)), dtype=torch.int32,
                        device=dev)
    tq, tk = int(sum(lq)), int(sum(lk))

    def rnd(n):
        return torch.from_numpy(rng.standard_normal((n, h, d))
                                .astype(np.float32)).to(dev)

    return rnd(tq), rnd(tk), rnd(tk), rnd(tq), cu_q, cu_k


def _check_fwd(o, lse, ro, rlse, tol):
    assert o.dtype == ro.dtype and lse.dtype == torch.float32
    assert (o.float() - ro.float()).abs().max().item() < tol
    assert (lse - rlse).abs().max().item() < tol


def _check_bwd(got, ref, dt, rtol, atol):
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == dt
        ok, err = _bwd_close(g, r, rtol, atol)
        assert ok, f"{name} {dt}: max abs err {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("pack", sorted(VARLEN_PACKS))
def test_varlen_kernels_match_plain(cuda_device, d, pack):
    lq, lk, causal = VARLEN_PACKS[pack]
    lk = lq if lk is None else lk
    q, k, v, do, cu_q, cu_k = _varlen_inputs(cuda_device, d, lq, lk, 3, d)
    sq, pq = segments_from_cu(cu_q, q.shape[0])
    sk, pk = segments_from_cu(cu_k, k.shape[0])
    scale = d ** -0.5
    f0, b0 = flash_varlen_fwd.launches, flash_varlen_bwd.launches
    for (dt, tol), (_, rtol, atol) in zip(TOLS, BWD_TOLS):
        qt, kt, vt, dot = (x.to(dt) for x in (q, k, v, do))
        o, lse = flash_varlen_fwd(qt, kt, vt, sq, pq, sk, pk, causal, scale)
        ro, rlse = flash_varlen_fwd_plain(qt, kt, vt, sq, pq, sk, pk, causal,
                                          scale)
        got = flash_varlen_bwd(qt, kt, vt, ro, rlse, dot, sq, pq, sk, pk,
                               causal, scale)
        ref = flash_varlen_bwd_plain(qt, kt, vt, ro, rlse, dot, sq, pq, sk,
                                     pk, causal, scale)
        torch.cuda.synchronize()
        _check_fwd(o, lse, ro, rlse, tol)
        _check_bwd(got, ref, dt, rtol, atol)
        if pack == "unequal_keyless":
            rows = slice(int(lq[0]), int(lq[0] + lq[1]))   # keyless rows
            assert not o[rows].any() and not got[0][rows].any()
    assert flash_varlen_fwd.launches == f0 + 2
    assert flash_varlen_bwd.launches == b0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_varlen_nan_in_one_document_stays_there(cuda_device, causal):
    """NaN in one document's K and V (documents share tiles with it):
    every other document's outputs and gradients are finite and equal to
    an unpoisoned run's."""
    lens = (70, 45, 130, 33, 240)
    q, k, v, g, cu, _ = _varlen_inputs(cuda_device, 3, lens, lens, 4, 128)
    runs = []
    for poison in (False, True):
        kk, vv = k.clone(), v.clone()
        if poison:
            kk[115:245] = float("nan")                # the third document
            vv[115:245] = float("nan")
        ts = [t.clone().requires_grad_() for t in (q, kk, vv)]
        out = flash_attn_unpadded(*ts, cu, cu, 240, 240, 128 ** -0.5,
                                  causal=causal)
        out.backward(g)
        runs.append([out.detach()] + [t.grad for t in ts])
    torch.cuda.synchronize()
    keep = torch.ones(q.shape[0], dtype=torch.bool, device=cuda_device)
    keep[115:245] = False
    for clean, poisoned in zip(*runs):
        assert torch.isfinite(poisoned[keep]).all()
        assert torch.equal(poisoned[keep], clean[keep])


@pytest.mark.cuda
def test_varlen_bwd_takes_a_strided_do(cuda_device):
    q, k, v, _, cu, _ = _varlen_inputs(cuda_device, 4, (50, 150, 100),
                                       (50, 150, 100), 4, 64)
    sq, pq = segments_from_cu(cu, 300)
    do = torch.randn(64, 4, 300, device=cuda_device).permute(2, 1, 0)
    assert not do.is_contiguous()
    o, lse = flash_varlen_fwd(q, k, v, sq, pq, sq, pq, True, 0.125)
    got = flash_varlen_bwd(q, k, v, o, lse, do, sq, pq, sq, pq, True, 0.125)
    ref = flash_varlen_bwd_plain(q, k, v, o, lse, do.contiguous(), sq, pq,
                                 sq, pq, True, 0.125)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert _bwd_close(g, r, 0.0, 1e-4)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_varlen_autograd_matches_plain_autograd(cuda_device, causal):
    """flash_attn_unpadded (both varlen kernels) against torch.autograd
    through the plain forward, float32, q, k and v read in place from a
    packed [total, 3, H, D] tensor."""
    torch.backends.cuda.matmul.allow_tf32 = False
    lens = (37, 200, 1, 150)
    rng = np.random.default_rng(22)
    qkv_n = rng.standard_normal((388, 3, 4, 64)).astype(np.float32)
    g = torch.from_numpy(rng.standard_normal((388, 4, 64))
                         .astype(np.float32)).to(cuda_device)
    cu = torch.tensor(np.cumsum((0,) + lens), dtype=torch.int32,
                      device=cuda_device)
    qkv = torch.from_numpy(qkv_n).to(cuda_device).requires_grad_()
    before = flash_varlen_bwd.launches
    out = flash_attn_varlen_qkvpacked(qkv, cu, cu, 200, 200, causal=causal)
    out.backward(g)
    assert flash_varlen_bwd.launches == before + 1
    ref_in = torch.from_numpy(qkv_n).to(cuda_device).requires_grad_()
    seg, pos = segments_from_cu(cu, 388)
    ref, _ = flash_varlen_fwd_plain(ref_in[:, 0], ref_in[:, 1],
                                    ref_in[:, 2], seg, pos, seg, pos,
                                    causal, 64 ** -0.5)
    ref.backward(g)
    torch.cuda.synchronize()
    assert _bwd_close(out.detach(), ref.detach(), 0.0, 1e-4)[0]
    assert _bwd_close(qkv.grad, ref_in.grad, 0.0, 1e-4)[0]


@pytest.mark.cuda
def test_varlen_kernels_reject_what_they_do_not_take(cuda_device):
    q = torch.randn(100, 2, 96, device=cuda_device)
    seg, pos = segments_from_cu(torch.tensor([0, 100], device=cuda_device),
                                100)
    with pytest.raises(ValueError):
        flash_varlen_fwd(q, q, q, seg, pos, seg, pos, True, 0.1)   # D 96
    q = torch.randn(100, 2, 64, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="flash_attn_unpadded"):
        flash_varlen_fwd(q, q.detach(), q.detach(), seg, pos, seg, pos,
                         True, 0.1)


def _doc_start(dev, lens, b, h):
    ends = np.cumsum(lens)
    row = torch.from_numpy(np.repeat(ends, lens).astype(np.int32)).to(dev)
    return row.expand(b * h, -1).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", ["random", "documents"])
def test_sparse_mask_kernels_match_plain(cuda_device, d, causal, kind):
    """S 200 (no tile divides it); random start rows as the JAX test draws
    them (some rows see no column) or documents as start rows."""
    b, s, h = 2, 200, 3
    rng = np.random.default_rng(d + causal)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, s, h, d))
                                    .astype(np.float32)).to(cuda_device)
                   for _ in range(4))
    if kind == "random":
        start = torch.from_numpy(rng.integers(1, s + 1, (b * h, s))
                                 .astype(np.int32)).to(cuda_device)
    else:
        start = _doc_start(cuda_device, (33, 100, 67), b, h)
    scale = d ** -0.5
    f0, b0 = flash_sparse_mask_fwd.launches, flash_sparse_mask_bwd.launches
    for (dt, tol), (_, rtol, atol) in zip(TOLS, BWD_TOLS):
        qt, kt, vt, dot = (x.to(dt) for x in (q, k, v, do))
        o, lse = flash_sparse_mask_fwd(qt, kt, vt, start, causal, scale)
        ro, rlse = flash_sparse_mask_fwd_plain(qt, kt, vt, start, causal,
                                               scale)
        got = flash_sparse_mask_bwd(qt, kt, vt, ro, rlse, dot, start, causal,
                                    scale)
        ref = flash_sparse_mask_bwd_plain(qt, kt, vt, ro, rlse, dot, start,
                                          causal, scale)
        torch.cuda.synchronize()
        _check_fwd(o, lse, ro, rlse, tol)
        _check_bwd(got, ref, dt, rtol, atol)
    assert flash_sparse_mask_fwd.launches == f0 + 2
    assert flash_sparse_mask_bwd.launches == b0 + 2


@pytest.mark.cuda
def test_sparse_mask_nan_in_one_document_stays_there(cuda_device):
    b, s, h, d = 2, 256, 2, 64
    rng = np.random.default_rng(31)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((b, s, h, d))
                                   .astype(np.float32)).to(cuda_device)
                  for _ in range(4))
    start = _doc_start(cuda_device, (50, 90, 116), 1, 1)[0]     # [S]
    runs = []
    for poison in (False, True):
        kk, vv = k.clone(), v.clone()
        if poison:
            kk[:, 50:140] = float("nan")
            vv[:, 50:140] = float("nan")
        ts = [t.clone().requires_grad_() for t in (q, kk, vv)]
        out = flash_attention_with_sparse_mask(ts[0], ts[1], ts[2], start,
                                               is_causal=True)
        out.backward(g)
        runs.append([out.detach()] + [t.grad for t in ts])
    torch.cuda.synchronize()
    keep = torch.ones(s, dtype=torch.bool, device=cuda_device)
    keep[50:140] = False
    for clean, poisoned in zip(*runs):
        assert torch.isfinite(poisoned[:, keep]).all()
        assert torch.equal(poisoned[:, keep], clean[:, keep])


@pytest.mark.cuda
def test_sparse_mask_autograd_matches_plain_autograd(cuda_device):
    """flash_attention_with_sparse_mask (both kernels) against autograd
    through the plain forward, float32, [B, 1, S] start rows, strided
    [B, S, H, D] views of a wider tensor."""
    torch.backends.cuda.matmul.allow_tf32 = False
    b, s, h, d = 2, 160, 4, 64
    rng = np.random.default_rng(23)
    wide = rng.standard_normal((b, s, 2 * h, d)).astype(np.float32)
    g = torch.from_numpy(rng.standard_normal((b, s, h, d))
                         .astype(np.float32)).to(cuda_device)
    start = torch.from_numpy(rng.integers(1, s + 1, (b, 1, s))
                             .astype(np.int32)).to(cuda_device)
    grads = []
    for kernel in (True, False):
        x = torch.from_numpy(wide).to(cuda_device).requires_grad_()
        q, k, v = x[:, :, :h], x[:, :, h:], x[:, :, h:] * 0.5
        if kernel:
            out = flash_attention_with_sparse_mask(q, k, v, start,
                                                   is_causal=True)
        else:
            st = start.expand(b, h, s).reshape(b * h, s)
            out, _ = flash_sparse_mask_fwd_plain(q, k, v, st, True,
                                                 d ** -0.5)
        out.backward(g)
        grads.append((out.detach(), x.grad))
    torch.cuda.synchronize()
    for got, ref in zip(*grads):
        assert _bwd_close(got, ref, 0.0, 1e-4)[0]


# -- the masked forward on the tensor cores ------------------------------------
#
# bf16 at D 64 and 128 takes masked_fwd_wgmma (route "wgmma"), held to
# chip_smoke.py's bf16 rule (FWD_RTOL, FWD_ATOL, LSE_ATOL); float32 and
# D 256 keep the CUDA-core kernel. q tiles of 64 rows span documents in
# every pack here, so every policy's pair test and NaN guard run.

@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("pack", sorted(VARLEN_PACKS))
def test_varlen_fwd_wgmma_matches_plain(cuda_device, d, causal, pack):
    lq, lk, _ = VARLEN_PACKS[pack]
    lk = lq if lk is None else lk
    q, k, v, _, cu_q, cu_k = _varlen_inputs(cuda_device, d + causal, lq, lk,
                                            4, d)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    sq, pq = segments_from_cu(cu_q, q.shape[0])
    sk, pk = segments_from_cu(cu_k, k.shape[0])
    before = flash_varlen_fwd.route_launches["wgmma"]
    o, lse = flash_varlen_fwd(q, k, v, sq, pq, sk, pk, causal, d ** -0.5)
    ro, rlse = flash_varlen_fwd_plain(q, k, v, sq, pq, sk, pk, causal,
                                      d ** -0.5)
    torch.cuda.synchronize()
    assert flash_varlen_fwd.route_launches["wgmma"] == before + 1
    ratio, lse_err = _fwd_errs(o, lse, ro, rlse)
    assert ratio <= 1.0, f"o: {ratio} x the bf16 rule"
    assert lse_err <= LSE_ATOL, f"lse: max abs err {lse_err}"
    cq = np.cumsum([0] + list(lq))
    for i in range(len(lq)):
        if lq[i] and not lk[i]:                   # a keyless document
            rows = slice(int(cq[i]), int(cq[i + 1]))
            assert not o[rows].any()
            assert (lse[:, rows] == KEYLESS_LSE).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind,s", [("random", 200), ("documents", 256),
                                    ("capped", 200)])
def test_sparse_mask_fwd_wgmma_matches_plain(cuda_device, d, causal, kind,
                                             s):
    """Random start rows (S 200: a tail tile), documents as start rows,
    and start rows capped at 100, whose rows from 100 on see no column
    without causal (keyless: o 0, lse KEYLESS_LSE)."""
    b, h = 2, 3
    rng = np.random.default_rng(d + causal + s)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d))
                                .astype(np.float32))
               .to(cuda_device, torch.bfloat16) for _ in range(3))
    if kind == "documents":
        start = _doc_start(cuda_device, (33, 100, 67, 56), b, h)
    else:
        st = rng.integers(1, s + 1, (b * h, s))
        if kind == "capped":
            st = np.minimum(st, 100)
        start = torch.from_numpy(st.astype(np.int32)).to(cuda_device)
    before = flash_sparse_mask_fwd.route_launches["wgmma"]
    o, lse = flash_sparse_mask_fwd(q, k, v, start, causal, d ** -0.5)
    ro, rlse = flash_sparse_mask_fwd_plain(q, k, v, start, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert flash_sparse_mask_fwd.route_launches["wgmma"] == before + 1
    ratio, lse_err = _fwd_errs(o, lse, ro, rlse)
    assert ratio <= 1.0, f"o: {ratio} x the bf16 rule"
    assert lse_err <= LSE_ATOL, f"lse: max abs err {lse_err}"
    if kind == "capped" and not causal:
        assert not o[:, 100:].any()
        assert (lse[:, 100:] == KEYLESS_LSE).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dt,d", [(torch.float32, 64), (torch.float32, 128),
                                  (torch.bfloat16, 256)])
def test_masked_fwd_cuda_core_route(cuda_device, dt, d):
    """float32 and D 256 keep the CUDA-core forward of both policies."""
    lens = (100, 37, 250, 125)
    q, k, v, _, cu, _ = _varlen_inputs(cuda_device, d, lens, lens, 2, d)
    q, k, v = (x.to(dt) for x in (q, k, v))
    sq, pq = segments_from_cu(cu, q.shape[0])
    before = flash_varlen_fwd.route_launches["cuda_core"]
    o, lse = flash_varlen_fwd(q, k, v, sq, pq, sq, pq, True, d ** -0.5)
    ro, rlse = flash_varlen_fwd_plain(q, k, v, sq, pq, sq, pq, True,
                                      d ** -0.5)
    assert flash_varlen_fwd.route_launches["cuda_core"] == before + 1
    q4, k4, v4 = (x[:256].reshape(1, 256, 2, d) for x in (q, k, v))
    start = _doc_start(cuda_device, (100, 37, 119), 1, 2)
    before = flash_sparse_mask_fwd.route_launches["cuda_core"]
    o4, lse4 = flash_sparse_mask_fwd(q4, k4, v4, start, True, d ** -0.5)
    ro4, rlse4 = flash_sparse_mask_fwd_plain(q4, k4, v4, start, True,
                                             d ** -0.5)
    torch.cuda.synchronize()
    assert flash_sparse_mask_fwd.route_launches["cuda_core"] == before + 1
    tol = dict(TOLS)[dt]
    _check_fwd(o, lse, ro, rlse, tol)
    _check_fwd(o4, lse4, ro4, rlse4, tol)


@pytest.mark.cuda
def test_varlen_fwd_wgmma_reads_a_packed_qkv_in_place(cuda_device):
    """flash_attn_varlen_qkvpacked in bf16: q, k and v are strided slices
    of [total, 3, H, D] (row stride 3 H D), read in place on the tensor
    cores. A slice misaligned by 4 elements takes the CUDA-core kernel."""
    lens = (37, 200, 1, 150, 95)
    rng = np.random.default_rng(24)
    total, h, d = sum(lens), 4, 128
    qkv = torch.from_numpy(rng.standard_normal((total, 3, h, d + 4))
                           .astype(np.float32)).to(cuda_device,
                                                   torch.bfloat16)
    cu = torch.tensor(np.cumsum((0,) + lens), dtype=torch.int32,
                      device=cuda_device)
    seg, pos = segments_from_cu(cu, total)
    aligned = qkv[..., :d].contiguous()
    before = dict(flash_varlen_fwd.route_launches)
    with torch.no_grad():
        out = flash_attn_varlen_qkvpacked(aligned, cu, cu, 200, 200,
                                          causal=True)
    ref, _ = flash_varlen_fwd_plain(aligned[:, 0], aligned[:, 1],
                                    aligned[:, 2], seg, pos, seg, pos, True,
                                    d ** -0.5)
    assert flash_varlen_fwd.route_launches["wgmma"] == before["wgmma"] + 1
    shifted = qkv[..., 4:]                         # 8-byte offset rows
    o, lse = flash_varlen_fwd(shifted[:, 0], shifted[:, 1], shifted[:, 2],
                              seg, pos, seg, pos, True, d ** -0.5)
    ro, rlse = flash_varlen_fwd_plain(shifted[:, 0], shifted[:, 1],
                                      shifted[:, 2], seg, pos, seg, pos,
                                      True, d ** -0.5)
    torch.cuda.synchronize()
    assert flash_varlen_fwd.route_launches["cuda_core"] == \
        before["cuda_core"] + 1
    d_ = (out.float() - ref.float()).abs()
    assert (d_ / (FWD_RTOL * ref.float().abs() + FWD_ATOL)).max() <= 1.0
    ratio, lse_err = _fwd_errs(o, lse, ro, rlse)
    assert ratio <= 1.0 and lse_err <= LSE_ATOL


@pytest.mark.cuda
def test_masked_fwd_c_refuses_a_route_that_cannot_take_its_inputs(
        cuda_device):
    """The C entry point never picks a route: asked for the tensor cores
    with float32, D 256 or a misaligned stride it returns
    cudaErrorInvalidValue (1) and launches nothing."""
    from paddle_tpu_torch.kernels import flash_varlen as fv
    lib = _build.load("flash_varlen", fv._SIG)
    seg, pos = segments_from_cu(torch.tensor([0, 100], device=cuda_device),
                                100)
    rq = fv.varlen_tile_ranges(seg, pos, seg, pos, fv.BQ, True, True)
    for dt, d, stride in ((torch.float32, 128, 128), (torch.bfloat16, 256,
                                                      256),
                          (torch.bfloat16, 128, 132)):
        x = torch.zeros(100, 1, stride, dtype=dt, device=cuda_device)
        q = x[..., :d]
        o = torch.zeros(100, 1, d, dtype=dt, device=cuda_device)
        lse = torch.zeros(1, 100, device=cuda_device)
        rc = lib.flash_varlen_fwd(
            q.data_ptr(), q.data_ptr(), q.data_ptr(), o.data_ptr(),
            lse.data_ptr(), seg.data_ptr(), pos.data_ptr(), seg.data_ptr(),
            pos.data_ptr(), rq.data_ptr(), rq.shape[0], 1, 100, 100, d,
            q.stride(0), q.stride(1), q.stride(0), q.stride(1), q.stride(0),
            q.stride(1), 0.1, 1, 0 if dt == torch.float32 else 1, 1,
            torch.cuda.current_stream().cuda_stream)
        assert rc == 1, (dt, d, stride)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_varlen_nan_in_one_document_stays_there_bf16(cuda_device, causal):
    """The bf16 twin of test_varlen_nan_in_one_document_stays_there: the
    forward runs on the tensor cores, where p = 0 times a NaN V would be
    NaN, so the guard must keep the poisoned document's V out of the q
    tiles it shares with others: every other document's outputs and
    gradients finite and bit-equal to an unpoisoned run's."""
    lens = (70, 45, 130, 33, 240)
    q, k, v, g, cu, _ = _varlen_inputs(cuda_device, 3, lens, lens, 4, 128)
    q, k, v, g = (x.to(torch.bfloat16) for x in (q, k, v, g))
    before = flash_varlen_fwd.route_launches["wgmma"]
    runs = []
    for poison in (False, True):
        kk, vv = k.clone(), v.clone()
        if poison:
            kk[115:245] = float("nan")                # the third document
            vv[115:245] = float("nan")
        ts = [t.clone().requires_grad_() for t in (q, kk, vv)]
        out = flash_attn_unpadded(*ts, cu, cu, 240, 240, 128 ** -0.5,
                                  causal=causal)
        out.backward(g)
        runs.append([out.detach()] + [t.grad for t in ts])
    torch.cuda.synchronize()
    assert flash_varlen_fwd.route_launches["wgmma"] == before + 2
    keep = torch.ones(q.shape[0], dtype=torch.bool, device=cuda_device)
    keep[115:245] = False
    assert torch.isnan(runs[1][0][~keep]).all()
    for clean, poisoned in zip(*runs):
        assert torch.isfinite(poisoned[keep]).all()
        assert torch.equal(poisoned[keep], clean[keep])


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["nan", "inf", "inf_v"])
def test_sparse_mask_nan_in_one_document_stays_there_bf16(cuda_device,
                                                          what):
    """The bf16 twin of test_sparse_mask_nan_in_one_document_stays_there,
    with NaN and with inf in K and V, and with inf in V alone: the
    tensor-core forward's guard. Every tile the poisoned document's rows
    visit holds another document's rows or columns, so the guard turns all
    of those rows into NaN, inf_v too, where a row that sees every
    poisoned column would be inf in exact arithmetic (the guard keeps NaN,
    not inf: csrc/flash_masked.cuh)."""
    b, s, h, d = 2, 256, 2, 64
    rng = np.random.default_rng(31)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((b, s, h, d))
                                   .astype(np.float32))
                  .to(cuda_device, torch.bfloat16) for _ in range(4))
    start = _doc_start(cuda_device, (50, 90, 116), 1, 1)[0]     # [S]
    before = flash_sparse_mask_fwd.route_launches["wgmma"]
    runs = []
    for poison in (False, True):
        kk, vv = k.clone(), v.clone()
        if poison:
            if what != "inf_v":
                kk[:, 50:140] = float(what)
            vv[:, 50:140] = float(what[:3])
        ts = [t.clone().requires_grad_() for t in (q, kk, vv)]
        out = flash_attention_with_sparse_mask(ts[0], ts[1], ts[2], start,
                                               is_causal=True)
        out.backward(g)
        runs.append([out.detach()] + [t.grad for t in ts])
    torch.cuda.synchronize()
    assert flash_sparse_mask_fwd.route_launches["wgmma"] == before + 2
    keep = torch.ones(s, dtype=torch.bool, device=cuda_device)
    keep[50:140] = False
    assert torch.isnan(runs[1][0][:, ~keep]).all()
    for clean, poisoned in zip(*runs):
        assert torch.isfinite(poisoned[:, keep]).all()
        assert torch.equal(poisoned[:, keep], clean[:, keep])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_masked_bwd_reads_the_wgmma_forward(cuda_device, d):
    """The tensor-core backward of both policies on the tensor-core
    forward's o and lse, against the plain backward on the same o and lse
    (BWD_TOLS's bf16 rule)."""
    lens = (120, 77, 200, 64, 39)
    q, k, v, do, cu, _ = _varlen_inputs(cuda_device, 5 + d, lens, lens, 3,
                                        d)
    q, k, v, do = (x.to(torch.bfloat16) for x in (q, k, v, do))
    sq, pq = segments_from_cu(cu, q.shape[0])
    before = flash_varlen_fwd.route_launches["wgmma"]
    o, lse = flash_varlen_fwd(q, k, v, sq, pq, sq, pq, True, d ** -0.5)
    assert flash_varlen_fwd.route_launches["wgmma"] == before + 1
    before = flash_varlen_bwd.route_launches["wgmma"]
    got = flash_varlen_bwd(q, k, v, o, lse, do, sq, pq, sq, pq, True,
                           d ** -0.5)
    assert flash_varlen_bwd.route_launches["wgmma"] == before + 1
    ref = flash_varlen_bwd_plain(q, k, v, o, lse, do, sq, pq, sq, pq, True,
                                 d ** -0.5)
    q4, k4, v4, do4 = (x[:, :2].reshape(2, 250, 2, d)
                       for x in (q, k, v, do))
    start = _doc_start(cuda_device, (120, 77, 53), 2, 2)
    before = flash_sparse_mask_fwd.route_launches["wgmma"]
    o4, lse4 = flash_sparse_mask_fwd(q4, k4, v4, start, True, d ** -0.5)
    assert flash_sparse_mask_fwd.route_launches["wgmma"] == before + 1
    before = flash_sparse_mask_bwd.route_launches["wgmma"]
    got4 = flash_sparse_mask_bwd(q4, k4, v4, o4, lse4, do4, start, True,
                                 d ** -0.5)
    assert flash_sparse_mask_bwd.route_launches["wgmma"] == before + 1
    ref4 = flash_sparse_mask_bwd_plain(q4, k4, v4, o4, lse4, do4, start,
                                       True, d ** -0.5)
    torch.cuda.synchronize()
    _check_bwd(got, ref, torch.bfloat16, *BWD_TOLS[1][1:])
    _check_bwd(got4, ref4, torch.bfloat16, *BWD_TOLS[1][1:])


# -- the masked backward on the tensor cores -----------------------------------
#
# bf16 at D 64 and 128 takes masked_dq_wgmma + masked_dkv_wgmma (route
# "wgmma"), held to BWD_TOLS's bf16 rule against the plain backward on the
# same o and lse; float32 and D 256 keep the CUDA-core pair. The packs and
# start rows are the forward's card tests': 64-row q tiles and 64-key k
# tiles span documents, so the pair test and the NaN guard run in both
# kernels.

@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("pack", sorted(VARLEN_PACKS))
def test_varlen_bwd_wgmma_matches_plain(cuda_device, d, causal, pack):
    lq, lk, _ = VARLEN_PACKS[pack]
    lk = lq if lk is None else lk
    q, k, v, do, cu_q, cu_k = _varlen_inputs(cuda_device, 2 * d + causal,
                                             lq, lk, 4, d)
    q, k, v, do = (x.to(torch.bfloat16) for x in (q, k, v, do))
    sq, pq = segments_from_cu(cu_q, q.shape[0])
    sk, pk = segments_from_cu(cu_k, k.shape[0])
    seg = (sq, pq, sk, pk, causal, d ** -0.5)
    o, lse = flash_varlen_fwd(q, k, v, *seg)
    before = flash_varlen_bwd.route_launches["wgmma"]
    got = flash_varlen_bwd(q, k, v, o, lse, do, *seg)
    ref = flash_varlen_bwd_plain(q, k, v, o, lse, do, *seg)
    torch.cuda.synchronize()
    assert flash_varlen_bwd.route_launches["wgmma"] == before + 1
    _check_bwd(got, ref, torch.bfloat16, *BWD_TOLS[1][1:])
    cq = np.cumsum([0] + list(lq))
    for i in range(len(lq)):
        if lq[i] and not lk[i]:                   # keyless rows: dq 0
            assert not got[0][int(cq[i]):int(cq[i + 1])].any()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind,s", [("random", 200), ("documents", 256),
                                    ("capped", 200)])
def test_sparse_mask_bwd_wgmma_matches_plain(cuda_device, d, causal, kind,
                                             s):
    """The forward's start rows: random (S 200, a tail tile), documents,
    and capped at 100 (without causal, rows from 100 on see no column:
    their dq is 0)."""
    b, h = 2, 3
    rng = np.random.default_rng(2 * d + causal + s)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, s, h, d))
                                    .astype(np.float32))
                   .to(cuda_device, torch.bfloat16) for _ in range(4))
    if kind == "documents":
        start = _doc_start(cuda_device, (33, 100, 67, 56), b, h)
    else:
        st = rng.integers(1, s + 1, (b * h, s))
        if kind == "capped":
            st = np.minimum(st, 100)
        start = torch.from_numpy(st.astype(np.int32)).to(cuda_device)
    o, lse = flash_sparse_mask_fwd(q, k, v, start, causal, d ** -0.5)
    before = flash_sparse_mask_bwd.route_launches["wgmma"]
    got = flash_sparse_mask_bwd(q, k, v, o, lse, do, start, causal,
                                d ** -0.5)
    ref = flash_sparse_mask_bwd_plain(q, k, v, o, lse, do, start, causal,
                                      d ** -0.5)
    torch.cuda.synchronize()
    assert flash_sparse_mask_bwd.route_launches["wgmma"] == before + 1
    _check_bwd(got, ref, torch.bfloat16, *BWD_TOLS[1][1:])
    if kind == "capped" and not causal:
        assert not got[0][:, 100:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dt,d", [(torch.float32, 64), (torch.float32, 128),
                                  (torch.bfloat16, 256)])
def test_masked_bwd_cuda_core_route(cuda_device, dt, d):
    """float32 and D 256 keep the CUDA-core backward of both policies."""
    lens = (100, 37, 250, 125)
    q, k, v, do, cu, _ = _varlen_inputs(cuda_device, d + 1, lens, lens, 2,
                                        d)
    q, k, v, do = (x.to(dt) for x in (q, k, v, do))
    sq, pq = segments_from_cu(cu, q.shape[0])
    seg = (sq, pq, sq, pq, True, d ** -0.5)
    o, lse = flash_varlen_fwd(q, k, v, *seg)
    before = flash_varlen_bwd.route_launches["cuda_core"]
    got = flash_varlen_bwd(q, k, v, o, lse, do, *seg)
    ref = flash_varlen_bwd_plain(q, k, v, o, lse, do, *seg)
    assert flash_varlen_bwd.route_launches["cuda_core"] == before + 1
    q4, k4, v4, do4 = (x[:256].reshape(1, 256, 2, d) for x in (q, k, v, do))
    start = _doc_start(cuda_device, (100, 37, 119), 1, 2)
    o4, lse4 = flash_sparse_mask_fwd(q4, k4, v4, start, True, d ** -0.5)
    before = flash_sparse_mask_bwd.route_launches["cuda_core"]
    got4 = flash_sparse_mask_bwd(q4, k4, v4, o4, lse4, do4, start, True,
                                 d ** -0.5)
    ref4 = flash_sparse_mask_bwd_plain(q4, k4, v4, o4, lse4, do4, start,
                                       True, d ** -0.5)
    torch.cuda.synchronize()
    assert flash_sparse_mask_bwd.route_launches["cuda_core"] == before + 1
    tols = dict((t, (r, a)) for t, r, a in BWD_TOLS)[dt]
    _check_bwd(got, ref, dt, *tols)
    _check_bwd(got4, ref4, dt, *tols)


def _poisoned_doc_rows(runs, doc, where):
    """The poisoned run's rows of the poisoned document: dq and dk NaN in
    every row, dv too unless only V was poisoned (dv = p^T dO does not read
    V, so there it equals the clean run's)."""
    (_, cdq, cdk, cdv), (_, pdq, pdk, pdv) = runs
    assert torch.isnan(pdq[doc]).all() and torch.isnan(pdk[doc]).all()
    if where == "v":
        assert torch.equal(pdv[doc], cdv[doc])
    else:
        assert torch.isnan(pdv[doc]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["nan", "inf"])
@pytest.mark.parametrize("where", ["q", "k", "v", "do"])
def test_varlen_bwd_wgmma_keeps_documents_apart(cuda_device, what, where):
    """NaN or inf in one document's q, k, v or dO (the third of five, whose
    rows share q tiles and k tiles with the second and fourth), bf16 D 128
    causal, both directions on the tensor cores: every other document's
    output and gradients are finite and bit-equal to a clean run's, and the
    poisoned document's gradient rows are NaN (_poisoned_doc_rows)."""
    lens = (70, 45, 130, 33, 240)
    q, k, v, g, cu, _ = _varlen_inputs(cuda_device, 6, lens, lens, 4, 128)
    q, k, v, g = (x.to(torch.bfloat16) for x in (q, k, v, g))
    doc = slice(115, 245)
    before = flash_varlen_bwd.route_launches["wgmma"]
    runs = []
    for poison in (False, True):
        xs = {"q": q.clone(), "k": k.clone(), "v": v.clone(),
              "do": g.clone()}
        if poison:
            xs[where][doc] = float(what)
        ts = [xs[n].requires_grad_() for n in ("q", "k", "v")]
        out = flash_attn_unpadded(*ts, cu, cu, 240, 240, 128 ** -0.5,
                                  causal=True)
        out.backward(xs["do"])
        runs.append([out.detach()] + [t.grad for t in ts])
    torch.cuda.synchronize()
    assert flash_varlen_bwd.route_launches["wgmma"] == before + 2
    keep = torch.ones(q.shape[0], dtype=torch.bool, device=cuda_device)
    keep[doc] = False
    for clean, poisoned in zip(*runs):
        assert torch.isfinite(poisoned[keep]).all()
        assert torch.equal(poisoned[keep], clean[keep])
    _poisoned_doc_rows(runs, doc, where)


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["nan", "inf"])
@pytest.mark.parametrize("where", ["q", "k", "v", "do"])
def test_sparse_mask_bwd_wgmma_keeps_documents_apart(cuda_device, what,
                                                     where):
    """The FlashMask twin: documents (50, 90, 116) as start rows, the
    second poisoned in every batch row, bf16 D 64 causal."""
    b, s, h, d = 2, 256, 2, 64
    rng = np.random.default_rng(32)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((b, s, h, d))
                                   .astype(np.float32))
                  .to(cuda_device, torch.bfloat16) for _ in range(4))
    start = _doc_start(cuda_device, (50, 90, 116), 1, 1)[0]     # [S]
    before = flash_sparse_mask_bwd.route_launches["wgmma"]
    runs = []
    for poison in (False, True):
        xs = {"q": q.clone(), "k": k.clone(), "v": v.clone(),
              "do": g.clone()}
        if poison:
            xs[where][:, 50:140] = float(what)
        ts = [xs[n].requires_grad_() for n in ("q", "k", "v")]
        out = flash_attention_with_sparse_mask(*ts, start, is_causal=True)
        out.backward(xs["do"])
        runs.append([out.detach()] + [t.grad for t in ts])
    torch.cuda.synchronize()
    assert flash_sparse_mask_bwd.route_launches["wgmma"] == before + 2
    keep = torch.ones(s, dtype=torch.bool, device=cuda_device)
    keep[50:140] = False
    for clean, poisoned in zip(*runs):
        assert torch.isfinite(poisoned[:, keep]).all()
        assert torch.equal(poisoned[:, keep], clean[:, keep])
    _poisoned_doc_rows([[x[:, 50:140] for x in r] for r in runs],
                       slice(None), where)


@pytest.mark.cuda
def test_masked_bwd_wgmma_takes_a_strided_do(cuda_device):
    """A dO read in place with a row stride of 2 H D (a slice of a wider
    tensor) stays on the tensor cores; one shifted by 4 elements (8-byte
    aligned rows) takes the CUDA-core pair, uncopied. Both policies, each
    against the plain backward on a contiguous copy."""
    lens = (50, 150, 100)
    q, k, v, _, cu, _ = _varlen_inputs(cuda_device, 4, lens, lens, 4, 64)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    sq, pq = segments_from_cu(cu, 300)
    seg = (sq, pq, sq, pq, True, 0.125)
    wide = torch.randn(300, 4, 136, device=cuda_device,
                       dtype=torch.bfloat16)
    o, lse = flash_varlen_fwd(q, k, v, *seg)
    q4, k4, v4 = (x.reshape(1, 300, 4, 64) for x in (q, k, v))
    start = _doc_start(cuda_device, lens, 1, 4)
    o4, lse4 = flash_sparse_mask_fwd(q4, k4, v4, start, True, 0.125)
    for do, route in ((wide[..., :64], "wgmma"), (wide[..., 4:68],
                                                  "cuda_core")):
        assert not do.is_contiguous()
        before = flash_varlen_bwd.route_launches[route]
        got = flash_varlen_bwd(q, k, v, o, lse, do, *seg)
        ref = flash_varlen_bwd_plain(q, k, v, o, lse, do.contiguous(), *seg)
        assert flash_varlen_bwd.route_launches[route] == before + 1
        do4 = do.reshape(1, 300, 4, 64)
        before = flash_sparse_mask_bwd.route_launches[route]
        got4 = flash_sparse_mask_bwd(q4, k4, v4, o4, lse4, do4, start, True,
                                     0.125)
        ref4 = flash_sparse_mask_bwd_plain(q4, k4, v4, o4, lse4,
                                           do4.contiguous(), start, True,
                                           0.125)
        assert flash_sparse_mask_bwd.route_launches[route] == before + 1
        torch.cuda.synchronize()
        _check_bwd(got, ref, torch.bfloat16, *BWD_TOLS[1][1:])
        _check_bwd(got4, ref4, torch.bfloat16, *BWD_TOLS[1][1:])


@pytest.mark.cuda
def test_masked_bwd_c_refuses_a_route_that_cannot_take_its_inputs(
        cuda_device):
    """Asked for the tensor-core pair with float32, D 256, or a dO whose
    row stride is off the 8-element grid, the C entries return
    cudaErrorInvalidValue (1) and launch nothing."""
    from paddle_tpu_torch.kernels import flash_sparse_mask as fsm
    from paddle_tpu_torch.kernels import flash_varlen as fv
    vlib = _build.load("flash_varlen", fv._SIG)
    mlib = _build.load("flash_sparse_mask", fsm._SIG)
    seg, pos = segments_from_cu(torch.tensor([0, 100], device=cuda_device),
                                100)
    rq = fv.varlen_tile_ranges(seg, pos, seg, pos, fv.BQ, True, True)
    stream = torch.cuda.current_stream().cuda_stream
    for dt, d, do_stride in ((torch.float32, 128, 128),
                             (torch.bfloat16, 256, 256),
                             (torch.bfloat16, 128, 132)):
        rk = fv.varlen_tile_ranges(seg, pos, seg, pos, fv.dkv_block(d), True,
                                   False)
        x = torch.zeros(100, 1, d, dtype=dt, device=cuda_device)
        do = torch.zeros(100, 1, do_stride, dtype=dt,
                         device=cuda_device)[..., :d]
        out = [torch.zeros_like(x) for _ in range(3)]
        lse = torch.zeros(1, 100, device=cuda_device)
        code = 0 if dt == torch.float32 else 1
        rc = vlib.flash_varlen_bwd(
            x.data_ptr(), x.data_ptr(), x.data_ptr(), do.data_ptr(),
            lse.data_ptr(), lse.data_ptr(), *(t.data_ptr() for t in out),
            seg.data_ptr(), pos.data_ptr(), seg.data_ptr(), pos.data_ptr(),
            rq.data_ptr(), rq.shape[0], rk.data_ptr(), rk.shape[0], 1, 100,
            100, d, d, d, d, d, d, d, do.stride(0), do.stride(1), 0.1, 1,
            code, 1, stream)
        assert rc == 1, ("varlen", dt, d, do_stride)
        start = torch.full((1, 100), 100, dtype=torch.int32,
                           device=cuda_device)
        tmax = fsm.tile_max(start)
        rc = mlib.flash_sparse_mask_bwd(
            x.data_ptr(), x.data_ptr(), x.data_ptr(), do.data_ptr(),
            lse.data_ptr(), lse.data_ptr(), *(t.data_ptr() for t in out),
            start.data_ptr(), tmax.data_ptr(), 1, 1, 100, d,
            100 * d, d, d, 100 * d, d, d, 100 * d, d, d,
            100 * do_stride, do.stride(0), do.stride(1), 0.1, 1, code, 1,
            stream)
        assert rc == 1, ("sparse_mask", dt, d, do_stride)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_masked_autograd_bf16_takes_the_wgmma_route(cuda_device):
    """bf16 leaves through flash_attn_unpadded and
    flash_attention_with_sparse_mask: each direction runs once on the
    tensor cores, and the leaves' gradients equal the plain backward on the
    forward's own o and lse by BWD_TOLS's bf16 rule."""
    lens = (37, 200, 1, 150)
    q, k, v, g, cu, _ = _varlen_inputs(cuda_device, 25, lens, lens, 4, 128)
    q, k, v, g = (x.to(torch.bfloat16) for x in (q, k, v, g))
    sq, pq = segments_from_cu(cu, q.shape[0])
    start = _doc_start(cuda_device, (37, 200, 1, 150), 1, 1)[0]
    fns = {
        "varlen": (flash_varlen_fwd, flash_varlen_bwd,
                   lambda a, b_, c: flash_attn_unpadded(
                       a, b_, c, cu, cu, 200, 200, 128 ** -0.5, causal=True),
                   lambda a, b_, c, o, lse, do: flash_varlen_bwd_plain(
                       a, b_, c, o, lse, do, sq, pq, sq, pq, True,
                       128 ** -0.5),
                   lambda a, b_, c: flash_varlen_fwd(a, b_, c, sq, pq, sq,
                                                     pq, True, 128 ** -0.5),
                   lambda x: x),
        "sparse_mask": (flash_sparse_mask_fwd, flash_sparse_mask_bwd,
                        lambda a, b_, c: flash_attention_with_sparse_mask(
                            a, b_, c, start, is_causal=True),
                        lambda a, b_, c, o, lse, do:
                            flash_sparse_mask_bwd_plain(
                                a, b_, c, o, lse, do,
                                start.expand(4, -1).contiguous(), True,
                                128 ** -0.5),
                        lambda a, b_, c: flash_sparse_mask_fwd(
                            a, b_, c, start.expand(4, -1).contiguous(), True,
                            128 ** -0.5),
                        lambda x: x.reshape(1, 388, 4, 128))}
    for name, (fwd, bwd, entry, plain_bwd, kernel_fwd, shape) in fns.items():
        leaves = [shape(x).clone().requires_grad_() for x in (q, k, v)]
        f0, b0 = fwd.route_launches["wgmma"], bwd.route_launches["wgmma"]
        out = entry(*leaves)
        out.backward(shape(g))
        assert fwd.route_launches["wgmma"] == f0 + 1, name
        assert bwd.route_launches["wgmma"] == b0 + 1, name
        with torch.no_grad():
            xs = [shape(x) for x in (q, k, v)]
            o, lse = kernel_fwd(*xs)
            ref = plain_bwd(*xs, o, lse, shape(g))
        torch.cuda.synchronize()
        _check_bwd([t.grad for t in leaves], ref, torch.bfloat16,
                   *BWD_TOLS[1][1:])


# -- the row-wise kernels: RMSNorm, RoPE, causal softmax ----------------------------
# float32: within 1e-5 of the largest magnitude (summation order, and
# rsqrtf within 2 ulp); bf16: one bf16 ulp (2^-7 of the value) plus 1e-5 of
# the largest, since both sides compute in float32 and round once.
ROW_TOLS = {torch.float32: (0.0, 1e-5), torch.bfloat16: (2.0 ** -7, 1e-5)}


def _rows_close(got, ref, what):
    assert got.dtype == ref.dtype, (what, got.dtype, ref.dtype)
    rtol, atol = ROW_TOLS[ref.dtype]
    ok, err = _bwd_close(got, ref, rtol, atol)
    assert ok, f"{what} {ref.dtype}: max abs err {err}"


def _randn(dev, rng, shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(dev).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h", [(1, 128), (37, 4096), (300, 5120),
                                 (64, 8192), (16, 12288)])
@pytest.mark.parametrize("dt,wdt", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.float32, torch.bfloat16)])
def test_rms_norm_kernels_match_plain(cuda_device, n, h, dt, wdt):
    rng = np.random.default_rng(n + h)
    x = _randn(cuda_device, rng, (n, h), dt)
    w = (1 + 0.3 * _randn(cuda_device, rng, (h,))).to(wdt)
    g = _randn(cuda_device, rng, (n, h), dt)
    f0, b0 = rms_norm_fwd.launches, rms_norm_bwd.launches
    out, rstd = rms_norm_fwd(x, w, 1e-5)
    ref, rref = rms_norm_fwd_plain(x, w, 1e-5)
    dx, dw = rms_norm_bwd(x, w, rref, g)
    rdx, rdw = rms_norm_bwd_plain(x, w, rref, g)
    torch.cuda.synchronize()
    _rows_close(out, ref, "out")
    _rows_close(rstd, rref, "rstd")
    _rows_close(dx, rdx, "dx")
    _rows_close(dw, rdw, "dw")
    assert (rms_norm_fwd.launches, rms_norm_bwd.launches) == (f0 + 1, b0 + 1)


@pytest.mark.cuda
def test_rms_norm_dw_is_the_same_bits_every_run(cuda_device):
    rng = np.random.default_rng(3)
    x = _randn(cuda_device, rng, (12288, 4096), torch.bfloat16)
    g = _randn(cuda_device, rng, (12288, 4096), torch.bfloat16)
    w = _randn(cuda_device, rng, (4096,))
    _, rstd = rms_norm_fwd(x, w, 1e-5)
    runs = [rms_norm_bwd(x, w, rstd, g) for _ in range(3)]
    torch.cuda.synchronize()
    for dx, dw in runs[1:]:
        assert torch.equal(dx, runs[0][0]) and torch.equal(dw, runs[0][1])


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d", [(1, 128, 2, 128), (3, 256, 4, 128),
                                     (2, 64, 3, 256)])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", ["s", "one"])
def test_rope_kernel_matches_plain(cuda_device, b, s, h, d, dt, rows):
    """Random tables (the halves differ) of S rows at B > 1 catch a wrong
    table row or half; the kernel rounds each product and sum as the plain
    version does, so the bits agree."""
    rng = np.random.default_rng(b * s + d)
    x = _randn(cuda_device, rng, (b, s, h, d), dt)
    t = s if rows == "s" else 1
    cos, sin = (_randn(cuda_device, rng, (t, d)) for _ in range(2))
    before = rope.launches
    for backward in (False, True):
        got = rope(x, cos, sin, backward)
        ref = rope_plain(x, cos, sin, backward)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), (backward,
                                       (got.float() - ref.float()).abs()
                                       .max().item())
    assert rope.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("n,s", [(5, 128), (3, 2048), (1, 8192)])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_causal_softmax_kernels_match_plain(cuda_device, n, s, dt):
    rng = np.random.default_rng(n + s)
    x = 4 * _randn(cuda_device, rng, (n, s, s), dt)
    g = _randn(cuda_device, rng, (n, s, s), dt)
    f0, b0 = causal_softmax_fwd.launches, causal_softmax_bwd.launches
    p = causal_softmax_fwd(x)
    rp = causal_softmax_fwd_plain(x)
    dx = causal_softmax_bwd(rp, g)
    rdx = causal_softmax_bwd_plain(rp, g)
    torch.cuda.synchronize()
    _rows_close(p, rp, "p")
    _rows_close(dx, rdx, "dx")
    upper = torch.ones(s, s, dtype=torch.bool, device=cuda_device).triu(1)
    assert not p[:, upper].any() and not dx[:, upper].any()
    assert (causal_softmax_fwd.launches,
            causal_softmax_bwd.launches) == (f0 + 1, b0 + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_causal_softmax_never_reads_the_masked_half(cuda_device, dt):
    """NaN above the diagonal of x and of g: p and dx are finite and the
    same bits as on clean inputs."""
    n, s = 4, 1024
    rng = np.random.default_rng(17)
    x = _randn(cuda_device, rng, (n, s, s), dt)
    g = _randn(cuda_device, rng, (n, s, s), dt)
    upper = torch.ones(s, s, dtype=torch.bool, device=cuda_device).triu(1)
    xp, gp = x.clone(), g.clone()
    xp[:, upper] = float("nan")
    gp[:, upper] = float("nan")
    p, pp = causal_softmax_fwd(x), causal_softmax_fwd(xp)
    dx, dxp = causal_softmax_bwd(p, g), causal_softmax_bwd(p, gp)
    torch.cuda.synchronize()
    assert torch.isfinite(pp).all() and torch.equal(p, pp)
    assert torch.isfinite(dxp).all() and torch.equal(dx, dxp)


@pytest.mark.cuda
def test_row_wise_kernels_reject_what_they_do_not_take(cuda_device):
    x = torch.zeros(4, 96, device=cuda_device)
    with pytest.raises(ValueError):
        rms_norm_fwd(x, torch.ones(96, device=cuda_device), 1e-5)
    with pytest.raises(ValueError):
        rms_norm_fwd(torch.zeros(2, 32768, device=cuda_device),
                     torch.ones(32768, device=cuda_device), 1e-5)
    with pytest.raises(TypeError):
        rms_norm_fwd(torch.zeros(4, 128, device=cuda_device).half(),
                     torch.ones(128, device=cuda_device), 1e-5)
    with pytest.raises(ValueError):
        rope(torch.zeros(1, 4, 2, 64, device=cuda_device),
             torch.zeros(4, 64, device=cuda_device),
             torch.zeros(4, 64, device=cuda_device))
    with pytest.raises(ValueError):
        rope(torch.zeros(2, 4, 2, 128, device=cuda_device),
             torch.zeros(8, 128, device=cuda_device),
             torch.zeros(8, 128, device=cuda_device))
    with pytest.raises(ValueError):
        causal_softmax_fwd(torch.zeros(1, 96, 96, device=cuda_device))
    with pytest.raises(TypeError):
        causal_softmax_fwd(torch.zeros(1, 128, 128, device=cuda_device,
                                       dtype=torch.half))


@pytest.mark.cuda
def test_row_wise_entry_points_match_plain_autograd(cuda_device):
    """The three entry points on the card (kernels forward and backward)
    against autograd through the plain versions, float32. The scores are
    scaled by 1/sqrt(D), as attention scales them: unscaled, a row's
    softmax saturates (p exactly 1 at its maximum) and the true gradient
    falls below float32's resolution of g - sum(p g), so both sides return
    rounding noise."""
    torch.backends.cuda.matmul.allow_tf32 = False
    b, s, heads, d = 2, 256, 2, 128
    rng = np.random.default_rng(29)
    x0 = _randn(cuda_device, rng, (b, s, heads * d))
    r0 = _randn(cuda_device, rng, (b, s, heads * d))
    w0 = 1 + 0.2 * _randn(cuda_device, rng, (heads * d,))
    cos, sin = (_randn(cuda_device, rng, (s, d)) for _ in range(2))
    gout = _randn(cuda_device, rng, (b, heads, s, s))
    results = []
    for kernel in (True, False):
        x, r, w = (t.clone().requires_grad_() for t in (x0, r0, w0))
        if kernel:
            y, _ = fused_rms_norm(x, w, None, 1e-5, residual=r)
            q = y.reshape(b, s, heads, d)
            q, k, _ = fused_rotary_position_embedding(
                q, q * 0.5, None, sin=sin, cos=cos,
                use_neox_rotary_style=False)
            sc = torch.matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1))
            p = softmax_mask_fuse_upper_triangle(sc * d ** -0.5)
        else:
            y = rms_norm_fwd_plain((x + r).reshape(-1, heads * d), w,
                                   1e-5)[0].reshape(x.shape)
            q = y.reshape(b, s, heads, d)
            q, k = rope_plain(q, cos, sin), rope_plain(q * 0.5, cos, sin)
            sc = torch.matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1))
            p = causal_softmax_fwd_plain(sc.reshape(-1, s, s) * d ** -0.5) \
                .reshape(sc.shape)
        (p * gout).sum().backward()
        results.append([p.detach(), x.grad, r.grad, w.grad])
    torch.cuda.synchronize()
    for name, got, ref in zip(("p", "dx", "dresidual", "dw"), *results):
        ok, err = _bwd_close(got, ref, 0.0, 1e-4)
        assert ok, f"{name}: max abs err {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 256])
def test_ss_tb_one_tile_matches_matmul(cuda_device, k):
    """csrc/wgmma.cuh's SS m64n128k16 with B transposed on one 64 x 128
    tile: a [64, K] K-major, b [K, 128] with its columns contiguous copied
    into two 64-column panels and read MN-major, against float64 matmuls
    of the same bf16 values. The products are exact, only the float32
    sums differ: 1e-6 |ref| + 1e-5 of the largest output. A wrong
    transpose flag, panel step or swizzle moves outputs by their own
    size."""
    rng = np.random.default_rng(k + 1)
    a = torch.from_numpy(rng.standard_normal((64, k)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((k, 128)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    out = torch.empty(64, 128, device=cuda_device)
    lib = _build.load("wgmma_selftest", _SELFTEST_SIG)
    rc = lib.ss_tb_selftest(a.data_ptr(), b.data_ptr(), out.data_ptr(), k,
                            torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"CUDA error {rc}"
    ref = torch.matmul(a.double(), b.double())
    torch.cuda.synchronize()
    lim = 1e-6 * ref.abs() + 1e-5 * ref.abs().max()
    assert ((out.double() - ref).abs() <= lim).all(), \
        ((out.double() - ref).abs() / lim).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 256])
def test_ss_tatb_one_tile_matches_matmul(cuda_device, k):
    """csrc/wgmma.cuh's SS m64n128k16 with A and B both transposed on one
    128 x 128 tile, as the grouped weight gradient uses it: a [K, 128]
    and b [K, 128] with their columns contiguous, each 64-row slice copied
    into two 64-column panels, warpgroup g reading a's panel g MN-major as
    A and b as B, against float64 a^T b of the same bf16 values. The
    products are exact, only the float32 sums differ: 1e-6 |ref| + 1e-5
    of the largest output. A wrong transpose flag, panel or swizzle moves
    outputs by their own size."""
    rng = np.random.default_rng(k + 2)
    a, b = (torch.from_numpy(rng.standard_normal((k, 128)).astype(
        np.float32)).to(cuda_device, torch.bfloat16) for _ in range(2))
    out = torch.empty(128, 128, device=cuda_device)
    lib = _build.load("wgmma_selftest", _SELFTEST_SIG)
    rc = lib.ss_tatb_selftest(a.data_ptr(), b.data_ptr(), out.data_ptr(), k,
                              torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"CUDA error {rc}"
    ref = torch.matmul(a.double().t(), b.double())
    torch.cuda.synchronize()
    lim = 1e-6 * ref.abs() + 1e-5 * ref.abs().max()
    assert ((out.double() - ref).abs() <= lim).all(), \
        ((out.double() - ref).abs() / lim).max().item()


# -- the grouped forward on the tensor cores ------------------------------------
#
# `gm_route` sends float32 and bf16 with bm % 128 == 0, K % 64 == 0, N % 8
# == 0 (forward) and 16-byte aligned x and w to `grouped_wgmma`: float32 x
# and w each as three exact bf16 pieces, six piece products a k16 step.
# Held to the plain version on the routed rows by the float32 rule (1e-6
# |ref| + 1e-5 of the largest output: the products are exact or below
# 2^-22 of x w, the sums differ in order) and in bf16 to one bf16 ulp.


def _ragged_ids(rng, t, e, empty, single):
    """t routes over e experts, skewed: none to `empty`, exactly one to
    `single`."""
    p = rng.dirichlet(np.full(e, 0.5))
    p[[empty, single]] = 0
    ids = rng.choice(e, t - 1, p=p / p.sum())
    return np.concatenate([ids, [single]]).astype(np.int32)


def _gw_inputs(dev, seed, t, k, n, e, bm, dtype, trans):
    """A skewed routing with an empty expert and a one-row expert (a partial
    last tile in every group), x [Tp, k], w [e, k, n] (or [e, n, k] when
    trans) at 0.02 and b [e, n]."""
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(_ragged_ids(rng, t, e, 2, 5)).to(dev)
    md = grouped_metadata(ids, e, bm)
    tp = md["row_src"].shape[0]

    def rnd(scale, *shape):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(dev).to(dtype)

    w = rnd(0.02, e, n, k) if trans else rnd(0.02, e, k, n)
    return md, rnd(1.0, tp, k), w, rnd(1.0, e, n)


def _gw_call(md, x, w, b, bm, trans):
    return grouped_matmul_fwd(x, w, b, md["offsets"], md["counts"], bm,
                              transpose_w=trans)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("k,n,bm,route", [
    (768, 3072, 128, "wgmma"),            # the MoE up projection
    (3072, 768, 128, "wgmma"),            # and its down projection
    (256, 520, 256, "wgmma"),             # bm 256; N off the 128-column tile
    (768, 3072, 64, "cuda_core"),         # 128-row tiles straddle groups
    (96, 256, 128, "cuda_core"),          # K short of whole stages
])
def test_grouped_wgmma_matches_plain(cuda_device, dtype, trans, k, n, bm,
                                     route):
    """The forward (with a bias) and the input gradient (w read
    transposed, no bias) on each route, 3000 routes over 8 experts with an
    empty one and a one-row one."""
    md, x, w, b = _gw_inputs(cuda_device, k + n + bm, 3000, k, n, 8, bm,
                             dtype, trans)
    b = None if trans else b
    assert gm_route(dtype, k, n, bm, trans,
                    (x.data_ptr(), w.data_ptr())) == route
    r0 = dict(grouped_matmul_fwd.route_launches)
    out = _gw_call(md, x, w, b, bm, trans)
    ref = _ref_fwd(x, w, b, md["offsets"], md["counts"], bm, dtype,
                   transpose_w=trans)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    assert grouped_matmul_fwd.route_launches[route] == r0[route] + 1
    assert md["counts"][2] == 0 and md["counts"][5] == 1
    _grouped_close(out, ref, md["dest"].long(), dtype == torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("trans", [False, True])
def test_grouped_wgmma_dead_rows_and_repeat(cuda_device, dtype, trans):
    """Two launches give the same bits; NaN in every row that is not a
    route's (padding in a group's last tile, the tiles past the groups)
    leaves the routed rows bit for bit as they were."""
    md, x, w, b = _gw_inputs(cuda_device, 31, 1500, 768, 520, 8, 128, dtype,
                             trans)
    rows = md["dest"].long()
    r0 = grouped_matmul_fwd.route_launches["wgmma"]
    clean = _gw_call(md, x, w, b, 128, trans)
    again = _gw_call(md, x, w, b, 128, trans)
    assert torch.equal(clean[rows], again[rows])
    xp = x.clone()
    xp[~md["row_valid"]] = float("nan")
    poisoned = _gw_call(md, xp, w, b, 128, trans)
    torch.cuda.synchronize()
    assert grouped_matmul_fwd.route_launches["wgmma"] == r0 + 3
    assert torch.isfinite(poisoned[rows]).all()
    assert torch.equal(poisoned[rows], clean[rows])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("trans", [False, True])
def test_grouped_wgmma_non_finite_as_plain(cuda_device, dtype, trans):
    """Live rows of +inf and of NaN in x, a single -inf in another row,
    and +inf and -inf weights: inf, -inf and NaN in the places the plain
    version gives them, every finite output within the rule. A split puts
    inf whole into hi, so a cross product would give inf x 0 = NaN where
    the float32 product is inf; the kernel redoes such a tile in float32
    FMAs."""
    md, x, w, b = _gw_inputs(cuda_device, 41, 1500, 256, 264, 8, 128, dtype,
                             trans)
    rows = md["dest"].long()
    x[rows[5]] = float("inf")
    x[rows[6], 3] = float("-inf")
    x[rows[9]] = float("nan")
    # an entry of the two largest experts' weights: +inf at (k 7, n 11),
    # -inf at (k 20, n 40)
    big = torch.argsort(md["counts"], descending=True)[:2].tolist()
    for e, kk, nn, v in ((big[0], 7, 11, "inf"), (big[1], 20, 40, "-inf")):
        if trans:
            w[e, nn, kk] = float(v)
        else:
            w[e, kk, nn] = float(v)
    out = _gw_call(md, x, w, b, 128, trans)[rows].float()
    ref = _ref_fwd(x, w, b, md["offsets"], md["counts"], 128, dtype,
                   transpose_w=trans)[rows].float()
    torch.cuda.synchronize()
    fin = torch.isfinite(ref)
    assert not fin[5].any() and not fin[6].all() and torch.isnan(ref[9]).all()
    assert (~fin).sum() > 3 * ref.shape[1]     # the weights' columns too
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    assert torch.equal(out[~fin].nan_to_num(0.0), ref[~fin].nan_to_num(0.0))
    _grouped_close(torch.where(fin, out, 0.0), torch.where(fin, ref, 0.0),
                   slice(None), dtype == torch.bfloat16)


@pytest.mark.cuda
def test_grouped_wgmma_refuses_what_it_does_not_take(cuda_device):
    """x 4 bytes off a 16-byte boundary and a forward N off a multiple of
    8 route to "cuda_core", right all the same; the C entry refuses the
    tensor-core route for them (error 1), and for bm 64."""
    md, x, w, b = _gw_inputs(cuda_device, 3, 700, 256, 96, 8, 128,
                             torch.float32, False)
    flat = torch.empty(1 + x.numel(), device=cuda_device)
    xo = flat[1:].view_as(x)
    xo.copy_(x)
    assert xo.data_ptr() % 16 == 4
    w100 = torch.randn(8, 256, 100, device=cuda_device)
    lib = _build.load("grouped_matmul", gmm_mod._SIG)
    stream = torch.cuda.current_stream().cuda_stream
    for xx, ww, bm in ((xo, w, 128), (x, w100, 128), (x, w, 64)):
        route = gm_route(xx.dtype, 256, ww.shape[2], bm, False,
                         (xx.data_ptr(), ww.data_ptr()))
        assert route == "cuda_core"
        out = grouped_matmul_fwd(xx, ww, None, md["offsets"], md["counts"],
                                 bm) if bm == 128 else None
        if out is not None:
            ref = _ref_fwd(xx, ww, None, md["offsets"], md["counts"], bm,
                           torch.float32)
            _grouped_close(out, ref, md["dest"].long(), False)
        tp, n = xx.shape[0], ww.shape[2]
        dst = torch.empty(tp, n, device=cuda_device)
        rc = lib.grouped_matmul_fwd(
            xx.data_ptr(), ww.data_ptr(), None, dst.data_ptr(),
            md["offsets"].data_ptr(), md["counts"].data_ptr(), 8, tp, 256, n,
            bm, 0, 0, 1, stream)
        assert rc == 1


# -- the grouped weight gradient on the tensor cores ----------------------------
#
# `gm_dw_route` sends float32 and bf16 with K % 8 == 0, N % 8 == 0 and
# 16-byte aligned x and dy to `grouped_dw_wgmma` at any bm: float32 x and
# dy each as three exact bf16 pieces, six piece products a k16 step over
# the group's rows, a float32 partial drained each 64-row stage. Held to
# the plain version by the float32 rule (1e-6 |ref| + 1e-5 of the largest
# output; over a group's thousands of rows the sums differ in order) and
# in bf16 (exact products, float32 sums) by the same rule plus one bf16
# ulp of the value, as the forward.


def _dw_inputs(dev, seed, t, k, n, e, bm, dtype):
    """_ragged_ids' routing (expert 2 empty, expert 5 one route), x [Tp,
    k] unit normal and dy [Tp, n] at 0.02, zero on padding rows."""
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(_ragged_ids(rng, t, e, 2, 5)).to(dev)
    md = grouped_metadata(ids, e, bm)
    tp = md["row_src"].shape[0]
    live = md["row_valid"][:, None]

    def rnd(scale, cols):
        v = torch.from_numpy((rng.standard_normal((tp, cols)) * scale)
                             .astype(np.float32)).to(dev)
        return torch.where(live, v, 0.0).to(dtype)
    return md, rnd(1.0, k), rnd(0.02, n)


def _dw_call(md, x, dy, bm):
    return grouped_matmul_dw(x, dy, md["offsets"], md["counts"], bm,
                             md["counts"].shape[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bm", [128, 64])
@pytest.mark.parametrize("k,n", [(768, 3072), (3072, 768), (136, 520)])
def test_grouped_dw_wgmma_matches_plain(cuda_device, dtype, bm, k, n):
    """The weight gradient on the tensor cores, 6000 routes over 8 experts
    with an empty one and a one-row one, at the MoE layer's widths and at
    odd multiples of 8 (tiles past K and N), in groups aligned to 128 and
    to 64 rows: the empty expert's dw is zeros, the rest within the
    rule."""
    md, x, dy = _dw_inputs(cuda_device, k + n + bm, 6000, k, n, 8, bm, dtype)
    assert gm_dw_route(dtype, k, n, (x.data_ptr(), dy.data_ptr())) == \
        "wgmma"
    r0 = dict(grouped_matmul_dw.route_launches)
    dw = _dw_call(md, x, dy, bm)
    ref = _ref_dw(x, dy, md["offsets"], md["counts"], bm, 8)
    torch.cuda.synchronize()
    assert grouped_matmul_dw.route_launches["wgmma"] == r0["wgmma"] + 1
    assert dw.dtype == torch.float32 and tuple(dw.shape) == (8, k, n)
    assert md["counts"][2] == 0 and (dw[2] == 0).all()
    _grouped_close(dw, ref, slice(None), dtype == torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_dw_wgmma_padding_and_repeat(cuda_device, dtype):
    """Two launches give the same bits; NaN in every row that is not a
    route's, in x and dy, leaves dw bit for bit as it was (those rows are
    never read), the empty expert's zeros included."""
    md, x, dy = _dw_inputs(cuda_device, 51, 3000, 264, 392, 8, 128, dtype)
    clean = _dw_call(md, x, dy, 128)
    again = _dw_call(md, x, dy, 128)
    dead = ~md["row_valid"]
    xp, dyp = x.clone(), dy.clone()
    xp[dead] = float("nan")
    dyp[dead] = float("nan")
    poisoned = _dw_call(md, xp, dyp, 128)
    torch.cuda.synchronize()
    assert dead.sum() > 0
    assert torch.equal(clean, again)
    assert torch.isfinite(poisoned).all() and torch.equal(poisoned, clean)
    assert (poisoned[2] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_dw_wgmma_non_finite_as_plain(cuda_device, dtype):
    """+inf in a live row of x, NaN in a live row of dy, and -inf in one
    entry of each: inf, -inf and NaN in the places the plain version gives
    them, every finite output within the rule. A split puts inf whole into
    hi, so a cross product would give inf x 0 = NaN where the float32
    product is inf; the kernel redoes such a tile in float32 FMAs."""
    md, x, dy = _dw_inputs(cuda_device, 61, 3000, 256, 264, 8, 128, dtype)
    rows = md["dest"].long()
    x[rows[5]] = float("inf")
    x[rows[40], 3] = float("-inf")
    dy[rows[9]] = float("nan")
    dy[rows[70], 17] = float("-inf")
    dw = _dw_call(md, x, dy, 128)
    ref = _ref_dw(x, dy, md["offsets"], md["counts"], 128, 8)
    torch.cuda.synchronize()
    fin = torch.isfinite(ref)
    assert (~fin).sum() > 256 and torch.isnan(ref).any()
    assert torch.isinf(ref).any()
    assert torch.equal(torch.isnan(dw), torch.isnan(ref))
    assert torch.equal(dw[~fin].nan_to_num(0.0), ref[~fin].nan_to_num(0.0))
    _grouped_close(torch.where(fin, dw, 0.0), torch.where(fin, ref, 0.0),
                   slice(None), dtype == torch.bfloat16)


@pytest.mark.cuda
def test_grouped_dw_wgmma_refuses_what_it_does_not_take(cuda_device,
                                                        monkeypatch):
    """x 4 bytes off a 16-byte boundary and a K off a multiple of 8 route
    to "cuda_core", right all the same; the C entry refuses the
    tensor-core route for them (error 1), and a wrapper made to ask for it
    raises instead of computing on another kernel."""
    md, x, dy = _dw_inputs(cuda_device, 7, 1500, 256, 128, 8, 128,
                           torch.float32)
    flat = torch.empty(1 + x.numel(), device=cuda_device)
    xo = flat[1:].view_as(x)
    xo.copy_(x)
    assert xo.data_ptr() % 16 == 4
    x130 = torch.randn(x.shape[0], 130, device=cuda_device)
    lib = _build.load("grouped_matmul", gmm_mod._SIG)
    stream = torch.cuda.current_stream().cuda_stream
    for xx in (xo, x130):
        k = xx.shape[1]
        assert gm_dw_route(xx.dtype, k, 128,
                           (xx.data_ptr(), dy.data_ptr())) == "cuda_core"
        r0 = grouped_matmul_dw.route_launches["cuda_core"]
        dw = _dw_call(md, xx, dy, 128)
        assert grouped_matmul_dw.route_launches["cuda_core"] == r0 + 1
        _grouped_close(dw, _ref_dw(xx, dy, md["offsets"], md["counts"], 128,
                                   8), slice(None), False)
        dst = torch.empty(8, k, 128, device=cuda_device)
        rc = lib.grouped_matmul_dw(
            xx.data_ptr(), dy.data_ptr(), dst.data_ptr(),
            md["offsets"].data_ptr(), md["counts"].data_ptr(), 8,
            xx.shape[0], k, 128, 0, 1, stream)
        assert rc == 1
    monkeypatch.setattr(gmm_mod, "gm_dw_route", lambda *args: "wgmma")
    n0 = grouped_matmul_dw.launches
    with pytest.raises(RuntimeError, match="wgmma kernel"):
        _dw_call(md, x130, dy, 128)
    assert grouped_matmul_dw.launches == n0


# -- the decoders' routes ---------------------------------------------------------

# (hidden, heads, KV heads) of tiny float32 Llamas: head dim 80, 3 query
# heads a KV head at head dim 64, and head dim 128 (the kernels' own)
DECODE_CONFIGS = {"hd80": (160, 2, 1), "group3": (384, 6, 2),
                  "hd128": (256, 2, 2)}
# where each one's prefill (128 tokens) and decode attention go
DECODE_ROUTES = {"hd80": ("plain", "plain"), "group3": ("kernel", "plain"),
                 "hd128": ("kernel", "kernel")}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(DECODE_CONFIGS))
def test_decoders_serve_any_head_dim_on_the_card(cuda_device, name):
    """CachedDecoder.generate (a 128-token prompt: the flash prefill where
    it routes) and PagedDecoder.serve with the ragged kernel asked for, on
    the card and on the CPU from the same weights: token for token the
    same in float32, nothing raised, and every attention call counted on
    the route `attention_route` / `decode_route` give it."""
    hidden, nh, nkv = DECODE_CONFIGS[name]
    cfg = LlamaConfig(vocab_size=97, hidden_size=hidden,
                      intermediate_size=192, num_hidden_layers=2,
                      num_attention_heads=nh, num_key_value_heads=nkv,
                      max_position_embeddings=192, dtype="float32")
    torch.manual_seed(3)
    model = LlamaForCausalLM(cfg, device="cpu")
    model.eval()
    ids = torch.from_numpy(np.random.default_rng(4).integers(
        0, 97, (2, 128)).astype(np.int64))
    want_prefill, want_decode = DECODE_ROUTES[name]
    ref = CachedDecoder(model, max_len=140, device="cpu").generate(
        ids, max_new_tokens=8)
    before = dict(CachedDecoder.route_launches)
    out = CachedDecoder(model, max_len=140, device=cuda_device).generate(
        ids, max_new_tokens=8)
    assert torch.equal(out, ref)
    assert CachedDecoder.route_launches[want_prefill] == \
        before[want_prefill] + 2
    rng = np.random.default_rng(5)
    reqs = [(f"r{i}", [int(t) for t in rng.integers(0, 97, ln)], budget)
            for i, (ln, budget) in enumerate([(5, 9), (17, 4), (30, 6)])]

    def serve(dev):
        return PagedDecoder(model, max_len=64, block_size=16, max_slots=2,
                            num_blocks=9, ragged_kernel=True,
                            device=dev).serve(reqs, chunk=4)
    ref = serve("cpu")
    before = dict(PagedDecoder.route_launches)
    r0 = ragged_paged_attention.launches
    out = serve(cuda_device)
    assert out == ref
    moved = {r: PagedDecoder.route_launches[r] - before[r] for r in before}
    assert moved[want_decode] > 0 and sum(moved.values()) == \
        moved[want_decode]
    assert (ragged_paged_attention.launches > r0) == \
        (want_decode == "kernel")


@pytest.mark.cuda
def test_gpt_tiny_bf16_train_step_on_the_card(cuda_device):
    """One TrainStep of a narrow GPT-2 in bf16 at head dim 64 (dropout 0.1,
    masks from the model's CUDA generator): the loss is finite and every
    attention runs on the flash kernels' tensor-core route, one forward
    and one backward per layer."""
    from paddle_tpu_torch import AdamW, TrainStep
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
    cfg = gpt_tiny(hidden_size=128, num_attention_heads=2, dropout=0.1,
                   dtype="bfloat16")
    model = GPTForCausalLM(cfg)
    assert model.device.type == "cuda"
    step = TrainStep(model, lambda lo, la: model.loss(lo, la),
                     AdamW(learning_rate=1e-4,
                           parameters=model.parameters()))
    ids = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 128)).astype(np.int64)).to(cuda_device)
    fwd = dict(_flash_bhsd.route_launches)
    bwd = dict(_flash_bhsd_bwd.route_launches)
    loss = step((ids,), (ids,))
    assert loss.dtype == torch.float32 and torch.isfinite(loss).item()
    layers = cfg.num_hidden_layers
    assert _flash_bhsd.route_launches["wgmma"] - fwd["wgmma"] == layers
    assert _flash_bhsd_bwd.route_launches["wgmma"] - bwd["wgmma"] == layers
    assert _flash_bhsd.route_launches["cuda_core"] == fwd["cuda_core"]


@pytest.mark.cuda
def test_dropout_keep_share_on_a_cuda_generator(cuda_device):
    """The mask from a CUDA generator: keep share within 0.006 of 0.9 over
    100,000 elements (six standard deviations), kept elements exactly
    x / 0.9, the same mask again from the same seed."""
    from paddle_tpu_torch.nn.functional import dropout
    x = torch.randn(100, 1000, device=cuda_device) + 3.0

    def draw(seed):
        gen = torch.Generator(device=cuda_device)
        gen.manual_seed(seed)
        return dropout(x, p=0.1, generator=gen)

    y = draw(0)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) <= 0.006
    assert torch.equal(y[kept], x[kept] / 0.9)
    assert torch.equal(draw(0), y) and not torch.equal(draw(1), y)


@pytest.mark.cuda
def test_global_norm_clip_on_the_card(cuda_device):
    """ClipGradByGlobalNorm's multi-tensor path on CUDA gradients (bf16
    and float32, as a bf16 model with float32 master gradients hands
    them over) against its definition in float64, g x clip / max(||all||,
    clip): float32 to 1e-5 relative (the card's float32 norm sums each
    thread's share of a 65,536-element chunk serially, at most about 128
    terms, 128 x 6e-8 = 7.7e-6 at worst, then as a tree; one rounding of
    the product), bf16 to one bf16 ulp (2^-8 relative). A missed or wrong
    clip moves every element by far more. (The CPU's float32 norm is no
    reference at this size: it is off by 2-4e-5 relative.)"""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    gen = torch.Generator().manual_seed(7)
    grads = [torch.randn(s, generator=gen) * 3 for s in
             [(768, 2304), (2304,), (3072, 768), (50, 7)]]
    grads[1] = grads[1].to(torch.bfloat16)
    grads[3] = grads[3].to(torch.bfloat16)
    total = sum(g.double().square().sum() for g in grads).sqrt()
    scale = 1.0 / total.clamp(min=1.0)
    got = ClipGradByGlobalNorm(1.0)([(None, g.to(cuda_device))
                                     for g in grads])
    for g, (_, o) in zip(grads, got):
        assert o.dtype == g.dtype and o.device.type == "cuda"
        rtol = 2.0 ** -8 if g.dtype == torch.bfloat16 else 1e-5
        torch.testing.assert_close(o.cpu().double(), g.double() * scale,
                                   rtol=rtol, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["bf16", "int8"])
def test_paged_chunk_graph_replay_equals_eager(cuda_device, kv_quant):
    """A paged decode chunk captured as a CUDA graph, replayed twice, each
    time against `_paged_chunk_state` called eagerly on clones of the same
    state and pools (bf16, head dim 64: the ragged kernel's route): the
    tokens, the advanced state and every byte of the pools' blocks but
    the trash block identical, and each
    replay adds layers x n to the ragged kernel's launch count and to the
    decoder's "kernel" route (the warm-up and the capture add nothing)."""
    from paddle_tpu_torch.models.paged_decode import QuantizedPool
    cfg = LlamaConfig(vocab_size=97, hidden_size=128, intermediate_size=192,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=2, max_position_embeddings=128,
                      dtype="bfloat16")
    model = LlamaForCausalLM(cfg, device=cuda_device)
    dec = PagedDecoder(model, max_len=64, block_size=16, max_slots=4,
                       num_blocks=17, kv_quant=kv_quant, device=cuda_device)
    kpool, vpool = dec.serve_pools()
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(3)
    for pool in (kpool, vpool):
        if kv_quant:
            pool.codes.copy_(torch.randint(-127, 128, pool.codes.shape,
                                           generator=gen, device=cuda_device,
                                           dtype=torch.int8))
            pool.scales.uniform_(1e-3, 2e-2, generator=gen)
        else:
            pool.normal_(generator=gen)
    S, n = 4, 4
    tables = np.arange(1, 17, dtype=np.int32).reshape(S, 4)
    dec.upload_state(np.asarray([5, 17, 40, 3], np.int32),
                     np.asarray([9, 30, 6, 40], np.int32), tables,
                     np.asarray([True, True, False, True]),
                     np.asarray([7, 2, 5, 6], np.int32), np.zeros(S, bool))
    counter = ragged_paged_attention_quant if kv_quant \
        else ragged_paged_attention

    def leaves(pool):
        # every block but the trash block 0, which inactive slots write, no
        # live slot reads, and the capture's warm-up (no slot live) writes
        return [pool.codes[:, 1:], pool.scales[:, 1:]] if kv_quant \
            else [pool[:, 1:]]

    def clone(pool):
        return QuantizedPool(pool.codes.clone(), pool.scales.clone()) \
            if kv_quant else pool.clone()

    for _ in range(2):
        st0 = [t.clone() for t in dec.decode_state()]
        kc, vc = clone(kpool), clone(vpool)
        launches = counter.launches
        routes = dict(PagedDecoder.route_launches)
        toks, bad = dec.dispatch_chunk_state(n)
        torch.cuda.synchronize()
        assert counter.launches - launches == cfg.num_hidden_layers * n
        assert PagedDecoder.route_launches["kernel"] - routes["kernel"] == \
            cfg.num_hidden_layers * n
        got = [toks.clone(), bad.clone()] + [
            t.clone() for t in dec.decode_state()]
        ref = dec._paged_chunk_state(*st0, kc, vc, n)
        want = list(ref[:4]) + [st0[2], ref[4], ref[5], st0[5]]
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        for a, b in zip(leaves(kpool) + leaves(vpool),
                        leaves(kc) + leaves(vc)):
            assert torch.equal(a.contiguous().view(torch.uint8),
                               b.contiguous().view(torch.uint8))
    assert dec._chunk_graphs.captured == 1
    assert dec._chunk_graphs.replays == 2


@pytest.mark.cuda
def test_sampled_generate_graph_replays_reseed(cuda_device):
    """CachedDecoder's sampled chunks as CUDA graphs: 1 + 2 x 8 new tokens
    replay one graph (n 8) twice with fresh noise, so the fused tokens
    equal the per-token loop's (CHUNK 1, no graph) under the same seed;
    the same seed reproduces them and another seed changes them."""
    cfg = LlamaConfig(vocab_size=97, hidden_size=128, intermediate_size=192,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=2, max_position_embeddings=128,
                      dtype="float32")
    model = LlamaForCausalLM(cfg, device=cuda_device)
    ids = torch.from_numpy(np.random.default_rng(8).integers(
        0, 97, (3, 10)).astype(np.int64))
    kw = dict(max_new_tokens=17, do_sample=True, temperature=0.8, top_k=20,
              top_p=0.9)
    dec = CachedDecoder(model, max_len=32, device=cuda_device)
    dec.CHUNK = 8

    def run(seed):
        gen = torch.Generator(device=cuda_device)
        gen.manual_seed(seed)
        return dec.generate(ids, generator=gen, **kw)

    first = run(0)
    assert dec._gen_graphs.captured == 1 and dec._gen_graphs.replays == 2
    assert torch.equal(run(0), first)
    assert not torch.equal(run(1)[:, 10:], first[:, 10:])
    # the two replays drew their own noise: the stream is the per-token one
    assert not torch.equal(first[:, 11:19], first[:, 19:27])
    dec.CHUNK = 1
    assert torch.equal(run(0), first)


# -- the prefix cache's warm prefill, COW copy and poison column ------------------

def _hd128_model(dtype):
    """A tiny Llama on the CPU whose decode attention takes the kernel
    route (head dim 128); the engines copy its weights to their device."""
    cfg = LlamaConfig(vocab_size=97, hidden_size=256, intermediate_size=192,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=2, max_position_embeddings=128,
                      dtype=dtype)
    torch.manual_seed(11)
    model = LlamaForCausalLM(cfg, device="cpu")
    model.eval()
    return model


@pytest.mark.cuda
@pytest.mark.parametrize("opt", [{}, {"kv_quant": "int8"},
                                 {"attn_shards": 2}],
                         ids=["raw", "int8", "shards2"])
def test_warm_prefill_kernels_match_dense(cuda_device, opt):
    """Cache-on serves on the card in float32: the warm prefill's rows on
    the ragged kernels (the int8-pool kernel, the partials kernel) against
    the same engine on the dense route, cold, warm (a full hit: the COW
    fork) and an extension prompt: the same streams and cache stats, and
    each kernel launched for every layer of every prefill call and decode
    step."""
    model = _hd128_model("float32")
    rng = np.random.default_rng(12)
    P = [int(t) for t in rng.integers(0, 97, 48)]     # three whole blocks
    ext = P + [int(t) for t in rng.integers(0, 97, 13)]
    counter = {"kv_quant": ragged_paged_attention_quant,
               "attn_shards": ragged_paged_attention_partials}.get(
        next(iter(opt), None), ragged_paged_attention)

    def run(ragged):
        dec = PagedDecoder(model, max_len=128, block_size=16, max_slots=2,
                           num_blocks=17, prefix_cache=True,
                           ragged_kernel=ragged, device=cuda_device, **opt)
        n0 = counter.launches
        out = [dec.serve([("c", P, 6)])["c"], dec.serve([("w", P, 6)])["w"],
               dec.serve([("e", ext, 6)])["e"]]
        return out, dec, counter.launches - n0

    ref, ddec, dense_launches = run(False)
    out, kdec, launches = run(True)
    assert out == ref and out[0] == out[1]
    assert kdec.prefix_cache.stats == ddec.prefix_cache.stats
    assert kdec.prefix_cache.stats["cow_copies"] == 1
    assert dense_launches == 0
    steps = 3 * 5                      # budget 6: five decode steps a serve
    assert launches == 2 * (steps + kdec.prefill_device_calls)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["raw", "int8"])
def test_cow_copy_on_the_card(cuda_device, kv_quant):
    """_cow_copy forks one block in every layer, K and V (codes and scales
    of an int8 pool), bit for bit, and touches no other block."""
    model = _hd128_model("bfloat16")
    dec = PagedDecoder(model, max_len=64, block_size=16, max_slots=2,
                       num_blocks=9, kv_quant=kv_quant, device=cuda_device)
    kpool, vpool = dec.ensure_pools()
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(4)
    leaves = []
    for pool in (kpool, vpool):
        if kv_quant:
            pool.codes.copy_(torch.randint(-127, 128, pool.codes.shape,
                                           generator=gen, device=cuda_device,
                                           dtype=torch.int8))
            pool.scales.uniform_(1e-3, 2e-2, generator=gen)
            leaves += [pool.codes, pool.scales]
        else:
            pool.normal_(generator=gen)
            leaves.append(pool)
    before = [t.clone() for t in leaves]
    dec._cow_copy(kpool, vpool, 3, 7)
    torch.cuda.synchronize()
    for t, b in zip(leaves, before):
        assert torch.equal(t[:, 7], b[:, 3])
        keep = [i for i in range(dec.num_blocks) if i != 7]
        assert torch.equal(t[:, keep], b[:, keep])


@pytest.mark.cuda
def test_chunk_graph_replay_after_poison_change(cuda_device):
    """The poison column changes between two replays of one captured chunk
    (``upload_poison``, one upload): the replay reads the new column, so
    its tokens, bad flags, state and pools equal the eager chunk's on
    clones with the same column, and the poisoned live slots are flagged
    bad."""
    model = _hd128_model("bfloat16")
    dec = PagedDecoder(model, max_len=64, block_size=16, max_slots=4,
                       num_blocks=17, device=cuda_device)
    kpool, vpool = dec.ensure_pools()
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(5)
    for pool in (kpool, vpool):
        pool.normal_(generator=gen)
    S, n = 4, 4
    tables = np.arange(1, 17, dtype=np.int32).reshape(S, 4)
    live = np.asarray([True, True, False, True])
    dec.upload_state(np.asarray([5, 17, 40, 3], np.int32),
                     np.asarray([9, 30, 6, 40], np.int32), tables, live,
                     np.asarray([7, 6, 5, 6], np.int32), np.zeros(S, bool))
    for poison in (np.asarray([True, False, True, True]),
                   np.zeros(S, bool)):
        uploads = dec.h2d_uploads
        dec.upload_poison(poison)
        assert dec.h2d_uploads == uploads + 1
        st0 = [t.clone() for t in dec.decode_state()]
        kc, vc = kpool.clone(), vpool.clone()
        toks, bad = dec.dispatch_chunk_state(n)
        torch.cuda.synchronize()
        got = [toks.clone(), bad.clone()] + [
            t.clone() for t in dec.decode_state()]
        ref = dec._paged_chunk_state(*st0, kc, vc, n)
        want = list(ref[:4]) + [st0[2], ref[4], ref[5], st0[5]]
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        for a, b in ((kpool, kc), (vpool, vc)):
            assert torch.equal(a[:, 1:].contiguous().view(torch.uint8),
                               b[:, 1:].contiguous().view(torch.uint8))
        assert got[1].cpu().numpy().tolist() == \
            (poison & st0[3].cpu().numpy()).tolist()
    assert dec._chunk_graphs.captured == 1
    assert dec._chunk_graphs.replays == 2


@pytest.fixture
def no_tf32():
    """float32 convolutions and products in float32 (the reference's
    "highest" precision), the flags put back after the test."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _close_of_max(got, ref, tol):
    err = (got.detach().cpu().float() - ref.detach().float()).abs().max()
    assert err <= tol * ref.detach().float().abs().max(), float(err)


@pytest.mark.cuda
@pytest.mark.parametrize("downsample", [False, True])
def test_bottleneck_block_on_the_card(cuda_device, no_tf32, downsample):
    """A ResNet-50 bottleneck in training mode, forward and backward, on
    cuDNN against the same block on the CPU: output, input and parameter
    gradients, and the batch norms' running statistics (float32, 1e-4 of
    each array's largest: summation order only)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.vision.models import BottleneckBlock

    def block(device):
        ds = ptt.nn.Sequential(
            ptt.nn.Conv2D(256, 512, 1, stride=2, bias_attr=False,
                          device=device),
            ptt.nn.BatchNorm2D(512, device=device)) if downsample else None
        return BottleneckBlock(256, 128 if downsample else 64,
                               2 if downsample else 1, ds, device=device)

    cpu = block("cpu")
    card = block("cuda")
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(31 + downsample)
    x = torch.from_numpy(rng.standard_normal((4, 256, 28, 28), np.float32))
    outs = {}
    for name, m, dev in (("cpu", cpu, "cpu"), ("card", card, "cuda")):
        xi = x.detach().to(dev).requires_grad_()
        out = m(xi)
        g = torch.from_numpy(rng.standard_normal(tuple(out.shape),
                                                 np.float32)) \
            if name == "cpu" else outs["cpu"][3].to(dev)
        (out * g).sum().backward()
        outs[name] = (out, xi.grad, {k: p.grad for k, p in
                                     m.named_parameters()}, g)
    (co, cx, cg, _), (ko, kx, kg, _) = outs["cpu"], outs["card"]
    _close_of_max(ko, co, 1e-4)
    _close_of_max(kx, cx, 1e-4)
    for k, ref in cg.items():
        _close_of_max(kg[k], ref, 1e-4)
    for k, ref in cpu.state_dict().items():
        _close_of_max(card.state_dict()[k], ref, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("fn,kw", [
    ("max_pool2d", dict(kernel_size=3, stride=2, padding=1)),
    ("max_pool2d", dict(kernel_size=2, stride=2, padding=1, ceil_mode=True)),
    ("avg_pool2d", dict(kernel_size=3, stride=2, padding=1)),
    ("avg_pool2d", dict(kernel_size=3, stride=2, padding=1, ceil_mode=True,
                        exclusive=False)),
    ("avg_pool2d", dict(kernel_size=3, stride=1, padding=2)),
    ("adaptive_avg_pool2d", dict(output_size=1)),
    ("adaptive_max_pool2d", dict(output_size=(3, 5))),
    ("max_pool1d", dict(kernel_size=3, stride=2, ceil_mode=True)),
    ("avg_pool3d", dict(kernel_size=2, stride=2, ceil_mode=True)),
], ids=["max_resnet", "max_ceil", "avg_resnet", "avg_ceil_inclusive",
        "avg_pad_past_half", "adaptive_avg_1x1", "adaptive_max_uneven",
        "max1d_ceil", "avg3d_ceil"])
def test_pools_on_the_card(cuda_device, fn, kw):
    """Each pool forward and backward on the card against the CPU: max
    pools' outputs bit for bit, their gradients (sums of the windows that
    share an element, in another order) and the averages to 1e-5 of the
    largest."""
    from paddle_tpu_torch.nn import functional as TF
    nd = int(fn[-2])
    rng = np.random.default_rng(nd + len(kw))
    x = torch.from_numpy(rng.standard_normal((2, 8) + (13,) * nd,
                                             np.float32))
    res = {}
    for dev in ("cpu", "cuda"):
        xi = x.detach().to(dev).requires_grad_()
        out = getattr(TF, fn)(xi, **kw)
        g = torch.linspace(-1, 1, out.numel()).reshape(out.shape).to(dev)
        (out * g).sum().backward()
        res[dev] = (out.detach().cpu(), xi.grad.cpu())
    (out, dx), (ref_out, ref_dx) = res["cuda"], res["cpu"]
    if "max" in fn:         # a window wholly in its padding gives -inf
        assert torch.equal(out, ref_out)
    else:
        assert (out - ref_out).abs().max() <= 1e-5 * ref_out.abs().max()
    assert (dx - ref_dx).abs().max() <= 1e-5 * ref_dx.abs().max()
    if fn == "max_pool2d":
        _, m_cpu = TF.max_pool2d(x, return_mask=True, **kw)
        _, m_card = TF.max_pool2d(x.cuda(), return_mask=True, **kw)
        assert torch.equal(m_card.cpu(), m_cpu)


@pytest.mark.cuda
def test_gloo_p2p_stages_cuda_tensors_through_host(cuda_device, tmp_path):
    """send/recv and batch_isend_irecv of CUDA tensors in two gloo ranks
    on the card: the values of a ring, each transfer counted by
    p2p_host_staged (6 float32 values = 24 bytes a transfer)."""
    import torch_dist_cases as cases
    world = cases.run_world(2, "p2p_cuda", {}, tmp_path)
    x = [np.arange(6, dtype=np.float32) + 10 * r for r in range(2)]
    for r, res in enumerate(world):
        assert res["device"].startswith("cuda")
        np.testing.assert_array_equal(res["recv"], x[1 - r])
        np.testing.assert_array_equal(res["fwd"], x[1 - r])
        np.testing.assert_array_equal(res["back"], 2 * x[1 - r])
        # isend + recv, then two sends and two receives
        assert res["staged"] == {"calls": 6, "bytes": 6 * 24}


@pytest.mark.cuda
def test_flash_attention_on_dtensors_launches_the_wgmma_pair(cuda_device,
                                                             monkeypatch):
    """flash_attention on DTensor q/k/v (batch split over dp, heads over
    mp) on a one-rank CUDA mesh: the wgmma forward and backward launch
    once each, flash_attention counts its kernel route, and the output
    and gradients equal the kernel's on the local tensors bit for bit,
    with the inputs' placements."""
    import paddle_tpu_torch.distributed as dist
    from torch.distributed.tensor import DTensor
    for k, v in {"PADDLE_TRAINER_ID": "0", "PADDLE_TRAINERS_NUM": "1",
                 "PADDLE_MASTER": "", "FLAGS_selected_gpus": "0"}.items():
        monkeypatch.setenv(k, v)
    dist.init_parallel_env()
    try:
        mesh = dist.ProcessMesh([[0]], dim_names=["dp", "mp"])
        rng = np.random.default_rng(26)
        b, s, h, d = 2, 256, 4, 128
        qkv = [torch.from_numpy(rng.standard_normal((b, s, h, d))
                                .astype(np.float32)).to(cuda_device,
                                                        torch.bfloat16)
               for _ in range(3)]
        g = torch.from_numpy(rng.standard_normal((b, s, h, d))
                             .astype(np.float32)).to(cuda_device,
                                                     torch.bfloat16)
        plc = [dist.Shard(0), dist.Shard(2)]
        dq, dk, dv = (dist.shard_tensor(x, mesh, plc).requires_grad_()
                      for x in qkv)
        fwd, bwd = (_flash_bhsd.route_launches["wgmma"],
                    _flash_bhsd_bwd.route_launches["wgmma"])
        routed = flash_attention.route_launches["kernel"]
        out, _ = flash_attention(dq, dk, dv, causal=True)
        assert isinstance(out, DTensor)
        assert tuple(out.placements) == tuple(dq.placements)
        out.backward(dist.shard_tensor(g, mesh, plc))
        assert _flash_bhsd.route_launches["wgmma"] == fwd + 1
        assert _flash_bhsd_bwd.route_launches["wgmma"] == bwd + 1
        assert flash_attention.route_launches["kernel"] == routed + 1
        lq, lk, lv = (x.clone().requires_grad_() for x in qkv)
        ref, _ = flash_attention(lq, lk, lv, causal=True)
        ref.backward(g)
        assert torch.equal(out.to_local(), ref)
        for dx, lx in ((dq, lq), (dk, lk), (dv, lv)):
            assert tuple(dx.grad.placements) == tuple(dx.placements)
            assert torch.equal(dx.grad.to_local(), lx.grad)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_dtensor_gathers_on_nccl_after_a_gloo_world_on_the_card(cuda_device,
                                                                monkeypatch):
    """A rank that joined a gloo world on the card (which reroutes torch's
    functional all-gathers to c10d's) and destroyed it gathers DTensors
    through torch's own kernels in a later NCCL world; the rerouted body
    itself serves an NCCL group too."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import collective
    for k, v in {"PADDLE_TRAINER_ID": "0", "PADDLE_TRAINERS_NUM": "1",
                 "PADDLE_MASTER": "", "FLAGS_selected_gpus": "0"}.items():
        monkeypatch.setenv(k, v)
    x = torch.arange(12, dtype=torch.float32, device=cuda_device).view(4, 3)
    for backend in ("gloo", "nccl"):
        dist.init_parallel_env(backend=backend)
        try:
            assert bool(collective._REROUTED) == (backend == "gloo")
            mesh = dist.ProcessMesh([[0]], dim_names=["dp", "mp"])
            d = dist.shard_tensor(x, mesh, [dist.Shard(0), dist.Shard(1)])
            assert d.device.type == "cuda"
            assert torch.equal(d.full_tensor(), x)
            assert torch.equal(dist.unshard_dtensor(d), x)
            group = mesh.device_mesh().get_group(0)
            assert torch.equal(collective._c10d_all_gather(
                x, 1, group.group_name), x)
        finally:
            dist.destroy_process_group()
        assert not collective._REROUTED
