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
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels.flash_attention import (
    _flash_bhsd, _flash_bhsd_bwd, flash_attention_bwd_plain,
    flash_attention_fwd_plain)
from paddle_tpu_torch.nn.functional.flash_attention import (
    flash_attention, scaled_dot_product_attention)
from paddle_tpu_torch.kernels.grouped_matmul import (
    _ref_dw, _ref_fwd, grouped_matmul, grouped_matmul_dw,
    grouped_matmul_fwd, grouped_metadata)
from paddle_tpu_torch.kernels.quant_matmul import (
    quant_grouped_matmul, quant_grouped_matmul_plain, quant_matmul,
    quant_matmul_plain, quantize_weight_blockwise)
from paddle_tpu_torch.kernels.ragged_paged_attention import (
    kv_quantize_rows, merge_partials, ragged_paged_attention,
    ragged_paged_attention_partials, ragged_paged_attention_partials_plain,
    ragged_paged_attention_plain, ragged_paged_attention_quant,
    ragged_paged_attention_quant_plain)

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
        got = _flash_bhsd_bwd(qt, kt, vt, o, lse, dot, causal, scale)
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
    for fn in (flash_attention, scaled_dot_product_attention):
        q, k, v = (torch.from_numpy(a).to(cuda_device).requires_grad_()
                   for a in (qn, kn, vn))
        out = fn(q, k.repeat_interleave(h // hkv, dim=2),
                 v.repeat_interleave(h // hkv, dim=2), causal=causal)
        out.backward(torch.from_numpy(gn).to(cuda_device))
        grads.append((out.detach(), q.grad, k.grad, v.grad))
    torch.cuda.synchronize()
    for got, ref in zip(*grads):
        assert _bwd_close(got, ref, 0.0, 1e-4)[0]


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
    """Both kernels (rows for M <= 32, tiles above), blocks below 128 and
    not a multiple of 8, K not a multiple of 8 (the element-wise path),
    float32 and bfloat16 x."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 2, 3, 8])
@pytest.mark.parametrize("nh,nkv,hd", [(32, 32, 128), (16, 4, 64)])
def test_partials_kernel_matches_plain(cuda_device, shards, nh, nkv, hd):
    """Per-shard o and lse against the plain partials (empty shards
    included), and the merged result against the unsharded kernel."""
    bs, mb = 16, 8
    lens = [0, bs - 1, bs, 77, mb * bs - 1]
    q, kp, vp, tables, seq = _ragged_inputs(cuda_device, shards + hd, nh,
                                            nkv, hd, bs, mb, lens)
    before = ragged_paged_attention_partials.launches
    for dt, tol in TOLS:
        args = (q.to(dt), kp.to(dt), vp.to(dt), tables, seq)
        o, lse = ragged_paged_attention_partials(*args, shards)
        ro, rlse = ragged_paged_attention_partials_plain(*args, shards,
                                                         hd ** -0.5)
        torch.cuda.synchronize()
        assert o.dtype == lse.dtype == torch.float32
        assert (o - ro).abs().max().item() < 1e-4
        live = rlse > -1e29
        assert torch.equal(live, lse > -1e29)
        assert (lse - rlse)[live].abs().max().item() < 1e-4
        assert (o[~live] == 0).all()
        merged = merge_partials(o, lse, dt)
        whole = ragged_paged_attention(*args)
        assert (merged.float() - whole.float()).abs().max().item() < tol
    assert ragged_paged_attention_partials.launches == before + 2


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


def _grouped_close(out, ref, rows, bf16):
    o, r = out.float()[rows], ref.float()[rows]
    lim = 1e-5 * r.abs().max() + (2.0 ** -7 if bf16 else 1e-6) * r.abs()
    assert ((o - r).abs() <= lim).all(), (o - r).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,k,n,e,bm", [(300, 64, 96, 4, 8),
                                        (1000, 130, 36, 8, 128),
                                        (2048, 256, 512, 8, 128)])
def test_grouped_kernels_match_plain(cuda_device, dtype, t, k, n, e, bm):
    """Forward with and without bias, the transposed forward (dx) and dw,
    on a skewed routing with one empty expert."""
    md, x, w, b, dy = _grouped_inputs(cuda_device, t + k, t, k, n, e, bm,
                                      dtype, empty=1)
    off, cnt = md["offsets"], md["counts"]
    rows = md["dest"].long()
    bf16 = dtype == torch.bfloat16
    f0, d0 = grouped_matmul_fwd.launches, grouped_matmul_dw.launches
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


@pytest.mark.cuda
def test_grouped_kernels_never_read_dead_rows(cuda_device):
    """NaN in every row that is not a route's (padding inside a group's
    last tile, whole tiles past the groups): the routed outputs equal the
    clean run's, and dw stays finite and equal."""
    md, x, w, b, dy = _grouped_inputs(cuda_device, 5, 700, 96, 160, 8, 128,
                                      torch.float32, empty=3)
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
@pytest.mark.parametrize("k,n,block_k", [(256, 96, None), (192, 520, 64),
                                         (130, 40, 65)])
def test_quant_grouped_kernel_matches_plain(cuda_device, qdtype, dtype, k,
                                            n, block_k):
    md, x, w, _, _ = _grouped_inputs(cuda_device, k + n, 900, k, n, 8, 128,
                                     dtype, empty=0)
    codes, scales = quantize_weight_blockwise(w.float().transpose(1, 2),
                                              block_k, qdtype)
    before = quant_grouped_matmul.launches
    out = quant_grouped_matmul(x, codes, scales, group_offsets=md["offsets"],
                               group_counts=md["counts"], bm=128)
    ref = quant_grouped_matmul_plain(x, codes, scales, md["offsets"],
                                     md["counts"], 128)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    assert quant_grouped_matmul.launches == before + 1
    _grouped_close(out, ref, md["dest"].long(), dtype == torch.bfloat16)
