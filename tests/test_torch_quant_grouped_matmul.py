"""The port's grouped quantized matmul against the JAX package, on the CPU.

The JAX codec quantizes an expert stack w [E, K, N] into codes [E, K, N]
and scales [E, K // block_k, N]. The port quantizes the stack in its
[E, N, K] view (kernels/quant_matmul.py's layout, blocks along the last
dim), and its codes and scales must equal JAX's transposed, bit for bit.
``quant_grouped_matmul`` (the plain version of the CUDA kernel on CPU
tensors) is held against JAX's Pallas kernel ``_gq_kernel`` in interpret
mode (``impl="kernel"``), and ``quantized_grouped_linear``'s
straight-through gradients against JAX's custom VJP.

Tolerances: 1e-5 of each tensor's largest element in float32 (both
dequantize to the same float32 weights and sum K products in different
orders), and for bf16 activations one bf16 ulp of the value plus that.
Only the rows ``dest`` points at are compared (padding rows are
unspecified in both).

The card's tensor-core route ("wgmma", `gq_route`) multiplies the codes,
converted exactly to bf16, against x: bf16 x as it is, float32 x split
exactly into three bf16 pieces (`split3_bf16`, the kernel's rule), three
products a k16 step into a float32 partial per K-block, the block's scale
on the accumulator. The split is checked bit for bit (hypothesis over
finite float32 of |x| >= 2^-100, and the edges: FLT_MAX, values that
rounding would carry into the next binade, inf, NaNs whose payload sits in
the low 16 bits), and a float32 emulation of that arithmetic
(`_wgmma_emulation`) is held to JAX's ``_gq_kernel`` in interpret mode at
this file's tolerance.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
import paddle_tpu  # noqa: F401  (x64 on, as in the JAX package's tests)
from paddle_tpu.kernels.pallas import grouped_matmul as jgm
from paddle_tpu.kernels.pallas import quant_matmul as jqm

from paddle_tpu_torch.kernels.grouped_matmul import grouped_metadata
from paddle_tpu_torch.kernels.quant_matmul import (
    GQ_ROUTES, configure_matmul_quant, dequantize_weight_blockwise,
    get_matmul_quant, gq_route, quant_grouped_matmul,
    quant_grouped_matmul_plain, quantize_weight_blockwise,
    quantized_grouped_linear, split3_bf16)
from torch_threads import one_thread  # noqa: F401  (autouse)

REL_TOL = 1e-5
BF16_RTOL = 2.0 ** -7
E, BM = 4, 8


def _setup(k, n, seed, t=37):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, E - 1, t).astype(np.int32)   # expert 3 is empty
    jmd = jgm.grouped_metadata(jnp.asarray(ids), E, BM)
    tmd = grouped_metadata(torch.from_numpy(ids), E, BM)
    row_src = np.asarray(jmd["row_src"])
    x = rng.standard_normal((t, k)).astype(np.float32)
    buf = np.where((row_src >= 0)[:, None], x[np.clip(row_src, 0, None)],
                   0).astype(np.float32)
    w = rng.standard_normal((E, k, n)).astype(np.float32)
    w[1, :, 0] *= 30.0                          # a column of its own range
    w[2, :, 1] = 0.0                            # an all-zero column
    b = rng.standard_normal((E, n)).astype(np.float32)
    return jmd, tmd, buf, w, b


def _close(got, ref, bf16=False):
    lim = REL_TOL * np.abs(ref).max() + (BF16_RTOL * np.abs(ref) if bf16
                                         else 0.0)
    assert (np.abs(got - ref) <= lim).all(), np.abs(got - ref).max()


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
@pytest.mark.parametrize("k,block_k", [(64, None), (192, 64), (256, None)])
def test_stacked_codec_bit_identical(qdtype, k, block_k):
    _, _, _, w, _ = _setup(k, 24, seed=k)
    jc, js = jqm.quantize_weight_blockwise(jnp.asarray(w), block_k, qdtype)
    tc, ts = quantize_weight_blockwise(torch.from_numpy(w).transpose(1, 2),
                                       block_k, qdtype)
    assert tc.is_contiguous() and ts.is_contiguous()
    assert tuple(tc.shape) == (E, 24, k)
    jc_t = np.ascontiguousarray(np.swapaxes(np.asarray(jc), 1, 2))
    np.testing.assert_array_equal(tc.view(torch.uint8).numpy(),
                                  jc_t.view(np.uint8))
    np.testing.assert_array_equal(ts.numpy(),
                                  np.swapaxes(np.asarray(js), 1, 2))
    assert (ts[2, 1] == 1.0).all()               # zero column: unit scale


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
@pytest.mark.parametrize("k,n,block_k", [(64, 48, None), (192, 40, 64)])
def test_matches_jax_grouped_kernel(qdtype, k, n, block_k):
    jmd, tmd, buf, w, _ = _setup(k, n, seed=k + n)
    jc, js = jqm.quantize_weight_blockwise(jnp.asarray(w), block_k, qdtype)
    ref = np.asarray(jqm.quant_grouped_matmul(
        jnp.asarray(buf), jc, js, group_offsets=jmd["offsets"],
        group_counts=jmd["counts"], bm=BM, bn=16, impl="kernel"))
    tc, ts = quantize_weight_blockwise(torch.from_numpy(w).transpose(1, 2),
                                       block_k, qdtype)
    before = quant_grouped_matmul.launches
    out = quant_grouped_matmul(torch.from_numpy(buf), tc, ts,
                               group_offsets=tmd["offsets"],
                               group_counts=tmd["counts"], bm=BM)
    assert quant_grouped_matmul.launches == before   # the CPU: plain path
    assert out.dtype == torch.float32 and tuple(out.shape) == (buf.shape[0],
                                                               n)
    d = np.asarray(jmd["dest"])
    _close(out.numpy()[d], ref[d])


def test_bf16_activations():
    jmd, tmd, buf, w, _ = _setup(64, 32, seed=5)
    buf = torch.from_numpy(buf).to(torch.bfloat16)
    jc, js = jqm.quantize_weight_blockwise(jnp.asarray(w))
    ref = np.asarray(jqm.quant_grouped_matmul(
        jnp.asarray(buf.float().numpy(), jnp.bfloat16), jc, js,
        group_offsets=jmd["offsets"], group_counts=jmd["counts"], bm=BM,
        bn=16, impl="kernel").astype(jnp.float32))
    tc, ts = quantize_weight_blockwise(torch.from_numpy(w).transpose(1, 2))
    out = quant_grouped_matmul(buf, tc, ts, group_offsets=tmd["offsets"],
                               group_counts=tmd["counts"], bm=BM)
    assert out.dtype == torch.bfloat16
    d = np.asarray(jmd["dest"])
    _close(out.float().numpy()[d], ref[d], bf16=True)


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
def test_ste_gradients_match_jax(qdtype):
    """Forward values through the quantized kernel, dx/dw/db in full
    precision against the unquantized weight (JAX's `_qgmm_vjp`)."""
    k, n = 64, 32
    jmd, tmd, buf, w, b = _setup(k, n, seed=13)
    g = np.random.default_rng(14).standard_normal((37, n)).astype(
        np.float32)
    dest = jmd["dest"]

    def jloss(buf, w, b):
        o = jqm.quantized_grouped_linear(
            buf, w, b, group_offsets=jmd["offsets"],
            group_counts=jmd["counts"], qdtype=qdtype, bm=BM, bn=16,
            impl="kernel")
        return jnp.sum(o[dest] * g), o

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(
        jnp.asarray(buf), jnp.asarray(w), jnp.asarray(b))
    ts = [torch.from_numpy(a).requires_grad_() for a in (buf, w, b)]
    out = quantized_grouped_linear(*ts, group_offsets=tmd["offsets"],
                                   group_counts=tmd["counts"],
                                   qdtype=qdtype, bm=BM)
    (out[tmd["dest"].long()] * torch.from_numpy(g)).sum().backward()
    d = np.asarray(dest)
    _close(out.detach().numpy()[d], np.asarray(jout)[d])
    valid = np.asarray(jmd["row_valid"])
    for name, r, t in zip(("dx", "dw", "db"), jg, ts):
        r, t = np.asarray(r), t.grad.numpy()
        if name == "dx":
            r, t = r[valid], t[valid]
        _close(t, r)


def test_plain_version_is_the_dequantized_grouped_product():
    _, tmd, buf, w, _ = _setup(64, 16, seed=15)
    tc, ts = quantize_weight_blockwise(torch.from_numpy(w).transpose(1, 2))
    out = quant_grouped_matmul_plain(torch.from_numpy(buf), tc, ts,
                                     tmd["offsets"], tmd["counts"], BM)
    assert out.shape == (buf.shape[0], 16)
    with pytest.raises(ValueError):
        quant_grouped_matmul(torch.from_numpy(buf), tc[:, :, :32], ts,
                             group_offsets=tmd["offsets"],
                             group_counts=tmd["counts"], bm=BM)
    with pytest.raises(ValueError, match="qdtype"):
        quantized_grouped_linear(torch.from_numpy(buf), torch.from_numpy(w),
                                 group_offsets=tmd["offsets"],
                                 group_counts=tmd["counts"], qdtype="int4")


def test_matmul_quant_knob_mirrors_jax():
    before = get_matmul_quant()
    try:
        for val in ("int8", "fp8", None):
            assert configure_matmul_quant(val) == \
                jqm.configure_matmul_quant(val) == {"dtype": val}
            assert get_matmul_quant() == val
        assert configure_matmul_quant("none") == {"dtype": None}
        with pytest.raises(ValueError):
            configure_matmul_quant("int4")
    finally:
        configure_matmul_quant(before)
        jqm.configure_matmul_quant(before)


# -- the tensor-core route's arithmetic ---------------------------------------

def _f32(bits):
    return np.array(bits, dtype=np.uint32).view(np.float32)


def _exact_sum(x):
    """hi + mid + lo of split3_bf16(x), summed in float64, as float64."""
    return sum(p.double() for p in split3_bf16(torch.from_numpy(x)))


@settings(max_examples=400, deadline=None, derandomize=True, database=None)
@given(st.lists(st.floats(width=32, allow_nan=False, allow_infinity=False)
                .filter(lambda v: v == 0 or abs(v) >= 2.0 ** -100),
                min_size=1, max_size=64))
def test_split3_reconstructs_finite_float32_exactly(vals):
    x = np.array(vals, dtype=np.float32)
    got = _exact_sum(x).numpy()
    np.testing.assert_array_equal(got, x.astype(np.float64))
    # bit for bit, but for -0.0, whose pieces are -0, +0 and +0
    nz = x != 0
    assert (got.astype(np.float32).view(np.uint32)[nz]
            == x.view(np.uint32)[nz]).all()
    assert (split3_bf16(torch.from_numpy(x))[0].view(torch.int16).numpy()
            < 0)[~nz].tolist() == np.signbit(x[~nz]).tolist()


def test_split3_edges():
    """Truncation: FLT_MAX and values just under a power of two (which
    rounding to bf16 would carry into the next binade, or to inf) split
    exactly; inf goes whole into hi with mid = lo = 0; a NaN, even one
    whose payload sits in the low 16 bits alone, stays NaN in hi."""
    fmax = np.finfo(np.float32).max
    x = np.array([fmax, -fmax, np.nextafter(np.float32(2.0), 0),
                  np.nextafter(np.float32(-1.0), 0), np.float32(255.99998),
                  _f32(0x7F7FFFFF), _f32(0x3FFFFFFF), 0.0, -0.0,
                  2.0 ** -100, -(2.0 ** -100) * 1.2345678],
                 dtype=np.float32)
    hi, mid, lo = split3_bf16(torch.from_numpy(x))
    assert torch.isfinite(hi).all()
    np.testing.assert_array_equal(_exact_sum(x).numpy(),
                                  x.astype(np.float64))
    # hi is a truncation: never larger in magnitude than x
    assert (hi.double().abs() <= torch.from_numpy(x).double().abs()).all()
    bad = np.array([np.inf, -np.inf, np.nan, _f32(0x7F800001),
                    _f32(0xFF800001), _f32(0x7FC00000), _f32(0x7F80FFFF)],
                   dtype=np.float32)
    hi, mid, lo = split3_bf16(torch.from_numpy(bad))
    assert hi[0].item() == np.inf and hi[1].item() == -np.inf
    assert torch.isnan(hi[2:]).all()
    assert (mid == 0).all() and (lo == 0).all()


def test_three_pieces_are_needed():
    """What the float32 rule (1e-6 |ref| + 1e-5 max|ref|) leaves after the
    pieces, in float64 so that no summation error enters: three pieces
    are exact; two truncated pieces (hi + mid) already take most of the
    rule on unit normal x at the MoE path's K (measured: 0.93 at K 768
    and 3072), before any float32 summation order; hi alone misses it by
    far."""
    gen = torch.Generator().manual_seed(0)
    for k in (768, 3072):
        x = torch.randn(512, k, generator=gen)
        w = torch.randn(128, k, generator=gen) * k ** -0.5
        c, s = quantize_weight_blockwise(w)
        wd = dequantize_weight_blockwise(c, s).double()
        ref = x.double() @ wd.t()
        lim = 1e-6 * ref.abs() + 1e-5 * ref.abs().max()
        hi, mid, lo = (p.double() for p in split3_bf16(x))
        share = [((xs @ wd.t() - ref).abs() / lim).max().item()
                 for xs in (hi + mid + lo, hi + mid, hi)]
        assert share[0] == 0.0
        assert 0.5 < share[1] < 1.0, share
        assert share[2] > 100.0, share


@pytest.mark.parametrize("dtype,bk,bm,ptrs,route", [
    (torch.float32, 128, 128, (0, 16), "wgmma"),
    (torch.bfloat16, 64, 256, (32, 4096), "wgmma"),
    (torch.float32, 192, 128, (0, 0), "wgmma"),
    (torch.float32, 96, 128, (0, 0), "cuda_core"),     # not whole stages
    (torch.bfloat16, 32, 128, (0, 0), "cuda_core"),
    (torch.float32, 128, 64, (0, 0), "cuda_core"),      # tiles straddle groups
    (torch.bfloat16, 128, 8, (0, 0), "cuda_core"),
    (torch.float32, 128, 128, (4, 0), "cuda_core"),     # x off by 4 bytes
    (torch.float32, 128, 128, (0, 8), "cuda_core"),     # codes off by 8
    (torch.float16, 128, 128, (0, 0), "cuda_core"),
])
def test_gq_route(dtype, bk, bm, ptrs, route):
    assert gq_route(dtype, bk, bm, ptrs) == route
    assert route in GQ_ROUTES


def _wgmma_emulation(x, codes, scales, offsets, counts, bm):
    """The tensor-core kernel's arithmetic in float32 on the CPU: over each
    group's live rows, per K-block, a partial of the pieces' products
    (hi, mid and lo of float32 x, or bf16 x itself) against the codes
    converted to bf16 (exact), each product exact; then acc += scale *
    partial. Rounded to x's dtype; rows past the live tiles stay 0."""
    e, n, k = codes.shape
    kb = scales.shape[2]
    bk = k // kb
    cb = codes.float().to(torch.bfloat16)
    assert torch.equal(cb.float(), codes.float())       # exact in bf16
    pieces = split3_bf16(x) if x.dtype == torch.float32 else (x,)
    out = torch.zeros(x.shape[0], n)
    for g in range(e):
        c = int(counts[g])
        if c == 0:
            continue
        r0 = int(offsets[g])
        r1 = r0 + -(-c // bm) * bm
        acc = torch.zeros(r1 - r0, n)
        for b in range(kb):
            ks = slice(b * bk, (b + 1) * bk)
            part = sum(torch.matmul(p[r0:r1, ks].float(),
                                    cb[g, :, ks].float().t())
                       for p in pieces)
            acc += scales[g, :, b] * part
        out[r0:r1] = acc
    return out.to(x.dtype)


def _setup_wgmma(k, n, seed, t=300):
    """The route's layout: bm 128, 4 experts, the last one empty, group
    sizes that leave a partial last tile."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, E - 1, t).astype(np.int32)
    jmd = jgm.grouped_metadata(jnp.asarray(ids), E, 128)
    tmd = grouped_metadata(torch.from_numpy(ids), E, 128)
    row_src = np.asarray(jmd["row_src"])
    x = rng.standard_normal((t, k)).astype(np.float32)
    buf = np.where((row_src >= 0)[:, None], x[np.clip(row_src, 0, None)],
                   0).astype(np.float32)
    w = rng.standard_normal((E, k, n)).astype(np.float32)
    w[1, :, 0] *= 30.0
    return jmd, tmd, buf, w


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_k", [64, 128])
def test_wgmma_emulation_matches_jax_kernel(qdtype, xdtype, block_k):
    """K 256 (2 or 4 K-blocks), N 200 (not a multiple of the 128-column
    tile), bm 128 with a partial last tile in each group and an empty
    expert: the emulation against `_gq_kernel` in interpret mode."""
    k, n = 256, 200
    jmd, tmd, buf, w = _setup_wgmma(k, n, seed=block_k + len(qdtype))
    counts = np.asarray(jmd["counts"])
    assert counts[E - 1] == 0 and (counts[:E - 1] % 128).all()
    jc, js = jqm.quantize_weight_blockwise(jnp.asarray(w), block_k, qdtype)
    tc, ts = quantize_weight_blockwise(torch.from_numpy(w).transpose(1, 2),
                                       block_k, qdtype)
    bf16 = xdtype == "bfloat16"
    tx = torch.from_numpy(buf)
    jx = jnp.asarray(buf)
    if bf16:
        tx = tx.to(torch.bfloat16)
        jx = jnp.asarray(tx.float().numpy(), jnp.bfloat16)
    ref = np.asarray(jqm.quant_grouped_matmul(
        jx, jc, js, group_offsets=jmd["offsets"], group_counts=jmd["counts"],
        bm=128, bn=40, impl="kernel").astype(jnp.float32))
    assert gq_route(tx.dtype, block_k, 128, (0, 0)) == "wgmma"
    out = _wgmma_emulation(tx, tc, ts, tmd["offsets"], tmd["counts"], 128)
    assert out.dtype == tx.dtype
    d = np.asarray(jmd["dest"])
    _close(out.float().numpy()[d], ref[d], bf16=bf16)
    # and the plain version the card holds the kernel to
    plain = quant_grouped_matmul_plain(tx, tc, ts, tmd["offsets"],
                                       tmd["counts"], 128)
    _close(out.float().numpy()[d], plain.float().numpy()[d], bf16=bf16)
