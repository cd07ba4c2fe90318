"""The port's int8 KV row codec and quantized ragged paged attention
against the JAX package, on the CPU.

The codec must equal JAX's bit for bit. The port's wrapper runs its plain
PyTorch version on a CPU tensor; the JAX quantized kernel (`_qkernel`)
runs in Pallas interpret mode, as the JAX package's own tests run it.
Tolerance: float32 atol = rtol = 1e-5 (the two sum the softmax in other
orders: online over blocks in the kernel, one pass in the plain version).

The CUDA kernel is held against the plain version on the card by
tests/test_torch_cuda_kernels.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddle_tpu.kernels.pallas import ragged_paged_attention as jrpa

from paddle_tpu_torch.kernels.ragged_paged_attention import (
    kv_dequantize_rows, kv_quantize_rows, kv_row_error_bound,
    ragged_paged_attention_quant, ragged_paged_attention_quant_plain)

TOL = 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_codec_bit_identical(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 7, 2, 16)).astype(np.float32)
    x[1, 3] = 0.0                      # a zero row: scale 1, codes 0
    x[2, 0] *= 1e3                     # rows of their own range
    x[4, 6] = 0.5                      # exact halves round to even
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16"
                     else jnp.float32)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jc, js = jrpa.kv_quantize_rows(jx)
    tc, ts = kv_quantize_rows(tx)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[1, 3] == 1.0 and (tc[1, 3] == 0).all()
    deq = kv_dequantize_rows(tc, ts)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jrpa.kv_dequantize_rows(jc, js)))
    bound = kv_row_error_bound(tx)
    np.testing.assert_allclose(bound.numpy(), jrpa.kv_row_error_bound(
        np.asarray(jx.astype(jnp.float32))), rtol=1e-6)
    # within half a step, up to float32 rounding of the scale and product
    err = (deq - tx.float()).abs().amax(dim=(-2, -1))
    assert (err <= bound * (1 + 1e-5)).all()


def _case(seed, nh, nkv, hd, bs, mb, lens):
    """q, int8 pools with row scales (quantized from normal draws), and
    distinct non-trash tables."""
    rng = np.random.default_rng(seed)
    S = len(lens)
    nb = S * mb + 1
    kc, ks = (np.asarray(a) for a in jrpa.kv_quantize_rows(jnp.asarray(
        rng.standard_normal((nb, bs, nkv, hd)).astype(np.float32))))
    vc, vs = (np.asarray(a) for a in jrpa.kv_quantize_rows(jnp.asarray(
        rng.standard_normal((nb, bs, nkv, hd)).astype(np.float32))))
    q = rng.standard_normal((S, nh, hd)).astype(np.float32)
    tables = (rng.permutation(nb - 1)[:S * mb] + 1).reshape(S, mb).astype(
        np.int32)
    return [q, kc.copy(), ks.copy(), vc.copy(), vs.copy(), tables,
            np.asarray(lens, np.int32)]


def _jax(q, kc, ks, vc, vs, tables, lens):
    return np.asarray(jax.jit(jrpa.ragged_paged_attention_quant)(
        jnp.asarray(q, jnp.float32), jnp.asarray(kc, jnp.int8),
        jnp.asarray(ks, jnp.float32), jnp.asarray(vc, jnp.int8),
        jnp.asarray(vs, jnp.float32), jnp.asarray(tables, jnp.int32),
        jnp.asarray(lens, jnp.int32)))


def _port(q, kc, ks, vc, vs, tables, lens):
    t = torch.from_numpy
    before = ragged_paged_attention_quant.launches
    out = ragged_paged_attention_quant(t(q), t(kc), t(ks), t(vc), t(vs),
                                       t(tables), t(lens))
    assert ragged_paged_attention_quant.launches == before  # plain on CPU
    return out.numpy()


@pytest.mark.parametrize("nh,nkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("bs", [8, 16])
def test_matches_jax_kernel(nh, nkv, bs):
    """Lengths 0, mid-block, block end and full span, MHA and GQA."""
    mb = 4
    lens = [0, bs // 2 + 1, bs - 1, 2 * bs + 3, mb * bs - 1]
    args = _case(nh * 100 + nkv * 10 + bs, nh, nkv, 16, bs, mb, lens)
    np.testing.assert_allclose(_port(*args), _jax(*args), atol=TOL,
                               rtol=TOL)


def _poison(args, bs, v_scales_in_live_block):
    """Code 127 at every position past each seq_len and NaN scales past
    the live block (whole blocks, the trash block). Inside the live block
    the positions past seq_len get NaN K scales, and NaN V scales when
    asked: the JAX kernel masks the scores of the live block's tail but
    multiplies its V rows by p = 0, so a NaN V scale there reaches its
    output as 0 x NaN."""
    q, kc, ks, vc, vs, tables, lens = args
    S, mb = tables.shape
    for s in range(S):
        for p in range(lens[s] + 1, mb * bs):
            blk, lane = tables[s, p // bs], p % bs
            kc[blk, lane] = vc[blk, lane] = 127
            ks[blk, lane] = np.nan
            live_block = p // bs == lens[s] // bs
            if v_scales_in_live_block or not live_block:
                vs[blk, lane] = np.nan
    ks[0] = vs[0] = np.nan
    kc[0] = vc[0] = 127
    return args


@pytest.mark.parametrize("nh,nkv", [(4, 4), (4, 2)])
def test_poison_past_seq_lens_matches_jax(nh, nkv):
    bs, mb = 8, 4
    lens = [0, 5, 7, 19, mb * bs - 1]
    args = _case(77 + nh, nh, nkv, 16, bs, mb, lens)
    clean = _port(*args)
    args = _poison(args, bs, v_scales_in_live_block=False)
    out = _port(*args)
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out, clean)
    np.testing.assert_allclose(out, _jax(*args), atol=TOL, rtol=TOL)


def test_nan_v_scales_inside_the_live_block_never_reach_the_output():
    """The port reads no position past seq_len, so it stays finite and
    equal to the JAX kernel's output on the clean pool."""
    bs, mb = 8, 4
    lens = [0, 5, 9, 19, 30]
    args = _case(91, 4, 2, 16, bs, mb, lens)
    ref = _jax(*args)
    args = _poison(args, bs, v_scales_in_live_block=True)
    out = _port(*args)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


def test_bf16_query_and_checks():
    args = _case(5, 4, 2, 64, 8, 2, [3, 12])
    q, kc, ks, vc, vs, tables, lens = (torch.from_numpy(a) for a in args)
    out = ragged_paged_attention_quant(q.to(torch.bfloat16), kc, ks, vc, vs,
                                       tables, lens)
    assert out.dtype == torch.bfloat16
    ref = ragged_paged_attention_quant_plain(q, kc, ks, vc, vs, tables,
                                             lens, 64 ** -0.5)
    assert (out.float() - ref).abs().max() < 2e-2


# -- the clustered decode body over the int8 pool ----------------------------
# The float32 emulation of the kernel's plan and rank-order merge
# (tests/test_torch_ragged_paged_attention.py), with the row scale on the
# finished q.k dot and on p, against the JAX `_qkernel` in interpret mode.

from test_torch_ragged_paged_attention import (  # noqa: E402
    _decode_emulation)


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("ts", [4, 16])
def test_decode_emulation_matches_jax_qkernel(splits, ts):
    """Lengths at every page edge, one token and the whole table, MHA and
    GQA; at 8 splits more ranks than live pages."""
    bs, mb = 8, 4
    lens = [0, 1, bs - 1, bs, 2 * bs - 1, 2 * bs, 3 * bs + 2, mb * bs - 1]
    for nh, nkv in ((4, 4), (4, 2)):
        args = _case(30 + splits + nh + nkv, nh, nkv, 16, bs, mb, lens)
        q, kc, ks, vc, vs, tables, lens_ = args
        S = len(lens)
        got = _decode_emulation(
            q, kc[tables].reshape(S, mb * bs, nkv, 16),
            vc[tables].reshape(S, mb * bs, nkv, 16), lens_, 16 ** -0.5,
            splits, ts, bs, mb, ks=ks[tables].reshape(S, mb * bs),
            vs=vs[tables].reshape(S, mb * bs))
        np.testing.assert_allclose(got, _jax(*args), atol=TOL, rtol=TOL)
