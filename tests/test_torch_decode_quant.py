"""The port's quantized and long-context serving options against the JAX
engines, on the CPU at a tiny size (float32, the Llama of
tests/test_torch_decode.py, head dim 64, weights carried by
convert.params_from_jax):

- ``CachedDecoder(weight_quant="int8" | "int8_blockwise")``;
- ``PagedDecoder(kv_quant="int8")``, ragged and dense, with and without
  block-scaled weights;
- ``PagedDecoder(attn_shards=2 | 4)`` and ``shard_block_budget``.

Token streams must be identical. Logits agree within 1e-4 of their
largest magnitude (the two frameworks sum products in other orders). The
int8_blockwise lane is held against JAX's int8_blockwise engine, not
against the dense engine: on this random tiny model the two can differ at
a near-tie (tests/test_decode.py::test_int8_blockwise_weight_lane). The
JAX ragged paths run their Pallas kernels in interpret mode.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as pt
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.decode import CachedDecoder as JaxCachedDecoder
from paddle_tpu.models.paged_decode import PagedDecoder as JaxPagedDecoder

from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.kernels.quant_matmul import quant_matmul
from paddle_tpu_torch.kernels.ragged_paged_attention import (
    ragged_paged_attention_partials, ragged_paged_attention_quant)
from paddle_tpu_torch.models.decode import CachedDecoder
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models.paged_decode import PagedDecoder, QuantizedPool

TINY = dict(vocab_size=97, hidden_size=256, intermediate_size=128,
            num_hidden_layers=3, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=192,
            use_flash_attention=False, dtype="float32")
REL = 1e-4


@pytest.fixture(scope="module")
def models():
    pt.seed(5)
    jmodel = JaxLlama(JaxLlamaConfig(**TINY))
    jmodel.eval()
    sd = {k: np.asarray(v.numpy()) for k, v in jmodel.state_dict().items()}
    cfg = LlamaConfig(**TINY)
    tmodel = LlamaForCausalLM(cfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(sd, cfg))
    tmodel.eval()
    return jmodel, tmodel


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, 97, shape).astype(
        np.int64)


def _close(out, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(out), ref,
                               atol=REL * np.abs(ref).max(), rtol=0)


# -- CachedDecoder(weight_quant=...) -------------------------------------------

@pytest.mark.parametrize("wq", ["int8", "int8_blockwise"])
def test_weight_quant_codes_and_bytes_match_jax(models, wq):
    jmodel, tmodel = models
    jdec = JaxCachedDecoder(jmodel, max_len=32, weight_quant=wq)
    tdec = CachedDecoder(tmodel, max_len=32, weight_quant=wq, device="cpu")
    assert tdec.weight_stream_bytes == jdec.weight_stream_bytes
    # the dense stacks and the float32 head are gone
    assert set(tdec.w) == {"ln1", "ln2"} and tdec.head is None
    for k in ("wq", "wd"):
        np.testing.assert_array_equal(
            tdec.wq8[k].numpy(), np.swapaxes(np.asarray(jdec.wq8[k]), 1, 2))
        np.testing.assert_array_equal(
            tdec.wscale[k].numpy(),
            np.swapaxes(np.asarray(jdec.wscale[k]), 1, 2))
    np.testing.assert_array_equal(tdec.head_q8.numpy(),
                                  np.asarray(jdec.head_q8).T)
    np.testing.assert_array_equal(tdec.head_scale.numpy(),
                                  np.asarray(jdec.head_scale).T)


def test_dense_weight_bytes_match_jax(models):
    jmodel, tmodel = models
    assert CachedDecoder(tmodel, max_len=32, device="cpu") \
        .weight_stream_bytes == \
        JaxCachedDecoder(jmodel, max_len=32).weight_stream_bytes


@pytest.mark.parametrize("wq", ["int8", "int8_blockwise"])
@pytest.mark.parametrize("s0", [9, 128])
def test_weight_quant_generate_matches_jax(models, wq, s0):
    """Prefill and first decode step logits, then the greedy streams
    (s0 = 128 runs the flash prefill on both sides)."""
    jmodel, tmodel = models
    ids = _ids(11 + s0, (2, s0))
    jdec = JaxCachedDecoder(jmodel, max_len=s0 + 12, weight_quant=wq)
    tdec = CachedDecoder(tmodel, max_len=s0 + 12, weight_quant=wq,
                         device="cpu")
    kc, vc = jdec.new_caches(2)
    jl, kc, vc = jdec._prefill(jnp.asarray(ids, jnp.int32), kc, vc)
    nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    js, _, _ = jdec._step(jnp.asarray(nxt), jnp.int32(s0), kc, vc)
    tk, tv = tdec.new_caches(2)
    before = quant_matmul.launches
    _close(tdec._prefill(torch.from_numpy(ids), tk, tv).numpy(), jl)
    _close(tdec._step(torch.from_numpy(nxt), s0, tk, tv).numpy(), js)
    assert quant_matmul.launches == before        # plain path on the CPU
    ref = jdec.generate(pt.to_tensor(ids), max_new_tokens=10).numpy()
    out = tdec.generate(torch.from_numpy(ids), max_new_tokens=10).numpy()
    np.testing.assert_array_equal(out, ref)


def test_weight_quant_rejects_unknown():
    with pytest.raises(ValueError, match="weight_quant"):
        CachedDecoder(LlamaForCausalLM(LlamaConfig(**TINY), device="cpu"),
                      weight_quant="int4", device="cpu")


# -- PagedDecoder(kv_quant=..., attn_shards=...) -------------------------------

# five mixed (prompt, budget) requests through two slots (as in
# tests/test_torch_decode.py), block_size 16, max_len 64: 4 blocks a slot
_LENS_BUDGETS = [(5, 9), (17, 4), (3, 12), (11, 7), (30, 6)]


def _requests():
    rng = np.random.default_rng(7)
    return [(f"r{i}", [int(t) for t in rng.integers(0, 97, ln)], budget)
            for i, (ln, budget) in enumerate(_LENS_BUDGETS)]


def _paged(cls, model, **kw):
    return cls(model, max_len=64, block_size=16, max_slots=2, num_blocks=9,
               **kw)


_JAX_SERVES = {}


def _jax_serve(jmodel, opts):
    """JAX's ragged (interpret-mode) serve of _requests() under opts, run
    once per opts for the ragged and dense port cases."""
    key = tuple(sorted(opts.items()))
    if key not in _JAX_SERVES:
        jdec = _paged(JaxPagedDecoder, jmodel, ragged_kernel=True, **opts)
        # the JAX engine's default loop (the one-chunk lookahead), as the
        # port's
        _JAX_SERVES[key] = (jdec.serve(_requests(), chunk=4), jdec)
    return _JAX_SERVES[key]


@pytest.mark.parametrize("opts", [
    dict(kv_quant="int8"),
    dict(weight_quant="int8_blockwise", kv_quant="int8"),
    dict(attn_shards=2), dict(attn_shards=4)],
    ids=["kv_int8", "w_blockwise_kv_int8", "shards2", "shards4"])
@pytest.mark.parametrize("ragged", [True, False])
def test_paged_serve_matches_jax(models, opts, ragged):
    jmodel, tmodel = models
    reqs = _requests()
    ref, jdec = _jax_serve(jmodel, opts)
    tdec = _paged(PagedDecoder, tmodel, ragged_kernel=ragged, device="cpu",
                  **opts)
    counts = (ragged_paged_attention_quant.launches,
              ragged_paged_attention_partials.launches)
    routes = dict(PagedDecoder.route_launches)
    out = tdec.serve(reqs, chunk=4)
    assert out == ref
    # head dim 64 routes the ragged engine's calls to the kernels'
    # wrappers (their plain versions here); the dense oracle counts none
    moved = {r: PagedDecoder.route_launches[r] - routes[r] for r in routes}
    assert moved["plain"] == 0 and (moved["kernel"] > 0) == ragged
    assert {rid: len(t) for rid, t in out.items()} == \
        {rid: b for rid, _, b in reqs}
    assert tdec.allocator.in_use == 0
    assert counts == (ragged_paged_attention_quant.launches,
                      ragged_paged_attention_partials.launches)
    if "attn_shards" in opts:
        # the ragged path counts its sharded decode steps as JAX does;
        # the dense oracle takes no shards
        assert tdec.attn_shards == jdec.attn_shards
        assert tdec.sharded_attn_calls == \
            (jdec.sharded_attn_calls if ragged else 0)
        unsharded = _paged(PagedDecoder, tmodel, ragged_kernel=ragged,
                           device="cpu").serve(reqs, chunk=4)
        assert out == unsharded


def test_quantized_pools_and_bytes_match_jax(models):
    jmodel, tmodel = models
    jdec = _paged(JaxPagedDecoder, jmodel, kv_quant="int8")
    tdec = _paged(PagedDecoder, tmodel, kv_quant="int8", device="cpu")
    for name in ("kv_token_bytes", "pool_bytes", "bytes_per_block"):
        assert getattr(tdec, name)() == getattr(jdec, name)()
    dense = _paged(PagedDecoder, tmodel, device="cpu")
    assert dense.kv_token_bytes() == \
        _paged(JaxPagedDecoder, jmodel).kv_token_bytes()
    kpool, vpool = tdec.new_pools()
    (jkc, jks), _ = jdec.new_pools()
    assert isinstance(kpool, QuantizedPool)
    assert kpool.codes.shape == jkc.shape and kpool.codes.dtype == torch.int8
    assert kpool.scales.shape == jks.shape and bool((kpool.scales == 1).all())
    layer = kpool[1]
    assert layer.codes.shape == jkc.shape[1:]
    assert layer.scales.shape == jks.shape[1:]


def test_quantized_step_logits_match_jax(models):
    """One prompt prefilled into the int8 pool, then one decode step. The
    written rows agree with JAX's (codes within one step, scales within
    1e-5: the K/V rows they quantize come from products summed in other
    orders; the codec itself is bit-identical on equal inputs, see
    test_torch_ragged_paged_attention_quant.py), and so do the step's
    logits, ragged and dense."""
    jmodel, tmodel = models
    prompt = _ids(21, (13,))
    ids = np.zeros(16, np.int32)
    ids[:13] = prompt
    table = np.zeros(4, np.int32)
    table[:2] = [3, 5]
    for ragged in (True, False):
        jdec = _paged(JaxPagedDecoder, jmodel, kv_quant="int8",
                      ragged_kernel=ragged)
        tdec = _paged(PagedDecoder, tmodel, kv_quant="int8",
                      ragged_kernel=ragged, device="cpu")
        jk, jv = jdec.new_pools()
        enc, jk, jv = jdec._prefill_paged(jdec._params, jnp.asarray(ids),
                                          jnp.int32(13), jnp.asarray(table),
                                          jk, jv)
        tk, tv = tdec.new_pools()
        tenc = tdec._prefill_paged(torch.from_numpy(ids), 13,
                                   torch.from_numpy(table), tk, tv)
        assert int(tenc) == int(enc)
        live = slice(None), [3, 5]
        dcode = (tk.codes[live].int().numpy()
                 - np.asarray(jk[0])[live].astype(np.int32))
        assert np.abs(dcode).max() <= 1
        np.testing.assert_allclose(tv.scales[live].numpy(),
                                   np.asarray(jv[1])[live], rtol=1e-5)
        tok = np.asarray([int(enc), 0], np.int32)
        lens = np.asarray([13, 0], np.int32)
        tabs = np.stack([table, np.zeros(4, np.int32)])
        jl, _, _ = jdec._paged_step_impl(
            jdec._params, jnp.asarray(tok), jnp.asarray(lens),
            jnp.asarray(tabs), jk, jv)
        tl = tdec._paged_step(torch.from_numpy(tok), torch.from_numpy(lens),
                              torch.from_numpy(tabs), tk, tv)
        _close(tl[:1].numpy(), np.asarray(jl)[:1])


@pytest.mark.parametrize("budget,max_len,expect", [
    (None, 64, 1), (4, 64, 1), (3, 64, 2), (1, 64, 4), (2, 128, 4)])
def test_shard_block_budget_derives_the_jax_shard_count(models, budget,
                                                        max_len, expect):
    jmodel, tmodel = models
    kw = dict(max_len=max_len, block_size=16, shard_block_budget=budget)
    jdec = JaxPagedDecoder(jmodel, **kw)
    tdec = PagedDecoder(tmodel, device="cpu", **kw)
    assert tdec.attn_shards == jdec.attn_shards == expect


@pytest.mark.parametrize("kw,match", [
    (dict(attn_shards=5), "exceeds blocks_per_seq"),
    (dict(attn_shards=2, kv_quant="int8"), "not supported with kv_quant"),
    (dict(kv_quant="int4"), "kv_quant must be")])
def test_validation_errors_match_jax(models, kw, match):
    jmodel, tmodel = models
    with pytest.raises(ValueError, match=match):
        _paged(JaxPagedDecoder, jmodel, **kw)
    with pytest.raises(ValueError, match=match):
        _paged(PagedDecoder, tmodel, device="cpu", **kw)
