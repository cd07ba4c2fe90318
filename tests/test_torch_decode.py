"""The PyTorch port's Llama, CachedDecoder and PagedDecoder against the JAX
package, on the CPU at a tiny size.

Both packages get the same weights: the JAX model is built from a seed and
its state dict crosses over through ``paddle_tpu_torch.convert``. Token
streams must be identical; logits agree to atol 1e-4 in float32 (the two
frameworks sum matmuls in different orders). ``import paddle_tpu`` turns on
jax_enable_x64, so every array handed to JAX carries an explicit dtype.
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
from paddle_tpu_torch.kernels.ragged_paged_attention import (
    ragged_paged_attention)
from paddle_tpu_torch.models.decode import CachedDecoder
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models.paged_decode import PagedDecoder

# tests/test_paged_decode.py's _tiny config, with hidden raised from 64 to
# 256 so that the head dim is 64, one the prefill and decode kernels take
# (their routes are "kernel"; tests/test_torch_decode_routes.py serves
# head dims no kernel takes), and max positions raised from 128 to 192 so
# a 128-token prompt (the flash prefill path) has room to decode
TINY = dict(vocab_size=97, hidden_size=256, intermediate_size=128,
            num_hidden_layers=3, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=192,
            use_flash_attention=False, dtype="float32")
ATOL = 1e-4


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
    return jmodel, tmodel, sd


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, 97, shape).astype(
        np.int64)


def test_converter_transposes_linear_weights(models):
    """paddle Linear keeps [in, out], torch.nn.Linear [out, in]: the
    converter owns the transpose, so x @ w_jax == torch's linear(x)."""
    _, tmodel, sd = models
    w_jax = sd["llama.layers.1.self_attn.k_proj.weight"]      # [256, 128]
    lin = tmodel.llama.layers[1].self_attn.k_proj
    assert tuple(lin.weight.shape) == (128, 256)
    np.testing.assert_array_equal(lin.weight.detach().numpy(), w_jax.T)
    x = np.random.default_rng(0).standard_normal((3, 256)).astype(
        np.float32)
    np.testing.assert_allclose(lin(torch.from_numpy(x)).detach().numpy(),
                               x @ w_jax, atol=1e-5)
    # tied-free head and the untouched embedding
    np.testing.assert_array_equal(
        tmodel.lm_head.weight.detach().numpy(), sd["lm_head.weight"].T)
    np.testing.assert_array_equal(
        tmodel.llama.embed_tokens.weight.detach().numpy(),
        sd["llama.embed_tokens.weight"])


def test_full_forward_logits(models):
    jmodel, tmodel, _ = models
    ids = _ids(1, (2, 11))
    ref = np.asarray(jmodel(pt.to_tensor(ids)).numpy(), np.float32)
    with torch.no_grad():
        out = tmodel(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("s0", [20, 128])
def test_cached_decoder_prefill_and_step_logits(models, s0):
    """Prefill logits (s0 % 128 == 0 runs the flash kernel path on both
    sides) and the next step's logits against the warm cache."""
    jmodel, tmodel, _ = models
    ids = _ids(2, (2, s0))
    jdec = JaxCachedDecoder(jmodel, max_len=s0 + 8)
    kc, vc = jdec.new_caches(2)
    jl, kc, vc = jdec._prefill(jnp.asarray(ids, jnp.int32), kc, vc)
    nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    js, _, _ = jdec._step(jnp.asarray(nxt), jnp.int32(s0), kc, vc)
    tdec = CachedDecoder(tmodel, max_len=s0 + 8, device="cpu")
    tk, tv = tdec.new_caches(2)
    tl = tdec._prefill(torch.from_numpy(ids), tk, tv)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=0)
    ts = tdec._step(torch.from_numpy(nxt), s0, tk, tv)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("s0", [20, 128])
def test_cached_generate_token_identical(models, s0):
    jmodel, tmodel, _ = models
    ids = _ids(3, (2, s0))
    ref = JaxCachedDecoder(jmodel, max_len=s0 + 12).generate(
        pt.to_tensor(ids), max_new_tokens=10).numpy()
    out = CachedDecoder(tmodel, max_len=s0 + 12, device="cpu").generate(
        torch.from_numpy(ids), max_new_tokens=10).numpy()
    np.testing.assert_array_equal(out, ref)


def test_cached_generate_matches_full_forward_oracle(models):
    """The port's own oracle: greedy generate through the full forward
    equals the cached engine, eos masking included."""
    _, tmodel, _ = models
    ids = torch.from_numpy(_ids(4, (2, 9)))
    dec = CachedDecoder(tmodel, max_len=32, device="cpu")
    free = tmodel.generate(ids, max_new_tokens=8)
    assert torch.equal(dec.generate(ids, max_new_tokens=8), free)
    eos = int(free[0, 11])
    masked = tmodel.generate(ids, max_new_tokens=8, eos_token_id=eos)
    assert torch.equal(dec.generate(ids, max_new_tokens=8,
                                    eos_token_id=eos), masked)
    row = masked[0, 9:].tolist()
    assert all(t == 0 for t in row[row.index(eos) + 1:])
    # sampling: the cached engine draws the full forward's noise, one
    # [B, V] uniform draw a token, so one seed gives one stream
    kw = dict(max_new_tokens=8, do_sample=True, temperature=0.7, top_k=20,
              top_p=0.9)
    full = tmodel.generate(ids, generator=torch.Generator().manual_seed(3),
                           **kw)
    cached = dec.generate(ids, generator=torch.Generator().manual_seed(3),
                          **kw)
    assert torch.equal(cached, full)


# five mixed (prompt, budget) requests through two slots: admission
# between chunks, heterogeneous budgets inside one chunk, and prompts
# that cross a block boundary (block_size 16)
_LENS_BUDGETS = [(5, 9), (17, 4), (3, 12), (11, 7), (30, 6)]


def _requests():
    rng = np.random.default_rng(7)
    return [(f"r{i}", [int(t) for t in rng.integers(0, 97, ln)], budget)
            for i, (ln, budget) in enumerate(_LENS_BUDGETS)]


def _paged(cls, model, **kw):
    return cls(model, max_len=64, block_size=16, max_slots=2, num_blocks=9,
               **kw)


@pytest.mark.parametrize("ragged", [True, False])
def test_paged_serve_token_identical(models, ragged):
    jmodel, tmodel, _ = models
    reqs = _requests()
    jdec = _paged(JaxPagedDecoder, jmodel, ragged_kernel=ragged)
    # both engines' default loop: the one-chunk lookahead
    ref = jdec.serve(reqs, chunk=4)
    tdec = _paged(PagedDecoder, tmodel, ragged_kernel=ragged, device="cpu")
    before = ragged_paged_attention.launches
    routes = dict(PagedDecoder.route_launches)
    out = tdec.serve(reqs, chunk=4)
    assert out == ref
    # head dim 64 routes the ragged engine's calls to the kernel's wrapper
    # (its plain version here); the dense oracle counts none
    moved = {r: PagedDecoder.route_launches[r] - routes[r] for r in routes}
    assert moved["plain"] == 0 and (moved["kernel"] > 0) == ragged
    assert {rid: len(t) for rid, t in out.items()} == \
        {rid: b for rid, _, b in reqs}
    assert tdec.allocator.peak_in_use == jdec.allocator.peak_in_use
    assert tdec.allocator.in_use == 0
    # on the CPU the wrapper runs its plain version: no kernel launch
    assert ragged_paged_attention.launches == before


def test_paged_serve_per_slot_eos(models):
    """One stream hits eos early: its tail is pad, its blocks free while
    the other slots keep decoding, token for token as in JAX."""
    jmodel, tmodel, _ = models
    reqs = _requests()
    free = _paged(PagedDecoder, tmodel, device="cpu").serve(reqs, chunk=4)
    eos = free["r2"][3]
    jdec = _paged(JaxPagedDecoder, jmodel, ragged_kernel=True)
    ref = jdec.serve(reqs, chunk=4, eos_token_id=eos)
    tdec = _paged(PagedDecoder, tmodel, ragged_kernel=True, device="cpu")
    out = tdec.serve(reqs, chunk=4, eos_token_id=eos)
    assert out == ref
    cut = out["r2"].index(eos)
    assert all(t == 0 for t in out["r2"][cut + 1:])
    assert tdec.allocator.peak_in_use == jdec.allocator.peak_in_use


def test_paged_serve_matches_full_forward_oracle(models):
    _, tmodel, _ = models
    reqs = _requests()[:3]
    out = _paged(PagedDecoder, tmodel, device="cpu").serve(reqs, chunk=4)
    for rid, prompt, budget in reqs:
        ref = tmodel.generate(torch.tensor([prompt]), max_new_tokens=budget)
        assert out[rid] == ref[0, len(prompt):].tolist(), rid


def test_exhausted_slot_stops_advancing(models):
    """The budget gate: inside an oversized chunk a slot past its budget
    writes into the trash block and its length freezes."""
    _, tmodel, _ = models
    dec = _paged(PagedDecoder, tmodel, device="cpu")
    kpool, vpool = dec.new_pools()
    tables = torch.zeros(2, dec.blocks_per_seq, dtype=torch.int32)
    for i in range(2):
        tables[i, :2] = torch.tensor(dec.allocator.alloc(2))
    dec._paged_chunk_state(torch.tensor([5, 7], dtype=torch.int32),
                           torch.tensor([10, 10], dtype=torch.int32), tables,
                           torch.ones(2, dtype=torch.bool),
                           torch.tensor([3, 8], dtype=torch.int32),
                           torch.zeros(2, dtype=torch.bool), kpool, vpool, 8)
    k0 = kpool[0]
    b00, b10, b11 = (int(tables[0, 0]), int(tables[1, 0]),
                     int(tables[1, 1]))
    assert (k0[b00, 10:13].abs().amax(dim=(1, 2)) > 0).all()
    assert k0[b00, 13:16].abs().max() == 0
    assert (k0[b10, 10:16].abs().amax(dim=(1, 2)) > 0).all()
    assert (k0[b11, 0:2].abs().amax(dim=(1, 2)) > 0).all()


def test_bucketed_prefill_pads_into_trash_block(models):
    """A 5-token prompt prefills a 16-token bucket: the 11 pad rows land
    in the trash block, never in the slot's own block past the prompt,
    and the encoded first token is the full forward's argmax."""
    _, tmodel, _ = models
    dec = _paged(PagedDecoder, tmodel, device="cpu")
    kpool, vpool = dec.new_pools()
    table = torch.zeros(dec.blocks_per_seq, dtype=torch.int32)
    table[0] = 3
    prompt = [int(t) for t in _ids(5, (5,))]
    ids = torch.zeros(16, dtype=torch.int32)
    ids[:5] = torch.tensor(prompt)
    enc = dec._prefill_paged(ids, 5, table, kpool, vpool)
    first, nonfinite = dec.decode_first_token(enc)
    assert not nonfinite
    with torch.no_grad():
        ref = int(tmodel(torch.tensor([prompt]))[0, -1].argmax())
    assert first == ref
    assert (kpool[:, 3, :5].abs().amax(dim=(2, 3)) > 0).all()
    assert kpool[:, 3, 5:].abs().max() == 0
    assert kpool[:, 0].abs().max() > 0
    assert dec.decode_first_token(torch.tensor(-8)) == (7, True)


def test_rope_tables_bit_identical():
    from paddle_tpu.models.llama import _rope_tables as jax_tables
    from paddle_tpu_torch.models.llama import _rope_tables
    for hd, n, theta in ((16, 192, 10000.0), (128, 4096, 500000.0)):
        for a, b in zip(_rope_tables(hd, n, theta), jax_tables(hd, n, theta)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_tied_head_matches_jax():
    """tie_word_embeddings: the JAX engine's head is embed.T; the port
    multiplies by the [V, H] embedding with F.linear."""
    cfg_kw = dict(TINY, tie_word_embeddings=True, num_hidden_layers=1)
    pt.seed(9)
    jmodel = JaxLlama(JaxLlamaConfig(**cfg_kw))
    sd = {k: np.asarray(v.numpy()) for k, v in jmodel.state_dict().items()}
    assert "lm_head.weight" not in sd
    cfg = LlamaConfig(**cfg_kw)
    tmodel = LlamaForCausalLM(cfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(sd, cfg))
    assert tmodel.lm_head is None
    ids = _ids(6, (2, 9))
    jdec = JaxCachedDecoder(jmodel, max_len=16)
    kc, vc = jdec.new_caches(2)
    jl, _, _ = jdec._prefill(jnp.asarray(ids, jnp.int32), kc, vc)
    tdec = CachedDecoder(tmodel, max_len=16, device="cpu")
    tl = tdec._prefill(torch.from_numpy(ids), *tdec.new_caches(2))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=0)
    with torch.no_grad():
        full = tmodel(torch.from_numpy(ids))[:, -1].numpy()
    np.testing.assert_allclose(tl.numpy(), full, atol=ATOL, rtol=0)


def test_request_forms_and_oversized_rejection(models):
    """Pairs take the default budget, quads carry an arrival time (a
    future arrival is admitted once it is due), and a request that can
    never fit is rejected with [] when reject_oversized is set."""
    _, tmodel, _ = models
    reqs = _requests()[:3]
    dec = _paged(PagedDecoder, tmodel, device="cpu")
    triples = dec.serve(reqs, chunk=4)
    pairs = dec.serve([(rid, p) for rid, p, _ in reqs], max_new_tokens=4,
                      chunk=4)
    assert pairs == {rid: t[:4] for rid, t in triples.items()}
    quads = dec.serve([(rid, p, b, 0.05 * i)
                       for i, (rid, p, b) in enumerate(reqs)], chunk=4)
    assert quads == triples
    assert dec.serve_stats["first_token_s"]["r2"] > 0
    out = dec.serve(reqs[:1] + [("huge", [1] * 60, 10)], chunk=4,
                    reject_oversized=True)
    assert out["huge"] == [] and out["r0"] == triples["r0"]
    assert dec.rejected_requests == {"rejected_oversized": 1}
    with pytest.raises(ValueError, match="exceed max_len"):
        dec.serve([("huge", [1] * 60, 10)], chunk=4)
