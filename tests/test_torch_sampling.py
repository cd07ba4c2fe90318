"""The port's sampler and CachedDecoder's fused chunks against the JAX
package, on the CPU (the Llama of tests/test_torch_pipelined_decode.py:
vocab 97, hidden 64, 2 layers, float32).

- ``sample_next_traced`` with the Gumbel noise JAX's categorical draws
  gives the JAX sampler's tokens over a grid of temperature, top_k and
  top_p: ``jax.random.categorical(key, l)`` is ``argmax(l +
  jax.random.gumbel(key, l.shape, float32))``, so both sides are handed
  the same noise;
- the top-p keep masks are equal but where the cumulative sum lies
  within 1e-6 of top_p (the two softmaxes round differently there);
- ``CachedDecoder.generate``'s fused chunks equal its per-token loop
  (CHUNK = 1): greedy across chunks and tails (37 new tokens = 32 + 4 +
  1) and against the JAX engine, sampled under one generator seed;
- ``do_sample=True`` works through ``generation.generate`` and
  ``LlamaForCausalLM.generate`` with an explicit generator.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.decode import CachedDecoder as JaxCachedDecoder
from paddle_tpu.models.generation import _sample_next_traced

from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.models import generation
from paddle_tpu_torch.models.decode import CachedDecoder
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from torch_threads import one_thread  # noqa: F401  (autouse)

CFG = dict(vocab_size=97, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=128, use_flash_attention=False,
           dtype="float32")
B, V = 8, 512
TOP_P_BAND = 1e-6


@pytest.fixture(scope="module")
def models():
    pt.seed(5)
    jmodel = JaxLlama(JaxLlamaConfig(**CFG))
    jmodel.eval()
    sd = {k: np.asarray(v.numpy()) for k, v in jmodel.state_dict().items()}
    cfg = LlamaConfig(**CFG)
    tmodel = LlamaForCausalLM(cfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(sd, cfg))
    tmodel.eval()
    return jmodel, tmodel


def _logits(seed):
    # spread enough that top-k and top-p cut inside the distribution
    rng = np.random.default_rng(seed)
    return (3.0 * rng.standard_normal((B, V))).astype(np.float32)


def _jax_keep(logits, top_p):
    """The JAX sampler's top-p mask and the cumulative mass ahead of each
    token, written out as `_sample_next_traced` computes them."""
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    order = jnp.argsort(-probs, axis=-1).astype(jnp.int32)
    sorted_p = jnp.take_along_axis(probs, order, axis=-1)
    ahead = jnp.cumsum(sorted_p, axis=-1) - sorted_p
    rows = jnp.arange(logits.shape[0], dtype=jnp.int32)[:, None]
    keep = jnp.zeros(ahead.shape, bool).at[rows, order].set(ahead < top_p)
    mass = jnp.zeros(ahead.shape, jnp.float32).at[rows, order].set(ahead)
    return np.asarray(keep), np.asarray(mass)


@pytest.mark.parametrize("top_p", [1.0, 0.9, 0.5])
@pytest.mark.parametrize("top_k", [0, 5, 50])
@pytest.mark.parametrize("temperature", [1.0, 0.7, 1.3])
def test_sampler_matches_jax(temperature, top_k, top_p):
    seed = int(temperature * 10) + 7 * top_k + int(100 * top_p)
    logits = _logits(seed)
    key = jax.random.PRNGKey(seed)
    use_top_p = top_p < 1.0
    want = np.asarray(_sample_next_traced(
        jnp.asarray(logits), temperature, top_k, use_top_p, top_p, key))
    gumbel = np.asarray(jax.random.gumbel(key, (B, V), jnp.float32))
    got = generation.sample_next_traced(
        torch.from_numpy(logits), temperature, top_k, use_top_p, top_p,
        torch.from_numpy(gumbel)).numpy()
    agree = got == want
    if use_top_p:
        # the filtered logits top-p sees, as both samplers make them
        scaled = logits / np.float32(temperature)
        if top_k:
            kth = np.sort(scaled, axis=-1)[:, -top_k][:, None]
            scaled = np.where(scaled < kth, np.float32(-1e30), scaled)
        keep = generation.top_p_keep(torch.from_numpy(scaled),
                                     top_p).numpy()
        jkeep, mass = _jax_keep(scaled, top_p)
        # equal but where the mass ahead lies within 1e-6 of top_p: there
        # the two frameworks' float32 softmaxes may round either way
        band = np.abs(mass - top_p) < TOP_P_BAND
        assert np.array_equal(keep[~band], jkeep[~band])
        # a row may draw another token only if its mask differs
        agree |= (keep != jkeep).any(axis=-1)
    assert agree.all(), (got, want)


def test_gumbel_transform_matches_jax():
    """The port turns uniforms into Gumbel noise as jax.random.gumbel
    does (its uniform starts at the smallest normal float32)."""
    key = jax.random.PRNGKey(3)
    tiny = float(jnp.finfo(jnp.float32).tiny)
    u = np.asarray(jax.random.uniform(key, (B, V), jnp.float32,
                                      minval=tiny, maxval=1.0))
    want = np.asarray(jax.random.gumbel(key, (B, V), jnp.float32))
    got = generation.gumbel_from_uniform(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.isfinite(generation.gumbel_from_uniform(
        torch.zeros(3)).numpy()).all()


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, 97, shape).astype(
        np.int64)


@pytest.mark.parametrize("new", [37, 2, 1])
def test_fused_greedy_equals_per_token_and_jax(models, new):
    """37 new tokens are the prefill's 1, a chunk of 32 and a tail of 4; 2
    are the prefill's and one single step; 1 is the prefill's alone."""
    jmodel, tmodel = models
    ids = _ids(1, (2, 9))
    dec = CachedDecoder(tmodel, max_len=64, device="cpu")
    sizes = []
    run = dec._gen_chunk

    def spy(g, n, *a):
        sizes.append(n)
        return run(g, n, *a)

    dec._gen_chunk = spy
    fused = dec.generate(torch.from_numpy(ids), max_new_tokens=new)
    assert sizes == {37: [32, 4], 2: [], 1: []}[new]
    per_token = CachedDecoder(tmodel, max_len=64, device="cpu")
    per_token.CHUNK = 1
    assert torch.equal(per_token.generate(torch.from_numpy(ids),
                                          max_new_tokens=new), fused)
    jdec = JaxCachedDecoder(jmodel, max_len=64)
    ref = np.asarray(jdec.generate(ids, max_new_tokens=new).numpy())
    np.testing.assert_array_equal(fused.numpy(), ref)


def test_fused_chunk_lengths(models):
    """The reference loop's chunk lengths: after the prefill's token, 36
    remain: one chunk of 32, then 4 (a power of two), then none; 35 new
    tokens leave 34: 32, then 2."""
    _, tmodel = models
    ids = torch.from_numpy(_ids(2, (1, 5)))
    for new, want in ((37, [32, 4]), (35, [32, 2]), (12, [8, 2, 1])):
        dec = CachedDecoder(tmodel, max_len=64, device="cpu")
        sizes, inside = [], []
        run, step = dec._gen_chunk, dec._step

        def spy(g, n, *a, sizes=sizes, inside=inside, run=run):
            sizes.append(n)
            inside.append(True)
            try:
                return run(g, n, *a)
            finally:
                inside.pop()

        def step_spy(*a, sizes=sizes, inside=inside, step=step):
            if not inside:           # a single step outside any chunk
                sizes.append(1)
            return step(*a)

        dec._gen_chunk, dec._step = spy, step_spy
        dec.generate(ids, max_new_tokens=new)
        assert sizes == want, (new, sizes)


@pytest.mark.parametrize("eos", [False, True], ids=["no_eos", "eos"])
def test_fused_sampled_equals_per_token(models, eos):
    _, tmodel = models
    ids = torch.from_numpy(_ids(3, (3, 7)))
    kw = dict(max_new_tokens=40, do_sample=True, temperature=0.8, top_k=50,
              top_p=0.9)

    def run(chunk, seed, **extra):
        dec = CachedDecoder(tmodel, max_len=64, device="cpu")
        dec.CHUNK = chunk
        return dec.generate(ids, generator=torch.Generator().manual_seed(
            seed), **kw, **extra)

    fused = run(32, 4)
    if eos:
        tok = int(fused[0, 7 + 5])
        fused = run(32, 4, eos_token_id=tok)
        assert torch.equal(run(1, 4, eos_token_id=tok), fused)
        row = fused[0, 7:].tolist()
        assert all(t == 0 for t in row[row.index(tok) + 1:])
        return
    assert torch.equal(run(1, 4), fused)
    assert torch.equal(run(32, 4), fused)
    assert not torch.equal(run(32, 5), fused)


def test_do_sample_entry_points(models):
    """generation.generate and LlamaForCausalLM.generate sample with an
    explicit generator: one seed gives one stream, the cached engine's,
    and another seed another."""
    _, tmodel = models
    ids = torch.from_numpy(_ids(4, (2, 6)))
    kw = dict(max_new_tokens=10, do_sample=True, temperature=1.3, top_k=0,
              top_p=0.8)
    gen = torch.Generator().manual_seed(9)
    a = generation.generate(tmodel, ids, generator=gen, **kw)
    b = tmodel.generate(ids, generator=torch.Generator().manual_seed(9),
                        **kw)
    assert torch.equal(a, b)
    assert torch.equal(a[:, :6], ids)
    assert ((a >= 0) & (a < 97)).all()
    c = tmodel.generate(ids, generator=torch.Generator().manual_seed(10),
                        **kw)
    assert not torch.equal(a, c)
    dec = CachedDecoder(tmodel, max_len=32, device="cpu")
    assert torch.equal(dec.generate(
        ids, generator=torch.Generator().manual_seed(9), **kw), a)
    # greedy draws nothing: the generator's state is left as it was
    state = gen.get_state()
    tmodel.generate(ids, max_new_tokens=3, generator=gen)
    assert torch.equal(gen.get_state(), state)
