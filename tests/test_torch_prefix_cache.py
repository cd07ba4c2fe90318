"""The port's radix prefix cache, refcounted blocks and cache-on serve
against the JAX package's, on the CPU (tests/test_serving.py's fixture:
vocab 97, hidden 64, 3 layers, float32, max_len 64, block_size 8, 4
slots). Weights cross with convert.params_from_jax, and every array
handed to JAX carries an explicit dtype.

- ``BlockAllocator`` and ``RadixPrefixCache``: the reference's
  TestRefcounting and TestRadixCache, each run as one sequence of
  operations on both packages' classes, which must observe the same
  blocks, refcounts, matches, ``plan_prefix`` tuples and ``stats``;
- cache-on serves (warm hit, extension prompt, multi-turn, a mixed warm
  and cold batch, pool pressure at 15 blocks, a serve after every free
  block is poisoned) are token-identical to the JAX engine's and to the
  port's cache-off serves, with equal cache ``stats``,
  ``prefill_device_calls`` and ``prefill_tokens_computed``; the warm hit
  again with ``kv_quant="int8"``, ``attn_shards=2`` and
  ``prefill_chunk=16``, the port on its kernel route (the wrappers' plain
  versions on the CPU, at head dim 64) against the JAX engine's dense
  oracle;
- ``_prefill_warm`` against ``_prefill_warm_impl`` (the encoded token
  exact, the pools within 1e-5 outside the trash block, which padding rows
  write in any order) and ``_cow_copy`` against ``_cow_copy_impl``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as pt
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.paged_decode import BlockAllocator as JaxAllocator
from paddle_tpu.models.paged_decode import PagedDecoder as JaxPagedDecoder
from paddle_tpu.serving.cache import RadixPrefixCache as JaxCache
from paddle_tpu.serving.cache import plan_prefix as jax_plan_prefix

from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models.paged_decode import (BlockAllocator,
                                                  PagedDecoder, QuantizedPool)
from paddle_tpu_torch.serving.cache import RadixPrefixCache, plan_prefix

CFG = dict(vocab_size=97, hidden_size=64, intermediate_size=128,
           num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=128, use_flash_attention=False,
           dtype="float32")
PACKAGES = {"jax": (JaxAllocator, JaxCache, jax_plan_prefix),
            "torch": (BlockAllocator, RadixPrefixCache, plan_prefix)}
# the port keeps the JAX cache's stats but the offload tier's host counts
STAT_KEYS = ("hits", "misses", "blocks_shared", "tokens_saved",
             "evicted_blocks", "cow_copies", "inserted_blocks")


# head dim 64 (2 query heads over 1 KV head): the port's decode attention
# takes the kernel route (its wrappers' plain versions on the CPU); at
# CFG's head dim 16 every route is the dense one
CFG64 = dict(CFG, hidden_size=128, num_attention_heads=2,
             num_key_value_heads=1)


def _pair(cfg_kw):
    pt.seed(5)
    jmodel = JaxLlama(JaxLlamaConfig(**cfg_kw))
    jmodel.eval()
    sd = {k: np.asarray(v.numpy()) for k, v in jmodel.state_dict().items()}
    cfg = LlamaConfig(**cfg_kw)
    tmodel = LlamaForCausalLM(cfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(sd, cfg))
    tmodel.eval()
    return jmodel, tmodel


@pytest.fixture(scope="module")
def models():
    return _pair(CFG)


@pytest.fixture(scope="module")
def models64():
    return _pair(CFG64)


def _prompt(n, seed):
    rng = np.random.default_rng(seed)
    return [int(t) for t in rng.integers(0, 97, n)]


# -- the allocator and the radix tree, one sequence on both packages ---------

def _refcount_ops(Alloc, Cache, plan):
    """TestRefcounting: births at 1, retain/free, double free, retain of a
    free block. Returns what the sequence observed."""
    seen = []
    a = Alloc(8)
    b = a.alloc(3)
    seen.append([a.refcount(x) for x in b])
    a.free(b)
    b = a.alloc(1)[0]
    a.retain(b)
    seen.append(a.refcount(b))
    a.free([b])
    seen.append((a.refcount(b), a.in_use))
    a.free([b])
    seen.append((a.in_use, a.free_count))
    with pytest.raises(ValueError, match="double free"):
        a.free([b])
    with pytest.raises(ValueError):
        a.retain(b)
    assert seen[0] == [1, 1, 1] and seen[1] == 2
    assert seen[2] == (1, 1) and seen[3] == (0, 7)
    return seen


def _cache(Alloc, Cache, num_blocks=32, bs=4, **kw):
    a = Alloc(num_blocks)
    return Cache(bs, a, **kw), a


def _full_blocks_ops(Alloc, Cache, plan):
    c, a = _cache(Alloc, Cache)
    toks = list(range(10))               # 2 full blocks + a partial tail
    blocks = a.alloc(3)
    c.insert(toks, blocks)
    m = c.match(toks)
    seen = [c.held_blocks, m.blocks, m.tokens]
    a.free(blocks)
    seen.append(a.in_use)
    assert seen[0] == 2 and m.blocks == blocks[:2] and m.tokens == 8
    assert seen[3] == 2
    return seen


def _dedupe_ops(Alloc, Cache, plan):
    c, a = _cache(Alloc, Cache)
    t1 = list(range(8))
    b1 = a.alloc(2)
    c.insert(t1, b1)
    b2 = a.alloc(2)
    c.insert(t1, b2)
    seen = [c.held_blocks]
    a.free(b1), a.free(b2)
    seen.append(a.in_use)
    assert seen == [2, 2]
    return seen


def _acquire_ops(Alloc, Cache, plan):
    c, a = _cache(Alloc, Cache)
    b = a.alloc(2)
    c.insert(list(range(8)), b)
    a.free(b)
    m = c.match(list(range(8)))
    got = c.acquire(m, 2)
    seen = [got, [a.refcount(x) for x in got]]
    a.free(got)
    seen.append([a.refcount(x) for x in m.blocks])
    assert got == m.blocks and seen[1] == [2, 2] and seen[2] == [1, 1]
    return seen


def _lru_ops(Alloc, Cache, plan):
    c, a = _cache(Alloc, Cache)
    old, new = a.alloc(1), a.alloc(1)
    c.insert([1, 2, 3, 4], old)
    c.insert([9, 8, 7, 6], new)
    a.free(old), a.free(new)
    c.acquire(c.match([9, 8, 7, 6]), 0)      # touch the new chain
    seen = [c.evict(1), c.match([1, 2, 3, 4]).tokens,
            c.match([9, 8, 7, 6]).tokens]
    assert seen == [1, 0, 4]
    return seen


def _live_blocks_ops(Alloc, Cache, plan):
    c, a = _cache(Alloc, Cache)
    b = a.alloc(2)
    c.insert(list(range(8)), b)
    a.free(b)
    live = c.acquire(c.match(list(range(8))), 2)
    seen = [c.evict(2), c.held_blocks]
    a.free(live)
    seen.append(c.evict(2))
    assert seen == [0, 2, 2]
    return seen


def _cascade_ops(Alloc, Cache, plan):
    c, a = _cache(Alloc, Cache)
    b = a.alloc(2)
    c.insert(list(range(8)), b)
    a.free(b)
    seen = [c.evict(2), c.held_blocks, a.in_use]
    assert seen == [2, 0, 0]
    return seen


def _max_blocks_ops(Alloc, Cache, plan):
    c, a = _cache(Alloc, Cache, max_blocks=2)
    b1 = a.alloc(2)
    c.insert(list(range(8)), b1)
    a.free(b1)
    b2 = a.alloc(2)
    c.insert(list(range(100, 108)), b2)
    a.free(b2)
    seen = [c.held_blocks, c.match(list(range(100, 108))).tokens,
            a.in_use]
    assert seen[0] <= 2
    return seen


def _plan_ops(Alloc, Cache, plan):
    c, a = _cache(Alloc, Cache)
    toks = list(range(8))
    b = a.alloc(2)
    c.insert(toks, b)
    a.free(b)
    m, kb, cached, cow = plan(c, toks, len(toks))
    m2, kb2, cached2, cow2 = plan(c, toks + [99, 98], 10)
    seen = [(m.blocks, kb, cached, cow), (m2.blocks, kb2, cached2, cow2),
            plan(None, toks, 8)[1:]]
    # a full hit holds one token back and forks its boundary block
    assert (kb, cached, cow) == (1, 7, m.blocks[1])
    assert (kb2, cached2, cow2) == (2, 8, None)
    return seen


def _stats_ops(Alloc, Cache, plan):
    c, a = _cache(Alloc, Cache, max_blocks=3)
    b = a.alloc(3)
    c.insert(list(range(12)), b)
    a.free(b)
    c.record_admission(0, 0)
    c.record_admission(7, 1, cow=True)
    c.record_admission(8, 2)
    b = a.alloc(2)
    c.insert(list(range(50, 58)), b)
    a.free(b)
    return [{k: c.stats[k] for k in STAT_KEYS}, c.held_blocks, a.in_use]


@pytest.mark.parametrize("ops", [
    _refcount_ops, _full_blocks_ops, _dedupe_ops, _acquire_ops, _lru_ops,
    _live_blocks_ops, _cascade_ops, _max_blocks_ops, _plan_ops,
    _stats_ops], ids=lambda f: f.__name__.strip("_"))
def test_cache_classes_match_jax(ops):
    assert ops(*PACKAGES["torch"]) == ops(*PACKAGES["jax"])


# -- cache-on serves against the JAX engine's ---------------------------------

def _dec(cls, model, cache=True, num_blocks=48, **kw):
    args = dict(max_len=64, block_size=8, max_slots=4, num_blocks=num_blocks,
                prefix_cache=cache or None)
    args.update(kw)
    return cls(model, **args)


def _counts(dec):
    st = dec.prefix_cache.stats
    return ({k: st[k] for k in STAT_KEYS}, dec.prefill_device_calls,
            dec.prefill_tokens_computed, dec.allocator.in_use,
            dec.prefix_cache.held_blocks)


# each case serves through a cache-on engine (serve) and, where ``off`` is
# given, holds each stream to the cache-off engine's (the JAX runs give no
# off engine: their streams are held to the port's)

def _check(off, reqs, want):
    if off is not None:
        assert off(reqs) == want


def _warm_hit(serve, off):
    P = _prompt(24, 1)
    out = [serve([("c", P, 8)])["c"], serve([("w", P, 8)])["w"]]
    assert out[0] == out[1]
    _check(off, [("c", P, 8)], {"c": out[0]})
    return out


def _extension(serve, off):
    P = _prompt(24, 2)
    ext = P + _prompt(10, 3)
    out = [serve([("a", P, 8)])["a"], serve([("b", ext, 8)])["b"]]
    _check(off, [("b", ext, 8)], {"b": out[1]})
    return out


def _multi_turn(serve, off):
    t0 = _prompt(16, 4)
    r0 = serve([("s0:t0", t0, 6)])["s0:t0"]
    t1 = t0 + r0 + _prompt(5, 6)
    r1 = serve([("s0:t1", t1, 6)])["s0:t1"]
    _check(off, [("x", t0, 6), ("y", t1, 6)], {"x": r0, "y": r1})
    return [r0, r1]


def _mixed(serve, off):
    P, Q = _prompt(24, 7), _prompt(17, 8)
    out = [serve([("w0", P, 8)])["w0"], serve([("p", P, 8), ("q", Q, 8)])]
    assert out[0] == out[1]["p"]
    _check(off, [("p", P, 8), ("q", Q, 8)], out[1])
    return out


def _pressure(serve, off):
    out = []
    for j in range(5):                   # 5 distinct 3-block prompts
        P = _prompt(24, 10 + j)
        out.append(serve([(f"g{j}", P, 6)])[f"g{j}"])
        _check(off, [(f"g{j}", P, 6)], {f"g{j}": out[-1]})
    return out


CASES = {"warm_hit": (_warm_hit, {}),
         "extension": (_extension, {}),
         "multi_turn": (_multi_turn, {}),
         "mixed_warm_cold": (_mixed, {}),
         "pool_pressure": (_pressure, dict(num_blocks=15, max_slots=2))}
_JAX = {}


def _jax_case(jmodel, name, fn, kw):
    if name not in _JAX:
        jdec = _dec(JaxPagedDecoder, jmodel, **kw)
        _JAX[name] = fn(jdec.serve, None), _counts(jdec)
    return _JAX[name]


@pytest.mark.parametrize("case", list(CASES))
def test_cache_serve_matches_jax(models, case):
    jmodel, tmodel = models
    fn, kw = CASES[case]
    ref, jcounts = _jax_case(jmodel, case, fn, kw)
    tdec = _dec(PagedDecoder, tmodel, device="cpu", **kw)
    off = _dec(PagedDecoder, tmodel, cache=False, device="cpu", **kw)
    out = fn(tdec.serve, off.serve)
    assert out == ref
    counts = _counts(tdec)
    assert counts == jcounts
    stats, calls, computed, in_use, held = counts
    # every block still in use is the cache's
    assert in_use == held
    if case == "warm_hit":
        assert stats["tokens_saved"] >= 0.9 * 24
        assert stats["cow_copies"] == 1
        assert stats["hits"] == 1 and stats["misses"] == 1
        assert computed == 24 + 1 and calls == 2
    if case == "pool_pressure":
        assert stats["evicted_blocks"] > 0


# engine options the card's phases also run: the port on its kernel route
# against the JAX engine's dense oracle
OPTIONS = {"kv_quant_int8": dict(kv_quant="int8"),
           "attn_shards_2": dict(attn_shards=2),
           "prefill_chunk_16": dict(prefill_chunk=16)}


@pytest.mark.parametrize("opt", list(OPTIONS))
def test_cache_options_match_jax(models64, opt):
    jmodel, tmodel = models64
    kw = OPTIONS[opt]
    P = _prompt(40, 30)
    ext = P + _prompt(11, 31)

    def run(cls, model, **dkw):
        dec = _dec(cls, model, **kw, **dkw)
        out = [dec.serve([("c", P, 8)])["c"], dec.serve([("w", P, 8)])["w"],
               dec.serve([("e", ext, 8)])["e"]]
        return out, _counts(dec)

    ref, jcounts = run(JaxPagedDecoder, jmodel)
    assert _dec(PagedDecoder, tmodel, ragged_kernel=True, device="cpu",
                **kw)._decode_route() == "kernel"
    out, counts = run(PagedDecoder, tmodel, ragged_kernel=True,
                      device="cpu")
    assert out == ref and out[0] == out[1]
    assert counts == jcounts
    if opt == "prefill_chunk_16":
        # the 40-token cold prompt in windows of 16: three calls
        assert counts[1] == 3 + 1 + 1


def test_poisoned_free_blocks_never_read(models64):
    """NaN in every free block after the cache is emptied, then the prompt
    again. On the kernel route (the ragged wrappers' plain versions, which
    read no position past a row's length) the stream is the cold one with
    no quarantine: no block a table does not own is read. On the dense
    route the window gather reads whole blocks, so masked NaN positions
    reach the logits as 0 x NaN, in both packages alike: the serve
    recovers the cold stream through quarantines and replays, as many as
    the JAX engine's."""
    jmodel, tmodel = models64
    P = _prompt(24, 20)
    runs = []
    for cls, model, kw in ((JaxPagedDecoder, jmodel, {}),
                           (PagedDecoder, tmodel, {"device": "cpu"}),
                           (PagedDecoder, tmodel, {"device": "cpu",
                                                   "ragged_kernel": True})):
        dec = _dec(cls, model, num_blocks=40, **kw)
        cold = dec.serve([("a", P, 6)])["a"]
        dec.prefix_cache.evict(dec.prefix_cache.held_blocks)
        free = [b for b in range(1, 40) if dec.allocator.refcount(b) == 0]
        assert len(free) == 39
        dec.poison_blocks(free)
        assert dec.serve([("b", P, 6)])["b"] == cold
        runs.append((cold, dec.quarantines))
    assert runs[0] == runs[1]
    assert runs[2] == (runs[0][0], 0)
    # the poison is there to be read
    kpool = dec.ensure_pools()[0]
    assert torch.isnan(kpool[:, free[-1]]).all()


# -- the warm prefill and the COW copy, call for call -------------------------

def _random_pools(dec, rng, quant):
    shape = (dec.n_layers, dec.num_blocks, dec.block_size, dec.nkv, dec.hd)
    if quant:
        return [(rng.integers(-127, 128, shape).astype(np.int8),
                 rng.uniform(0.001, 0.02, shape[:3]).astype(np.float32))
                for _ in range(2)]
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]


def _to_jax(pool):
    if isinstance(pool, tuple):
        return tuple(jnp.asarray(p) for p in pool)
    return jnp.asarray(pool)


def _to_torch(pool):
    if isinstance(pool, tuple):
        return QuantizedPool(*(torch.from_numpy(p.copy()) for p in pool))
    return torch.from_numpy(pool.copy())


def _leaves(pool):
    if isinstance(pool, QuantizedPool):
        return [pool.codes.numpy(), pool.scales.numpy()]
    if isinstance(pool, tuple):
        return [np.asarray(p) for p in pool]
    if isinstance(pool, torch.Tensor):
        return [pool.numpy()]
    return [np.asarray(pool)]


@pytest.mark.parametrize("quant", [False, True], ids=["raw", "int8"])
@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "ragged"])
@pytest.mark.parametrize("start,true_len", [(16, 7), (23, 16)])
def test_prefill_warm_matches_jax(models64, ragged, quant, start,
                                  true_len):
    """The JAX engine's dense path or its Pallas kernels in interpret mode
    against the port's dense path or its kernel route."""
    jmodel, tmodel = models64
    kw = dict(ragged_kernel=ragged, kv_quant="int8" if quant else None)
    jdec = _dec(JaxPagedDecoder, jmodel, **kw)
    tdec = _dec(PagedDecoder, tmodel, device="cpu", **kw)
    assert tdec._decode_route() == ("kernel" if ragged else None)
    rng = np.random.default_rng(start + true_len)
    pools = _random_pools(tdec, rng, quant)
    table = np.zeros(tdec.blocks_per_seq, np.int32)
    nblk = -(-(start + true_len) // tdec.block_size)
    table[:nblk] = rng.permutation(tdec.num_blocks - 1)[:nblk] + 1
    ids = np.zeros(16, np.int32)
    ids[:true_len] = rng.integers(0, 97, true_len)
    jenc, jk, jv = jdec._prefill_warm_impl(
        jdec._params, jnp.asarray(ids), jnp.int32(start),
        jnp.int32(true_len), jnp.asarray(table), _to_jax(pools[0]),
        _to_jax(pools[1]))
    kp, vp = _to_torch(pools[0]), _to_torch(pools[1])
    enc = tdec._prefill_warm(torch.from_numpy(ids), start, true_len,
                             torch.from_numpy(table), kp, vp)
    assert int(enc) == int(np.asarray(jenc))
    # block 0 is the trash block: padding rows write it in any order
    for got, want in ((kp, jk), (vp, jv)):
        g, w = (leaves[0][:, 1:] if not quant else leaves
                for leaves in (_leaves(got), _leaves(want)))
        if not quant:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
            continue
        # an int8 row: its scale within 1e-5, and each value within one
        # code step (a float32 rounding of x / scale near .5 may round the
        # code either way)
        (gc, gs), (wc, ws) = ((c[:, 1:], sc[:, 1:]) for c, sc in (g, w))
        np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-5)
        np.testing.assert_allclose(gc * gs[..., None, None],
                                   wc * ws[..., None, None], rtol=0,
                                   atol=ws.max() * 1.0001)
        assert (gc != wc).mean() < 1e-3


@pytest.mark.parametrize("quant", [False, True], ids=["raw", "int8"])
def test_cow_copy_matches_jax(models, quant):
    jmodel, tmodel = models
    kw = dict(kv_quant="int8" if quant else None)
    jdec = _dec(JaxPagedDecoder, jmodel, **kw)
    tdec = _dec(PagedDecoder, tmodel, device="cpu", **kw)
    pools = _random_pools(tdec, np.random.default_rng(3), quant)
    jk, jv = jdec._cow_copy_impl(_to_jax(pools[0]), _to_jax(pools[1]),
                                 jnp.int32(5), jnp.int32(9))
    kp, vp = _to_torch(pools[0]), _to_torch(pools[1])
    tdec._cow_copy(kp, vp, 5, 9)
    for got, want, src in ((kp, jk, pools[0]), (vp, jv, pools[1])):
        for g, w, s in zip(_leaves(got), _leaves(want), _leaves(src)):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g[:, 9], s[:, 5])
