"""The port's zero-sync pipelined serve loop against the JAX engine's, on
the CPU (tests/test_pipelined_decode.py's fixture: vocab 97, hidden 64, 2
layers, float32, max_len 64, block_size 8, 4 slots, 48 blocks, chunk 4,
mixed budgets 20/9/14). Weights cross with convert.params_from_jax, and
every array handed to JAX carries an explicit dtype.

- ``serve`` with pipeline None, True and False is token-identical to the
  JAX engine's default ``serve(pipeline=None)``, with and without an eos
  mid-chunk (where the lookahead chunk is trimmed to the serial length);
- the counters ``h2d_uploads``, ``chunk_dispatches``,
  ``lookahead_dispatches`` and ``pipeline_drains`` equal the JAX
  engine's on the same requests;
- ``_paged_chunk_state`` equals ``_paged_chunk_state_impl`` output for
  output, slots that run out of budget or hit eos inside the chunk
  included (float32 within 1e-5 for the pools, exact for the rest).

On the CPU the chunk runs eagerly; its CUDA graph is held to the eager
chunk by tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as pt
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.paged_decode import PagedDecoder as JaxPagedDecoder

from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models.paged_decode import PagedDecoder

CFG = dict(vocab_size=97, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=128, use_flash_attention=False,
           dtype="float32")
COUNTERS = ("h2d_uploads", "chunk_dispatches", "lookahead_dispatches",
            "pipeline_drains")
PIPELINES = [None, True, False]


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


def _dec(cls, model, **kw):
    args = dict(max_len=64, block_size=8, max_slots=4, num_blocks=48)
    args.update(kw)
    return cls(model, **args)


def _prompt(n, seed):
    rng = np.random.default_rng(seed)
    return [int(t) for t in rng.integers(0, 97, n)]


def _reqs():
    return [("a", _prompt(7, 1), 20), ("b", _prompt(5, 2), 9),
            ("c", _prompt(9, 3), 14)]


def _churn():
    # 5 requests into 4 slots: the queued heads join mid-serve
    return _reqs() + [("d", _prompt(6, 7), 11), ("e", _prompt(8, 8), 13)]


_JAX = {}


def _jax_serve(jmodel, name, reqs, **kw):
    """The JAX engine's default serve (pipeline=None) of ``reqs``, and its
    counters, run once per case."""
    if name not in _JAX:
        jdec = _dec(JaxPagedDecoder, jmodel)
        out = jdec.serve(reqs, chunk=4, **kw)
        _JAX[name] = out, {c: getattr(jdec, c) for c in COUNTERS}
    return _JAX[name]


def _eos(jmodel):
    """An eos token that fires mid-stream: the third token of "a"."""
    out, _ = _jax_serve(jmodel, "steady", _reqs())
    return out["a"][2]


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_serve_matches_jax_default(models, pipeline):
    jmodel, tmodel = models
    ref, _ = _jax_serve(jmodel, "steady", _reqs())
    dec = _dec(PagedDecoder, tmodel, device="cpu")
    assert dec.serve(_reqs(), chunk=4, pipeline=pipeline) == ref
    assert dec.allocator.in_use == 0


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_eos_mid_chunk_matches_jax(models, pipeline):
    """A slot retires at eos inside a chunk on the device, one chunk ahead
    of the host: the lookahead chunk behind it is trimmed to the serial
    loop's length, and the padded streams stay the JAX engine's."""
    jmodel, tmodel = models
    eos = _eos(jmodel)
    ref, _ = _jax_serve(jmodel, "eos", _reqs(), eos_token_id=eos)
    assert any(eos in v for v in ref.values())
    dec = _dec(PagedDecoder, tmodel, device="cpu")
    out = dec.serve(_reqs(), chunk=4, eos_token_id=eos, pipeline=pipeline)
    assert out == ref
    cut = out["a"].index(eos)
    assert all(t == 0 for t in out["a"][cut + 1:])


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_churn_matches_jax(models, pipeline):
    """Admissions into slots that retired mid-serve drain the device state
    and upload it again."""
    jmodel, tmodel = models
    ref, _ = _jax_serve(jmodel, "churn", _churn())
    dec = _dec(PagedDecoder, tmodel, device="cpu")
    assert dec.serve(_churn(), chunk=4, pipeline=pipeline) == ref


@pytest.mark.parametrize("case", ["steady", "steady_serial", "churn",
                                  "eos"])
def test_counters_match_jax(models, case):
    jmodel, tmodel = models
    reqs = _churn() if case == "churn" else _reqs()
    kw = {}
    if case == "eos":
        kw["eos_token_id"] = _eos(jmodel)
    if case == "steady_serial":
        kw["pipeline"] = False
    ref, jcounts = _jax_serve(jmodel, case, reqs, **kw)
    dec = _dec(PagedDecoder, tmodel, device="cpu")
    assert dec.serve(reqs, chunk=4, **kw) == ref
    counts = {c: getattr(dec, c) for c in COUNTERS}
    assert counts == jcounts
    if case == "steady":
        # one six-array upload at the first dispatch, none after it
        assert counts["h2d_uploads"] == 6 and counts["pipeline_drains"] == 0
        assert counts["lookahead_dispatches"] >= 1
        assert counts["chunk_dispatches"] >= 4
    if case == "steady_serial":
        assert counts["h2d_uploads"] == 6
        assert counts["lookahead_dispatches"] == 0
    if case == "churn":
        assert counts["h2d_uploads"] == 12
        assert counts["pipeline_drains"] >= 1
    # the decode steps the loop reports are the steps the device ran
    assert dec.serve_stats["chunks"] == counts["chunk_dispatches"]


def test_second_serve_starts_from_zeroed_pools(models):
    """The engine keeps its pools (the chunk graphs bind their addresses)
    and zeroes them at the start of every serve: a second serve on the
    same engine equals a fresh engine's, counters and all."""
    _, tmodel = models
    dec = _dec(PagedDecoder, tmodel, device="cpu")
    first = dec.serve(_churn(), chunk=4)
    kpool = dec.serve_pools()[0]
    assert kpool.abs().max() == 0
    fresh = _dec(PagedDecoder, tmodel, device="cpu")
    assert dec.serve(_churn(), chunk=4) == first
    assert fresh.serve(_churn(), chunk=4) == first
    assert {c: getattr(dec, c) for c in COUNTERS} == \
        {c: 2 * getattr(fresh, c) for c in COUNTERS}


def _chunk_inputs(dec, seed):
    """A batch state of 4 slots that covers every gate: slot 0 runs the
    whole chunk, slot 1's budget (2) ends inside it, slot 2 is not live,
    slot 3's budget is spent already; pools hold random values."""
    rng = np.random.default_rng(seed)
    S, MB = dec.max_slots, dec.blocks_per_seq
    tables = np.zeros((S, MB), np.int32)
    nxt = 1
    for i in range(S):
        tables[i, :3] = np.arange(nxt, nxt + 3)
        nxt += 3
    shape = (dec.n_layers, dec.num_blocks, dec.block_size, dec.nkv, dec.hd)
    pools = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    return dict(tok=np.asarray([5, 17, 40, 3], np.int32),
                lens=np.asarray([9, 4, 6, 12], np.int32), tables=tables,
                live=np.asarray([True, True, False, True]),
                budgets=np.asarray([7, 2, 5, 0], np.int32),
                poison=np.zeros(S, bool), pools=pools)


@pytest.mark.parametrize("eos", [False, True], ids=["no_eos", "eos"])
@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "ragged"])
def test_chunk_state_matches_jax(models, eos, ragged):
    jmodel, tmodel = models
    jdec = _dec(JaxPagedDecoder, jmodel, ragged_kernel=ragged)
    tdec = _dec(PagedDecoder, tmodel, ragged_kernel=ragged, device="cpu")
    x = _chunk_inputs(tdec, 11)
    n = 4

    def jax_chunk(eos_id):
        args = [jnp.asarray(x[k]) for k in ("tok", "lens", "tables", "live",
                                            "budgets", "poison")]
        out = jdec._paged_chunk_state_impl(
            jdec._params, *args, jnp.asarray(x["pools"][0]),
            jnp.asarray(x["pools"][1]), n, eos_id)
        return [np.asarray(o) for o in out]

    eos_id = -1
    if eos:
        # slot 0's second token: the chunk retires it at eos
        eos_id = int(jax_chunk(-1)[0][0, 1])
    ref = jax_chunk(eos_id)
    kpool, vpool = (torch.from_numpy(p.copy()) for p in x["pools"])
    out = tdec._paged_chunk_state(
        *(torch.from_numpy(x[k]) for k in ("tok", "lens", "tables", "live",
                                           "budgets", "poison")),
        kpool, vpool, n, eos_id)
    for name, got, want in zip(
            ("toks", "bad", "tok", "lens", "live", "budgets"), out, ref):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    np.testing.assert_allclose(kpool.numpy(), ref[6], rtol=0, atol=1e-5)
    np.testing.assert_allclose(vpool.numpy(), ref[7], rtol=0, atol=1e-5)
    live = out[4].numpy()
    # slot 1 spent its budget, slot 3 had none; slot 0 stops at eos
    assert not live[1] and not live[2] and not live[3]
    assert live[0] == (not eos)
    assert out[5].numpy().tolist() == [3, 0, 5, 0]
