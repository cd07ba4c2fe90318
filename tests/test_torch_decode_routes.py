"""The port's decoders at head dims and group sizes that no decode kernel
takes, against the JAX package's decoders, on the CPU.

The reference serves a Llama of any head dim: its CachedDecoder prefills
through its flash kernel whenever the prompt is a multiple of 128 tokens,
and its PagedDecoder attends by the dense gather. The port asks
`attention_route` (prefill) and `decode_route` (decode attention) first
and takes its own plain path where no kernel fits: head dim 80 (Phi-2),
96 (Phi-3-mini), or 3 query heads a KV head (Llama-3.2-3B's 24 over 8).
Both packages get the same weights (``convert.params_from_jax``); the
token streams must be identical in float32, and the routes are counted.
The same serves run on the card in tests/test_torch_cuda_kernels.py.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.decode import CachedDecoder as JaxCachedDecoder
from paddle_tpu.models.paged_decode import PagedDecoder as JaxPagedDecoder

from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.kernels.ragged_paged_attention import (
    GROUP_SIZES, HEAD_DIMS, decode_route)
from paddle_tpu_torch.models import paged_decode
from paddle_tpu_torch.models.decode import CachedDecoder
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models.paged_decode import PagedDecoder

BASE = dict(vocab_size=97, intermediate_size=192, num_hidden_layers=2,
            max_position_embeddings=192, use_flash_attention=False,
            dtype="float32")
CONFIGS = {
    # head dim 80: 2 heads of 80, one KV head
    "hd80": dict(hidden_size=160, num_attention_heads=2,
                 num_key_value_heads=1),
    # 3 query heads a KV head at head dim 64: 6 over 2
    "group3": dict(hidden_size=384, num_attention_heads=6,
                   num_key_value_heads=2),
}
# what each config's prefill (at 128 tokens) and decode attention route to
ROUTES = {"hd80": ("plain", "plain"), "group3": ("kernel", "plain")}


@pytest.fixture(scope="module", params=list(CONFIGS))
def models(request):
    kw = {**BASE, **CONFIGS[request.param]}
    pt.seed(11)
    jmodel = JaxLlama(JaxLlamaConfig(**kw))
    jmodel.eval()
    sd = {k: np.asarray(v.numpy()) for k, v in jmodel.state_dict().items()}
    cfg = LlamaConfig(**kw)
    tmodel = LlamaForCausalLM(cfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(sd, cfg))
    tmodel.eval()
    return request.param, jmodel, tmodel


def test_routes_of_the_configs():
    assert 80 not in HEAD_DIMS and 96 not in HEAD_DIMS
    assert 3 not in GROUP_SIZES
    for dt in (torch.float32, torch.bfloat16):
        assert decode_route(dt, 80, 1) == "plain"
        assert decode_route(dt, 96, 4) == "plain"
        assert decode_route(dt, 64, 3) == "plain"
        assert decode_route(dt, 128, 4) == "kernel"    # Llama-2 70B, 3 8B
        assert decode_route(dt, 128, 1) == "kernel"    # Llama-2 7B
    assert decode_route(torch.float16, 128, 1) == "plain"


@pytest.mark.parametrize("s0", [20, 128])
def test_cached_generate_token_identical(models, s0):
    """Greedy generation against the JAX CachedDecoder; at 128 tokens the
    reference prefills through its flash kernel, the port by the route."""
    name, jmodel, tmodel = models
    ids = np.random.default_rng(s0).integers(0, 97, (2, s0)).astype(
        np.int64)
    ref = JaxCachedDecoder(jmodel, max_len=s0 + 10).generate(
        pt.to_tensor(ids), max_new_tokens=8).numpy()
    before = dict(CachedDecoder.route_launches)
    out = CachedDecoder(tmodel, max_len=s0 + 10, device="cpu").generate(
        torch.from_numpy(ids), max_new_tokens=8).numpy()
    np.testing.assert_array_equal(out, ref)
    route = ROUTES[name][0] if s0 % 128 == 0 else "plain"
    moved = {r: CachedDecoder.route_launches[r] - before[r]
             for r in before}
    assert moved == {r: (2 if r == route else 0) for r in before}


def _requests():
    rng = np.random.default_rng(7)
    return [(f"r{i}", [int(t) for t in rng.integers(0, 97, ln)], budget)
            for i, (ln, budget) in enumerate([(5, 9), (17, 4), (3, 12),
                                              (11, 7), (30, 6)])]


def _paged(cls, model, **kw):
    return cls(model, max_len=64, block_size=16, max_slots=2, num_blocks=9,
               **kw)


@pytest.mark.parametrize("opts", [{}, dict(kv_quant="int8"),
                                  dict(attn_shards=2)],
                         ids=["pool", "kv_int8", "shards2"])
def test_paged_serve_token_identical(models, opts, monkeypatch):
    """The serve with the ragged kernel asked for (ragged_kernel=True):
    every decode attention call routes "plain" and takes the dense path,
    token for token the JAX engine's; no kernel wrapper is called (each
    raises here) and no sharded decode step is counted."""
    name, jmodel, tmodel = models
    reqs = _requests()
    ref = _paged(JaxPagedDecoder, jmodel, **opts).serve(reqs, chunk=4,
                                                        pipeline=False)
    tdec = _paged(PagedDecoder, tmodel, ragged_kernel=True, device="cpu",
                  **opts)

    def called(*args, **kw):
        raise AssertionError("a decode kernel's wrapper was called")
    for fn in ("ragged_paged_attention", "ragged_paged_attention_quant",
               "ragged_paged_attention_sharded"):
        monkeypatch.setattr(paged_decode, fn, called)
    before = dict(PagedDecoder.route_launches)
    out = tdec.serve(reqs, chunk=4)
    assert out == ref
    moved = {r: PagedDecoder.route_launches[r] - before[r] for r in before}
    assert moved["kernel"] == 0 and moved["plain"] > 0
    assert moved["plain"] % tdec.n_layers == 0
    assert tdec.sharded_attn_calls == 0
