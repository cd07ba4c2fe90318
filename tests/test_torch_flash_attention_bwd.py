"""The port's flash-attention backward against the JAX Pallas backward.

On the CPU ``_flash_bhsd_bwd`` runs its plain PyTorch version
(``flash_attention_bwd_plain``) and the JAX backward runs in Pallas
interpret mode: both the resident two-pass backward ``_mha_bwd`` and its
K/V-streaming twin ``_mha_bwd_stream``, called directly. Both sides get
the same numpy q, k, v, dO and the forward's o and lse (from the JAX
forward). Gradients are compared in float32 with atol 5e-5, the bound
tests/test_kernels.py holds the JAX flash gradients to: the two sides sum
S-term products in different orders (tiled against whole-row matmuls),
and dp - delta cancels, so a few float32 ulps of the O(1) terms remain.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as pt
from paddle_tpu.kernels.pallas.flash_attention import (
    _mha_bwd, _mha_bwd_stream, _mha_fwd, flash_attention_jax)
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import LlamaPretrainingCriterion as JaxCriterion

from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.kernels.flash_attention import (
    _flash_bhsd_bwd, flash_attention_bwd_plain)
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           LlamaPretrainingCriterion)
from paddle_tpu_torch.nn.functional.flash_attention import flash_attention

ATOL = 5e-5


def _arrays(seed, shape, n):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("stream", [False, True],
                         ids=["resident", "streamed"])
@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_jax(stream, s, d, causal):
    q, k, v, do = _arrays(s + d + causal, (2, s, d), 4)
    scale = float(1.0 / np.sqrt(d))
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.float32) for a in (q, k, v, do))
    jo, jlse = _mha_fwd(jq, jk, jv, causal, scale)
    bwd = _mha_bwd_stream if stream else _mha_bwd
    ref = bwd(jq, jk, jv, jo, jlse, jdo, causal, scale)
    o, lse = torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jlse))
    got = _flash_bhsd_bwd(*(torch.from_numpy(a) for a in (q, k, v)), o, lse,
                          torch.from_numpy(do), causal, scale)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == torch.float32 and tuple(g.shape) == (2, s, d)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=0, err_msg=name)


def test_the_cpu_wrapper_is_the_plain_version():
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(1, (3, 40, 16), 4))
    o = torch.from_numpy(_arrays(2, (3, 40, 16), 1)[0])
    lse = torch.from_numpy(_arrays(3, (3, 40), 1)[0])
    before = _flash_bhsd_bwd.launches
    got = _flash_bhsd_bwd(q, k, v, o, lse, do, True, 0.25)
    ref = flash_attention_bwd_plain(q, k, v, o, lse, do, True, 0.25)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert _flash_bhsd_bwd.launches == before   # no kernel on the CPU


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_matches_jax_grad(causal):
    """The port's flash_attention differentiated by torch.autograd (its
    autograd Function, whose backward is the flash backward) against
    jax.grad of flash_attention_jax, on [B, S, H, D], the pattern of
    tests/test_kernels.py."""
    q, k, v = _arrays(7 + causal, (2, 256, 2, 64), 3)
    jg = jax.grad(lambda *a: (flash_attention_jax(*a, causal=causal) ** 2)
                  .sum(), argnums=(0, 1, 2))(
        *(jnp.asarray(a, jnp.float32) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (flash_attention(tq, tk, tv, causal=causal) ** 2).sum().backward()
    for t, g in zip((tq, tk, tv), jg):
        # the loss sums 65536 squared outputs: its gradient carries the
        # outputs' own float32 error, so the bound is the JAX test's 5e-5
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   atol=ATOL, rtol=0)


def test_gqa_through_the_llama_attention():
    """8 query heads over 2 kv heads: both models repeat K/V before the
    flash call and autograd sums the repeated heads' gradients into the
    k/v projections. Gradients of a 1-layer f32 Llama with the flash path,
    the JAX one through its eager tape (the flash primitive's backward is
    _mha_bwd), compared at atol 5e-5 relative to each gradient's largest
    element."""
    kw = dict(vocab_size=64, hidden_size=128, intermediate_size=128,
              num_hidden_layers=1, num_attention_heads=8,
              num_key_value_heads=2, max_position_embeddings=128,
              use_flash_attention=True, dtype="float32")
    pt.seed(11)
    jcfg = JaxLlamaConfig(**kw)
    jmodel = JaxLlama(jcfg)
    sd = {k: np.asarray(v.numpy()) for k, v in jmodel.state_dict().items()}
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 64, (2, 128)).astype(np.int64)
    labels = rng.integers(0, 64, (2, 128)).astype(np.int64)
    jloss = JaxCriterion(jcfg)(jmodel(pt.to_tensor(ids)),
                               pt.to_tensor(labels))
    jloss.backward()
    jgrads = {k: np.asarray(p.grad.numpy())
              for k, p in jmodel.named_parameters()}

    cfg = LlamaConfig(**kw)
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(sd, cfg))
    loss = LlamaPretrainingCriterion(cfg)(model(torch.from_numpy(ids)),
                                          torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss.numpy()), rtol=1e-6)
    for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
        key = f"llama.layers.0.self_attn.{name}.weight"
        got = dict(model.named_parameters())[key].grad.numpy().T
        ref = jgrads[key]
        top = np.abs(ref).max()
        assert top > 0
        np.testing.assert_allclose(got / top, ref / top, atol=ATOL, rtol=0,
                                   err_msg=key)
