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

The card's tensor-core backward (the "wgmma" route) multiplies bf16
operands into float32 sums and carries p and ds as bf16 hi + lo pairs; a
test-local emulation of that arithmetic is held here to the JAX backward
by the card tests' bf16 rule, and so is the single bf16 rounding it
avoids, which misses.
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
    _flash_bhsd_bwd, flash_attention_bwd_plain, flash_bwd_route)
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
    routed = dict(_flash_bhsd_bwd.route_launches)
    got = _flash_bhsd_bwd(q, k, v, o, lse, do, True, 0.25)
    ref = flash_attention_bwd_plain(q, k, v, o, lse, do, True, 0.25)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert _flash_bhsd_bwd.launches == before   # no kernel on the CPU
    assert _flash_bhsd_bwd.route_launches == routed     # and no route


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
    (flash_attention(tq, tk, tv, causal=causal)[0] ** 2).sum().backward()
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


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _wgmma_bwd_emulation(q, k, v, o, lse, do, causal, scale, split=True):
    """The tensor-core backward's arithmetic on float32 tensors that hold
    bf16 values: products of bf16 operands are exact in float32 and sum in
    float32; scale multiplies the float32 scores; p is 0 where masked; p
    and ds enter their products as hi = bf16(x) plus lo = bf16(x - hi) (or,
    with split False, rounded once to bf16); dk takes the unscaled q. Each
    gradient is rounded to bf16 at the end."""
    p = torch.exp(torch.matmul(q, k.transpose(-1, -2)) * scale
                  - lse[..., None])
    if causal:
        s = q.shape[1]
        p = torch.where(torch.ones(s, s, dtype=torch.bool).tril(), p, 0.0)
    delta = (do * o).sum(-1)
    ds = p * (torch.matmul(do, v.transpose(-1, -2)) - delta[..., None]) \
        * scale

    def parts(x):
        hi = _bf16(x)
        return (hi, _bf16(x - hi)) if split else (hi,)

    dv = sum(torch.matmul(a.transpose(-1, -2), do) for a in parts(p))
    dq = sum(torch.matmul(a, k) for a in parts(ds))
    dk = sum(torch.matmul(a.transpose(-1, -2), q) for a in parts(ds))
    return [_bf16(g) for g in (dq, dk, dv)]


def _bf16_ratio(out, ref):
    """The largest ratio of an element's error to the card tests' bf16
    rule 2^-7 |ref| + 1e-3 max|ref| (BWD_TOLS and _bwd_close in
    tests/test_torch_cuda_kernels.py)."""
    lim = 2.0 ** -7 * ref.abs() + 1e-3 * ref.abs().max()
    return ((out - ref).abs() / lim).max().item()


@pytest.mark.parametrize("s", [256, 200])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_wgmma_arithmetic_matches_jax_kernel(s, d, causal):
    """The emulation against JAX's _mha_bwd in interpret mode, 4 heads of
    bf16-valued q, k, v and dO, with the JAX forward's lse and its o
    rounded to bf16 (the card forward's output) on both sides, JAX's
    gradients rounded to bf16 as the plain version rounds them: within the
    card tests' bf16 rule (0.2-0.8 of it at these seeds). Rounding p and ds
    once to bf16 instead misses that rule on at least one gradient in
    every case (1.08-1.49 of it at these seeds; more at more heads)."""
    q, k, v, do = (_bf16(torch.from_numpy(a))
                   for a in _arrays(s + d + causal, (4, s, d), 4))
    scale = float(1.0 / np.sqrt(d))
    jq, jk, jv, jdo = (jnp.asarray(t.numpy()) for t in (q, k, v, do))
    jo, jlse = _mha_fwd(jq, jk, jv, causal, scale)
    o = _bf16(torch.from_numpy(np.array(jo)))
    lse = torch.from_numpy(np.array(jlse))
    ref = [_bf16(torch.from_numpy(np.array(r))) for r in
           _mha_bwd(jq, jk, jv, jnp.asarray(o.numpy()), jlse, jdo, causal,
                    scale)]
    got = _wgmma_bwd_emulation(q, k, v, o, lse, do, causal, scale)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        ratio = _bf16_ratio(g, r)
        assert ratio <= 1.0, f"{name}: {ratio} x the bf16 rule"
    once = _wgmma_bwd_emulation(q, k, v, o, lse, do, causal, scale,
                                split=False)
    assert max(_bf16_ratio(g, r) for g, r in zip(once, ref)) > 1.0


@pytest.mark.parametrize("dtype,d,ptrs,route", [
    (torch.bfloat16, 64, (0, 16, 32, 4096), "wgmma"),
    (torch.bfloat16, 128, (256, 512, 768, 1024), "wgmma"),
    (torch.bfloat16, 256, (0, 0, 0, 0), "cuda_core"),
    (torch.bfloat16, 128, (0, 0, 0, 8), "cuda_core"),
    (torch.bfloat16, 64, (2, 0, 0, 0), "cuda_core"),
    (torch.float32, 64, (0, 0, 0, 0), "cuda_core"),
    (torch.float32, 128, (0, 0, 0, 0), "cuda_core"),
    (torch.float32, 256, (0, 0, 0, 0), "cuda_core"),
])
def test_flash_bwd_route(dtype, d, ptrs, route):
    """The tensor cores take bf16 at D 64 and 128 with every operand
    16-byte aligned; float32 (TF32 would round it), D 256 and a
    misaligned q, k, v or dO keep the CUDA-core pair."""
    assert flash_bwd_route(dtype, d, ptrs) == route
