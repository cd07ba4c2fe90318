"""The port's flash-attention forward against the JAX Pallas kernel.

On the CPU ``_flash_bhsd`` runs its plain PyTorch version and the JAX
forward (``_mha_fwd``, which ``_flash_bhsd`` reaches) runs in Pallas
interpret mode. Both get the same numpy arrays; o and the float32 lse are
compared in float32, where the two sides differ in summation order only
(tiled online softmax against one logsumexp over the whole row).

``test_matches_jax_forward`` pins the state another test in the same
process could leave behind (the autotuned and overridden Pallas block
sizes, JAX's and torch's float32 matmul precision), and holds each element
to a float32 error bound for its sums rather than a fixed 2e-5: an
element of o is an S-term weighted sum of v over scores that are D-term
dot products, so each side may be off by about (S + D) float32 ulps of
the largest |v| (of the largest |lse| for the lse). Once, in a 6-worker
run of the whole suite, 34 of the 8192 elements of the S 128, D 16 causal
case were off by up to 6.3e-5, against 2e-5 then; alone the case is off
by 6e-7, and no state left behind by another test was found that explains
it. The bound there is 144 ulps of max|v|, about 7e-5.

The card's tensor-core forward (the "wgmma" route) multiplies bf16
operands into float32 sums, runs the online softmax over 64-key tiles in
the exp2 domain and carries p into p.v as a bf16 hi + lo pair; a
test-local emulation of that arithmetic is held here to the JAX forward by
chip_smoke.py's bf16 rule, and so is the single bf16 rounding of p it
avoids, which misses.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddle_tpu.kernels.autotune import AutoTuneCache
from paddle_tpu.kernels.pallas import flash_attention as jax_fa
from paddle_tpu.kernels.pallas.flash_attention import _flash_bhsd as jax_o
from paddle_tpu.kernels.pallas.flash_attention import _mha_fwd as jax_fwd

from paddle_tpu_torch.kernels.flash_attention import (
    _flash_bhsd, flash_attention_fwd_plain, flash_bwd_route, flash_fwd_route)
from paddle_tpu_torch.nn.functional.flash_attention import flash_attention

EPS32 = float(np.finfo(np.float32).eps)


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.fixture
def pinned_numerics():
    """The JAX kernel's default block sizes and full float32 matmuls on
    both sides, whatever an earlier test in this process set."""
    override = jax_fa._BLOCK_OVERRIDE.pop("flash", None)
    store = AutoTuneCache.instance()._store
    tuned = {key: store.pop(key) for key in list(store)
             if key[0] == "flash_blocks"}
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with jax.default_matmul_precision("highest"):
            yield
    finally:
        torch.set_float32_matmul_precision(precision)
        store.update(tuned)
        if override is not None:
            jax_fa._BLOCK_OVERRIDE["flash"] = override


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_jax_forward(pinned_numerics, s, d, causal):
    q, k, v = _qkv(s + d + causal, (4, s, d))
    scale = 1.0 / np.sqrt(d)
    jo, jlse = jax_fwd(jnp.asarray(q, jnp.float32),
                       jnp.asarray(k, jnp.float32),
                       jnp.asarray(v, jnp.float32), causal, float(scale))
    o, lse = _flash_bhsd(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), causal, scale)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    assert tuple(lse.shape) == (4, s)
    # (S + D) float32 ulps of the sums' largest term (module docstring)
    o_tol = (s + d) * EPS32 * max(1.0, float(np.abs(v).max()))
    lse_tol = (s + d) * EPS32 * max(1.0, float(np.abs(jlse).max()))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=o_tol,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=lse_tol,
                               rtol=0)
    # the custom-vjp entry the JAX decoder calls returns the same o
    if s == 128 and d == 16:
        np.testing.assert_allclose(
            o.numpy(), np.asarray(jax_o(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal,
                                        float(scale))), atol=o_tol, rtol=0)


def test_bshd_functional_folds_heads():
    """flash_attention on [B, S, H, D] equals the [BH, S, D] core per
    head."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 40, 3, 16))
                                .astype(np.float32)) for _ in range(3))
    out, _ = flash_attention(q, k, v, causal=True)
    assert tuple(out.shape) == (2, 40, 3, 16)
    for b in range(2):
        for h in range(3):
            ref, _ = flash_attention_fwd_plain(
                q[b, :, h][None], k[b, :, h][None], v[b, :, h][None], True,
                0.25)
            np.testing.assert_allclose(out[b, :, h].numpy(), ref[0].numpy(),
                                       atol=1e-6, rtol=0)


def test_causal_mask_value_is_finite():
    """The mask is -1e30 as in the TPU kernel, not -inf: the lse of row 0
    of a causal call is its single score."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, (1, 8, 16)))
    _, lse = flash_attention_fwd_plain(q, k, v, True, 0.25)
    assert torch.isfinite(lse).all()
    torch.testing.assert_close(lse[0, 0], (q[0, 0] * 0.25) @ k[0, 0])



def test_the_cpu_wrapper_is_the_plain_version():
    """A CPU tensor takes the plain version and launches nothing: neither
    the total nor any route counts."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(6, (3, 40, 16)))
    before = _flash_bhsd.launches
    routed = dict(_flash_bhsd.route_launches)
    o, lse = _flash_bhsd(q, k, v, True, 0.25)
    ro, rlse = flash_attention_fwd_plain(q, k, v, True, 0.25)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    assert _flash_bhsd.launches == before
    assert _flash_bhsd.route_launches == routed


LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _wgmma_fwd_emulation(q, k, v, causal, scale, split=True):
    """The tensor-core forward's arithmetic on float32 tensors that hold
    bf16 values: products of bf16 operands are exact in float32 and sum in
    float32; x = (q k^T) * (scale log2e); the online softmax runs over
    64-key tiles in the exp2 domain from m = -1e30, masked columns stay
    out of the max and get p = 0; l sums the float32 p; p enters p.v as
    hi = bf16(p) plus lo = bf16(p - hi) (or, with split False, rounded
    once to bf16). Returns (o rounded to bf16, lse = (m + log2 l) ln 2)."""
    bh, s, d = q.shape
    sl2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    x = torch.matmul(q, k.transpose(-1, -2)) * sl2
    keep = torch.ones(s, s, dtype=torch.bool)
    if causal:
        keep = keep.tril()
    m = torch.full((bh, s), -1e30)
    l = torch.zeros(bh, s)
    acc = torch.zeros(bh, s, d)
    for k0 in range(0, s, 64):
        xt, kt = x[..., k0:k0 + 64], keep[:, k0:k0 + 64]
        m_new = torch.maximum(m, torch.where(kt, xt, -torch.inf).amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.where(kt, torch.exp2(xt - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        hi = _bf16(p)
        parts = (hi, _bf16(p - hi)) if split else (hi,)
        acc = acc * alpha[..., None] + sum(
            torch.matmul(a, v[:, k0:k0 + 64]) for a in parts)
        m = m_new
    return _bf16(acc / l[..., None]), (m + torch.log2(l)) * LN2


def _fwd_ratio(out, ref):
    """The largest ratio of an element's error to chip_smoke.py's bf16
    rule for o, 2^-7 |ref| + 1e-4."""
    return ((out - ref).abs() / (2.0 ** -7 * ref.abs() + 1e-4)).max().item()


@pytest.mark.parametrize("s", [256, 200])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_wgmma_arithmetic_matches_jax_kernel(pinned_numerics, s, d, causal):
    """The emulation against JAX's _mha_fwd in interpret mode, 4 heads of
    bf16-valued q, k and v, JAX's o rounded to bf16 as the plain version
    rounds it: o within chip_smoke.py's bf16 rule and lse within 1e-4.
    Rounding p once to bf16 instead misses the rule for o in every
    case."""
    q, k, v = (_bf16(torch.from_numpy(a))
               for a in _qkv(3 * s + d + causal, (4, s, d)))
    scale = float(1.0 / np.sqrt(d))
    jo, jlse = jax_fwd(*(jnp.asarray(t.numpy()) for t in (q, k, v)), causal,
                       scale)
    ref = _bf16(torch.from_numpy(np.array(jo)))
    rlse = torch.from_numpy(np.array(jlse))
    o, lse = _wgmma_fwd_emulation(q, k, v, causal, scale)
    ratio = _fwd_ratio(o, ref)
    assert ratio <= 1.0, f"o: {ratio} x the bf16 rule"
    assert (lse - rlse).abs().max().item() <= 1e-4
    once, _ = _wgmma_fwd_emulation(q, k, v, causal, scale, split=False)
    assert _fwd_ratio(once, ref) > 1.0


@pytest.mark.parametrize("dtype,d,ptrs,route", [
    (torch.bfloat16, 64, (0, 16, 32), "wgmma"),
    (torch.bfloat16, 128, (256, 512, 768), "wgmma"),
    (torch.bfloat16, 256, (0, 0, 0), "cuda_core"),
    (torch.bfloat16, 128, (0, 0, 8), "cuda_core"),
    (torch.bfloat16, 64, (2, 0, 0), "cuda_core"),
    (torch.bfloat16, 128, (0, 4, 0), "cuda_core"),
    (torch.float32, 64, (0, 0, 0), "cuda_core"),
    (torch.float32, 128, (0, 0, 0), "cuda_core"),
    (torch.float32, 256, (0, 0, 0), "cuda_core"),
])
def test_flash_fwd_route(dtype, d, ptrs, route):
    """The tensor cores take bf16 at D 64 and 128 with q, k and v 16-byte
    aligned; float32 (TF32 would round it), D 256 and a misaligned operand
    keep the CUDA-core kernel. The backward's rule picks the same kind of
    kernel for the same operands."""
    assert flash_fwd_route(dtype, d, ptrs) == route
    assert flash_bwd_route(dtype, d, ptrs) == route
