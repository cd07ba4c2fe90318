"""The port's flash-attention forward against the JAX Pallas kernel.

On the CPU ``_flash_bhsd`` runs its plain PyTorch version and the JAX
forward (``_mha_fwd``, which ``_flash_bhsd`` reaches) runs in Pallas
interpret mode. Both get the same numpy arrays; o and the float32 lse are
compared with atol 2e-5 (float32, different summation order: tiled online
softmax against one logsumexp over the whole row).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.kernels.pallas.flash_attention import _flash_bhsd as jax_o
from paddle_tpu.kernels.pallas.flash_attention import _mha_fwd as jax_fwd

from paddle_tpu_torch.kernels.flash_attention import (
    _flash_bhsd, flash_attention_fwd_plain)
from paddle_tpu_torch.nn.functional.flash_attention import flash_attention

ATOL = 2e-5


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_jax_forward(s, d, causal):
    q, k, v = _qkv(s + d + causal, (4, s, d))
    scale = 1.0 / np.sqrt(d)
    jo, jlse = jax_fwd(jnp.asarray(q, jnp.float32),
                       jnp.asarray(k, jnp.float32),
                       jnp.asarray(v, jnp.float32), causal, float(scale))
    o, lse = _flash_bhsd(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), causal, scale)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    assert tuple(lse.shape) == (4, s)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=ATOL,
                               rtol=0)
    # the custom-vjp entry the JAX decoder calls returns the same o
    if s == 128 and d == 16:
        np.testing.assert_allclose(
            o.numpy(), np.asarray(jax_o(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal,
                                        float(scale))), atol=ATOL, rtol=0)


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

