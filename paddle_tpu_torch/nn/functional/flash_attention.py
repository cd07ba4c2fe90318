"""Attention functional in paddle's [batch, seq, heads, head_dim] layout.

Counterpart of paddle_tpu/nn/functional/flash_attention.py. On a CUDA
tensor ``flash_attention`` runs the port's flash-attention forward kernel
(kernels/flash_attention.py); on a CPU tensor it runs the kernel's plain
version. Forward only: a CUDA call that autograd would need to
differentiate raises, as the backward kernel belongs to the training
slice.
"""
from __future__ import annotations

import math

from ...kernels.flash_attention import (_flash_bhsd,
                                        flash_attention_fwd_plain)

__all__ = ["flash_attention", "scaled_dot_product_attention"]


def _bshd(core, query, key, value, causal, scale):
    b, s, h, d = query.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)

    def fold(x):
        return x.transpose(1, 2).reshape(b * h, s, d)

    o, _ = core(fold(query), fold(key), fold(value), causal, scale)
    return o.reshape(b, h, s, d).transpose(1, 2)


def flash_attention(query, key, value, causal=False, scale=None):
    """query/key/value [B, S, H, D] (equal head counts: repeat grouped
    K/V heads first). Returns [B, S, H, D] in query's dtype."""
    return _bshd(_flash_bhsd, query, key, value, causal, scale)


def scaled_dot_product_attention(query, key, value, causal=False,
                                 scale=None):
    """The same function in plain PyTorch on every device (the JAX
    model's ``use_flash_attention=False`` path)."""
    return _bshd(flash_attention_fwd_plain, query, key, value, causal,
                 scale)
