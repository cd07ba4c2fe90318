"""Attention functional in paddle's [batch, seq, heads, head_dim] layout.

Counterpart of paddle_tpu/nn/functional/flash_attention.py. On a CUDA
tensor ``flash_attention`` runs the port's flash-attention kernels
(kernels/flash_attention.py): the forward, and under autograd the
two-pass backward, from the forward's saved o and lse. On a CPU tensor
both run their plain versions.
"""
from __future__ import annotations

import math

import torch

from ...kernels.flash_attention import (_flash_bhsd, _flash_bhsd_bwd,
                                        flash_attention_fwd_plain)

__all__ = ["flash_attention", "scaled_dot_product_attention"]


class _FlashAttention(torch.autograd.Function):
    """Attention on [BH, S, D] with the flash backward. The forward saves
    q, k, v, o and the float32 lse, as the JAX op's custom VJP does
    (save_outputs=True), so the backward never recomputes the forward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = _flash_bhsd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bhsd_bwd(q, k, v, o, lse, do, ctx.causal,
                                     ctx.scale)
        return dq, dk, dv, None, None


def _plain_core(q, k, v, causal, scale):
    return flash_attention_fwd_plain(q, k, v, causal, scale)[0]


def _bshd(core, query, key, value, causal, scale):
    b, s, h, d = query.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)

    def fold(x):
        return x.transpose(1, 2).reshape(b * h, s, d)

    o = core(fold(query), fold(key), fold(value), bool(causal), float(scale))
    return o.reshape(b, h, s, d).transpose(1, 2)


def flash_attention(query, key, value, causal=False, scale=None):
    """query/key/value [B, S, H, D] (equal head counts: repeat grouped
    K/V heads first; autograd then sums the repeated heads' gradients).
    Returns [B, S, H, D] in query's dtype, differentiable through the
    flash backward."""
    return _bshd(_FlashAttention.apply, query, key, value, causal, scale)


def scaled_dot_product_attention(query, key, value, causal=False,
                                 scale=None):
    """The same function in plain PyTorch on every device (the JAX
    model's ``use_flash_attention=False`` path); autograd differentiates
    it op by op."""
    return _bshd(_plain_core, query, key, value, causal, scale)
