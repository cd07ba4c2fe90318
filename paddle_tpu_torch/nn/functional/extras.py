"""Packed-qkv and FlashMask attention functionals.

Counterpart of part of paddle_tpu/nn/functional/extras.py: only
``flash_attention_with_sparse_mask`` (the FlashMask kernels,
kernels/flash_sparse_mask.py), ``flash_attn_varlen_qkvpacked`` (the
varlen kernels through ``flash_attn_unpadded``) and ``flash_attn_qkvpacked``
(the dense flash kernels through ``flash_attention``). The rest of that
module is not ported yet.
"""
from __future__ import annotations

import math

import torch

from ...kernels.flash_sparse_mask import (flash_sparse_mask_bwd,
                                          flash_sparse_mask_fwd,
                                          flash_sparse_mask_fwd_plain)
from .flash_attention import (ATTENTION_ROUTES, _count_route, _no_dropout,
                              flash_attention, flash_attn_unpadded)

__all__ = ["flash_attention_with_sparse_mask", "flash_attn_qkvpacked",
           "flash_attn_varlen_qkvpacked"]


class _FlashSparseMask(torch.autograd.Function):
    """FlashMask attention on [B, S, H, D] with its backward. The forward
    saves q, k, v, o and the float32 lse, as the JAX op's custom VJP
    does."""

    @staticmethod
    def forward(ctx, q, k, v, start, causal, scale):
        o, lse = flash_sparse_mask_fwd(q, k, v, start, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse, start)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, start = ctx.saved_tensors
        dq, dk, dv = flash_sparse_mask_bwd(q, k, v, o, lse, do, start,
                                           ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def _start_rows(start, b, s, h, device):
    """The start rows the JAX entry accepts ([B, H, S], [B, 1, S] broadcast
    over heads, or [S]; a tensor of 3 or more dims is read as [-1, *, S])
    as int32 [B*H, S] on ``device``."""
    start = torch.as_tensor(start, device=device)
    if start.dim() >= 3:
        start = start.reshape((-1,) + tuple(start.shape[-2:]))
    else:
        start = start.reshape(1, 1, s)
    return start.to(torch.int32).expand(b, h, s).reshape(b * h, s) \
        .contiguous()


def flash_attention_with_sparse_mask(query, key, value,
                                     attn_mask_start_row_indices,
                                     attn_mask_start_row=0, dropout_p=0.0,
                                     is_causal=True, training=True,
                                     name=None):
    """FlashMask attention: query/key/value [B, S, H, D]; per-column start
    rows ([B, H, S], [B, 1, S] or [S]): rows >= start_row_indices[col] are
    masked (S masks nothing), and with is_causal also the columns past the
    row. A row that sees no column gets zeros, as the JAX package's kernel
    gives it. Returns [B, S, H, D] in query's dtype, differentiable through
    the FlashMask backward. attn_mask_start_row is accepted and unused, as
    in the JAX package; dropout_p > 0 with training=True raises
    NotImplementedError. A head dim outside HEAD_DIMS or float16 takes the
    plain version under autograd (`attention_route`)."""
    _no_dropout(dropout_p, training, "flash_attention_with_sparse_mask")
    b, s, h, d = query.shape
    route = _count_route(flash_attention_with_sparse_mask, query.dtype, d)
    start = _start_rows(attn_mask_start_row_indices, b, s, h, query.device)
    if route == "plain":
        return flash_sparse_mask_fwd_plain(query, key, value, start,
                                           bool(is_causal),
                                           1.0 / math.sqrt(d))[0]
    return _FlashSparseMask.apply(query, key, value, start, bool(is_causal),
                                  1.0 / math.sqrt(d))


flash_attention_with_sparse_mask.route_launches = dict.fromkeys(
    ATTENTION_ROUTES, 0)


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False,
                         return_softmax=False, fixed_seed_offset=None,
                         rng_name="", training=True, name=None):
    """qkv [B, S, 3, H, D] packed together, through the dense flash
    kernels. Returns (out [B, S, H, D], None), as the JAX package's
    flash_attention does; dropout > 0 with training=True raises
    NotImplementedError."""
    _no_dropout(dropout, training, "flash_attn_qkvpacked")
    return flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                           causal=causal)


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k,
                                max_seqlen_q, max_seqlen_k, scale=None,
                                dropout=0.0, causal=False,
                                return_softmax=False, training=True,
                                name=None):
    """Packed varlen attention on qkv [total, 3, H, D]: the three slices go
    to flash_attn_unpadded as they are (its kernels read them in place).
    Returns [total, H, D]."""
    if scale is None:
        scale = 1.0 / math.sqrt(qkv.shape[-1])
    return flash_attn_unpadded(
        qkv[:, 0], qkv[:, 1], qkv[:, 2], cu_seqlens_q, cu_seqlens_k,
        max_seqlen_q, max_seqlen_k, scale, dropout=dropout, causal=causal,
        return_softmax=return_softmax, training=training)
