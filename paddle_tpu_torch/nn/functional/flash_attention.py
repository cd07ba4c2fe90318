"""Attention functional in paddle's [batch, seq, heads, head_dim] layout.

Counterpart of paddle_tpu/nn/functional/flash_attention.py. On a CUDA
tensor ``flash_attention`` runs the port's flash-attention kernels
(kernels/flash_attention.py): the forward, and under autograd the
two-pass backward, from the forward's saved o and lse.
``flash_attn_unpadded`` does the same for packed documents through the
varlen kernels (kernels/flash_varlen.py). On a CPU tensor every one runs
its plain versions.

`attention_route` decides, from dtype and head dim before any launch,
whether a call takes the kernels ("kernel": float32 or bf16 at a head dim
in HEAD_DIMS) or the plain version differentiated op by op by autograd
("plain": any other head dim, float16), as the reference runs its XLA
attention wherever no Pallas kernel fits. Each functional counts its
calls by route in ``route_launches``.

On DTensor q/k/v (auto-parallel) ``flash_attention`` runs the route
``attention_route`` picks on each rank's own shards, through
``local_map``: the batch may be sharded (dim 0) and the heads (dim 2);
a sharded sequence or head dim raises ValueError (a rank would see part
of a softmax row), as does a Partial input. The output, and through
autograd the gradients of q, k and v, carry the inputs' placements. On
CUDA shards the kernels launch and are counted; nothing falls to the
plain version there.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import local_map

from ...kernels.flash_attention import (HEAD_DIMS, _flash_bhsd,
                                        _flash_bhsd_bwd,
                                        flash_attention_fwd_plain)
from ...kernels.flash_varlen import (flash_varlen_bwd, flash_varlen_fwd,
                                     flash_varlen_fwd_plain,
                                     segments_from_cu)

__all__ = ["flash_attention", "scaled_dot_product_attention",
           "flash_attn_unpadded", "attention_route", "ATTENTION_ROUTES"]

ATTENTION_ROUTES = ("kernel", "plain")
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def attention_route(dtype, head_dim):
    """The route of one attention call, from its dtype and head dim alone:
    "kernel" (the flash, varlen or FlashMask kernels and their backward;
    their plain versions on a CPU tensor) for float32 or bf16 at a head dim
    in HEAD_DIMS, else "plain" (the plain version under autograd, on every
    device), the counterpart of the reference's XLA fallback."""
    if dtype in _KERNEL_DTYPES and head_dim in HEAD_DIMS:
        return "kernel"
    return "plain"


def _count_route(fn, dtype, head_dim):
    route = attention_route(dtype, head_dim)
    fn.route_launches[route] += 1
    return route


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


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None, *, scale=None):
    """query/key/value [B, S, H, D] (equal head counts: repeat grouped
    K/V heads first; autograd then sums the repeated heads' gradients).
    Returns (out [B, S, H, D] in query's dtype, None), as the JAX package
    does; out is differentiable through the flash backward.

    As in the JAX package, return_softmax, fixed_seed_offset and rng_name
    are accepted and unused. dropout > 0 with training=True raises
    NotImplementedError (the JAX package applies it to the output after
    the kernel). ``scale`` (default 1/sqrt(D)) is the port's own trailing
    keyword. A head dim outside HEAD_DIMS or float16 takes the plain
    version under autograd (`attention_route`)."""
    _no_dropout(dropout, training, "flash_attention")
    route = _count_route(flash_attention, query.dtype, query.shape[-1])
    core = _FlashAttention.apply if route == "kernel" else _plain_core
    if isinstance(query, DTensor):
        return _local_heads(core, query, key, value, causal, scale), None
    out = _bshd(core, query, key, value, causal, scale)
    return out, None


def _local_heads(core, query, key, value, causal, scale):
    """Attention of DTensor q/k/v [B, S, H, D] on each rank's batch rows
    and heads; the output is placed as q."""
    plc = tuple(query.placements)
    for t in (key, value):
        if not isinstance(t, DTensor) or tuple(t.placements) != plc or \
                t.device_mesh != query.device_mesh:
            raise ValueError(
                "flash_attention on DTensors: key and value must be "
                "DTensors placed as query on its mesh")
    for p in plc:
        if p.is_partial() or (p.is_shard() and p.dim % 4 not in (0, 2)):
            raise ValueError(
                f"flash_attention on DTensors splits the batch (dim 0) and "
                f"the heads (dim 2) only; query is placed {plc}: "
                f"redistribute the sequence and head dims whole first")
    if scale is None:
        scale = 1.0 / math.sqrt(query.shape[-1])
    fn = local_map(
        lambda q, k, v: _bshd(core, q, k, v, causal, scale),
        out_placements=list(plc), in_placements=(list(plc),) * 3,
        redistribute_inputs=False, device_mesh=query.device_mesh)
    return fn(query, key, value)


flash_attention.route_launches = dict.fromkeys(ATTENTION_ROUTES, 0)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, *, scale=None):
    """The same function in plain PyTorch on every device (the JAX
    model's ``use_flash_attention=False`` path); autograd differentiates
    it op by op. Returns out [B, S, H, D]. attn_mask other than None and
    dropout_p > 0 with training=True raise NotImplementedError."""
    if attn_mask is not None:
        raise NotImplementedError(
            "scaled_dot_product_attention: attn_mask is not ported (the "
            "port's dense attention takes no mask yet); pass attn_mask=None")
    _no_dropout(dropout_p, training, "scaled_dot_product_attention")
    return _bshd(_plain_core, query, key, value, is_causal, scale)


class _FlashVarlen(torch.autograd.Function):
    """Packed attention on [total, H, D] with the varlen backward. The
    forward saves q, k, v, o and the float32 lse, as the JAX op's custom
    VJP does, so the backward never recomputes the forward."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, pos_q, seg_k, pos_k, causal, scale):
        o, lse = flash_varlen_fwd(q, k, v, seg_q, pos_q, seg_k, pos_k,
                                  causal, scale)
        ctx.save_for_backward(q, k, v, o, lse, seg_q, pos_q, seg_k, pos_k)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, seg_q, pos_q, seg_k, pos_k = ctx.saved_tensors
        dq, dk, dv = flash_varlen_bwd(q, k, v, o, lse, do, seg_q, pos_q,
                                      seg_k, pos_k, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None, None, None


def _no_dropout(dropout, training, name):
    if dropout > 0.0 and training:
        raise NotImplementedError(
            f"{name}: dropout > 0 in training is not ported (the port's "
            f"attention kernels have no dropout); pass dropout=0.0 or "
            f"training=False")


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale, dropout=0.0,
                        causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """Packed (varlen) attention: query [total_q, H, D], key/value
    [total_k, H, D], documents bounded by cu_seqlens_q / cu_seqlens_k
    ([B+1] cumulative lengths, on any device). A token attends only to
    keys of its own document (and, when causal, at or before its position
    inside the document), so unequal q and k packs work; a token whose
    document has no keys gets zeros. Returns [total_q, H, D] in query's
    dtype, differentiable through the varlen backward.

    As in the JAX package, max_seqlen_*, return_softmax, fixed_seed_offset
    and rng_name are accepted and unused. dropout > 0 with training=True
    raises NotImplementedError (the JAX package applies it to the output
    after the kernel). A head dim outside HEAD_DIMS or float16 takes the
    plain version under autograd (`attention_route`)."""
    _no_dropout(dropout, training, "flash_attn_unpadded")
    route = _count_route(flash_attn_unpadded, query.dtype, query.shape[-1])
    if scale is None:
        scale = 1.0 / math.sqrt(query.shape[-1])
    tq, tk = query.shape[0], key.shape[0]
    dev = query.device
    seg_q, pos_q = segments_from_cu(torch.as_tensor(cu_seqlens_q,
                                                    device=dev), tq)
    if cu_seqlens_k is cu_seqlens_q and tk == tq:
        seg_k, pos_k = seg_q, pos_q
    else:
        seg_k, pos_k = segments_from_cu(torch.as_tensor(cu_seqlens_k,
                                                        device=dev), tk)
    if route == "plain":
        return flash_varlen_fwd_plain(query, key, value, seg_q, pos_q, seg_k,
                                      pos_k, bool(causal), float(scale))[0]
    return _FlashVarlen.apply(query, key, value, seg_q, pos_q, seg_k, pos_k,
                              bool(causal), float(scale))


flash_attn_unpadded.route_launches = dict.fromkeys(ATTENTION_ROUTES, 0)
