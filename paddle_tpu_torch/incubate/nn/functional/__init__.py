"""Fused functionals (counterpart of paddle_tpu/incubate/nn/functional).

Ported: ``fused_rms_norm`` and ``fused_rotary_position_embedding``, which
reach the RMSNorm and RoPE kernels (kernels/rms_norm.py,
kernels/fused_elementwise.py) on exactly the inputs the JAX package sends
to its Pallas kernels, and the jnp compositions beside them as plain
torch: ``fused_layer_norm``, ``swiglu``, ``fused_matmul_bias``,
``fused_linear``, ``fused_dropout_add`` and
``fused_bias_dropout_residual_layer_norm``. Every other form is plain torch
on either device, as the JAX package computes it in jnp. Dropout in
training raises NotImplementedError (it needs an explicit generator); the
attention and transformer functionals of the JAX module are not ported.
"""
from __future__ import annotations

import numpy as np
import torch

from ....kernels.fused_elementwise import Rope, rope_supported
from ....kernels.rms_norm import rms_norm as _rms_norm_kernel
from ....models.llama import _rope_tables
from ....nn.layer.norm import rms_norm as _rms_norm_plain

__all__ = ["fused_rotary_position_embedding", "fused_rms_norm",
           "fused_layer_norm", "fused_dropout_add", "swiglu",
           "fused_bias_dropout_residual_layer_norm", "fused_matmul_bias",
           "fused_linear"]


def _last_axis(x, begin_norm_axis, name):
    """The JAX package normalises the last axis whatever begin_norm_axis
    says; the port accepts only a value naming that axis."""
    if begin_norm_axis not in (-1, x.dim() - 1):
        raise NotImplementedError(
            f"{name}: begin_norm_axis={begin_norm_axis} is not ported; the "
            f"norm runs over the last axis (-1 or {x.dim() - 1})")


# -- rotary embedding ----------------------------------------------------------

def _rotate(x, every_two):
    """The rotated companion of x: adjacent pairs (-x1, x0, -x3, x2, ...)
    for every-two style, (-back, front) for rotate-half style."""
    if every_two:
        even, odd = x[..., 0::2], x[..., 1::2]
        return torch.stack([-odd, even], -1).reshape(x.shape)
    x1, x2 = x.chunk(2, -1)
    return torch.cat([-x2, x1], -1)


def _rope_composed(x, cos, sin, every_two, position_ids=None):
    """The JAX package's jnp forms (`_rope_apply_every_two`,
    `_rope_apply_half`, `_rope_apply_gathered`): tables cast to x's dtype,
    x c + rotate(x) s in that dtype."""
    if position_ids is None:
        c = cos[None, :, None, :].to(x.dtype)
        s = sin[None, :, None, :].to(x.dtype)
    else:
        c = cos[position_ids][:, :, None, :].to(x.dtype)
        s = sin[position_ids][:, :, None, :].to(x.dtype)
    return x * c + _rotate(x, every_two) * s


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True):
    """Rotary embedding of q (and k, v when given), each [B, S, H, D];
    sin/cos [1, S, 1, D] or [S, D] (default tables of base 10000 when
    either is None); position_ids [B, S] gathers table rows. As in the JAX
    package (and the reference), use_neox_rotary_style=True pairs ADJACENT
    dims (tables [f0, f0, f1, f1, ...]) and False pairs the front and back
    halves (tables [f0..fn, f0..fn]). Returns a 3-tuple with None where an
    input was None.

    Rotate-half without position_ids on 4-D inputs with D a multiple of 128
    goes through the RoPE kernel (float32 arithmetic, the tables get no
    gradient), the JAX package's kernel route; every other form is the jnp
    composition in plain torch (in x's dtype, as the JAX package computes
    it). Without position_ids a table must have S rows, or one row that
    broadcasts; with position_ids it must cover the largest id."""
    every_two = bool(use_neox_rotary_style)
    device = q.device
    if sin is None or cos is None:
        head_dim, seq_len = q.shape[-1], q.shape[1]
        if position_ids is not None:
            seq_len = max(seq_len, int(torch.as_tensor(position_ids).max())
                          + 1)
        cos_np, sin_np = _rope_tables(head_dim, seq_len, 10000.0)
        if every_two:
            cos_np = np.repeat(cos_np[:, :head_dim // 2], 2, axis=-1)
            sin_np = np.repeat(sin_np[:, :head_dim // 2], 2, axis=-1)
        cos = torch.from_numpy(cos_np).to(device)
        sin = torch.from_numpy(sin_np).to(device)
    if sin.dim() == 4:
        sin = sin.reshape(sin.shape[1], sin.shape[3])
        cos = cos.reshape(cos.shape[1], cos.shape[3])
    if position_ids is not None:
        position_ids = torch.as_tensor(position_ids, device=device).long()
        max_id = int(position_ids.max())
        if max_id >= cos.shape[0]:
            raise ValueError(f"position_ids max {max_id} exceeds the sin/cos "
                             f"table rows {cos.shape[0]}")
    elif cos.shape[0] not in (q.shape[1], 1):
        raise ValueError(
            f"fused_rotary_position_embedding: sin/cos have {cos.shape[0]} "
            f"rows for a sequence of {q.shape[1]}; pass tables of S rows "
            f"(or one row), or position_ids to gather rows")
    use_kernel = not every_two and position_ids is None and rope_supported(q)
    outs = []
    for t in (q, k, v):
        if t is None:
            outs.append(None)
        elif use_kernel:
            outs.append(Rope.apply(t, cos, sin))
        else:
            outs.append(_rope_composed(t, cos, sin, every_two, position_ids))
    return tuple(outs)


# -- norms -----------------------------------------------------------------------

def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, residual=None):
    """RMSNorm over the last axis: x (+ residual, added first in x's dtype)
    -> x rsqrt(mean(x^2) + eps) w in float32, cast to x's dtype, then +
    norm_bias (torch's dtype promotion). Returns (out, x + residual) when
    residual is given, else out. A last dim that is a multiple of 128 goes
    through the RMSNorm kernels (forward and backward), as the JAX package
    routes to its Pallas kernel; any other is plain torch."""
    _last_axis(x, begin_norm_axis, "fused_rms_norm")
    if residual is not None:
        x = x + residual
        res_out = x
    if x.shape[-1] % 128 == 0:
        out = _rms_norm_kernel(x, norm_weight, float(epsilon))
    else:
        out = _rms_norm_plain(x, norm_weight, float(epsilon))
    if norm_bias is not None:
        out = out + norm_bias
    if residual is not None:
        return out, res_out
    return out


def _layer_norm(x, weight, bias, epsilon):
    """The JAX package's layer_norm over the last axis, in x's dtype: (x -
    mean) rsqrt(var + eps) w + b, with w and b optional."""
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).pow(2).mean(-1, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    if weight is None and bias is None:
        return out
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def fused_layer_norm(x, norm_weight, norm_bias, epsilon=1e-5,
                     begin_norm_axis=-1, residual=None):
    """LayerNorm over the last axis of x (+ residual, added first). Returns
    (out, x + residual) when residual is given, else out."""
    _last_axis(x, begin_norm_axis, "fused_layer_norm")
    if residual is not None:
        x = x + residual
        res_out = x
    out = _layer_norm(x, norm_weight, norm_bias, float(epsilon))
    if residual is not None:
        return out, res_out
    return out


# -- dropout -------------------------------------------------------------------

def _dropout(x, p, training, mode, name):
    """The JAX package's F.dropout where it draws no random numbers:
    identity, or x (1 - p) for downscale_in_infer at inference. Dropout in
    training needs an explicit torch.Generator, not ported yet."""
    if training and p != 0:
        raise NotImplementedError(
            f"{name}: dropout with p={p} in training is not ported to the "
            f"PyTorch package yet; pass training=False or p=0")
    if mode == "downscale_in_infer" and not training:
        return x * (1.0 - p)
    return x


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train"):
    """dropout(x) + y; only where dropout draws nothing (training=False or
    p=0)."""
    return _dropout(x, p, training, mode, "fused_dropout_add") + y


def fused_bias_dropout_residual_layer_norm(x, residual, bias=None,
                                           ln_scale=None, ln_bias=None,
                                           dropout_rate=0.5, ln_epsilon=1e-5,
                                           training=True):
    """layer_norm(dropout(x + bias) + residual); only where dropout draws
    nothing (training=False or dropout_rate=0)."""
    if bias is not None:
        x = x + bias
    h = _dropout(x, dropout_rate, training, "upscale_in_train",
                 "fused_bias_dropout_residual_layer_norm") + residual
    return _layer_norm(h, ln_scale, ln_bias, float(ln_epsilon))


# -- activation and matmul -------------------------------------------------------

def swiglu(x, y=None):
    """silu(x) * y, the silu in float32 cast back to x's dtype; x splits in
    half along its last axis when y is None."""
    if y is None:
        x, y = x.chunk(2, -1)
    return torch.nn.functional.silu(x.float()).to(x.dtype) * y


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    """matmul(x, y) (each optionally transposed in its last two dims) +
    bias."""
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    return out + bias if bias is not None else out


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    """x @ weight + bias with paddle's [in, out] weight (or [out, in] with
    transpose_weight)."""
    return fused_matmul_bias(x, weight, bias, transpose_y=transpose_weight)
