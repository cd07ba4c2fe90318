"""Incubating APIs (counterpart of paddle_tpu/incubate): the fused
functionals (``incubate.nn.functional``), the MoE layer
(``incubate.distributed``) and the masked softmaxes below."""
from __future__ import annotations

import torch

from . import nn
from ..kernels.fused_elementwise import (causal_softmax_fwd_plain,
                                         masked_softmax_supported,
                                         masked_softmax_upper_tri)

__all__ = ["nn", "softmax_mask_fuse", "softmax_mask_fuse_upper_triangle"]


def softmax_mask_fuse(x, mask, name=None):
    """softmax(x + mask) over the last axis, in x's dtype (one XLA fusion in
    the JAX package, plain torch here)."""
    return torch.softmax(x + mask, -1)


def softmax_mask_fuse_upper_triangle(x):
    """Causal-masked softmax of scores [..., S, S]: row r attends to the
    columns <= r. Square scores with S a multiple of 128 go through the
    causal softmax kernels (forward and backward, float32 arithmetic,
    output in x's dtype), as the JAX package routes to its Pallas kernel;
    any other shape is the same function in plain torch, differentiated
    by autograd (the JAX package's jnp form)."""
    if masked_softmax_supported(x):
        return masked_softmax_upper_tri(x)
    return causal_softmax_fwd_plain(x)
