"""RMSNorm (counterpart of paddle_tpu/nn/layer/norm.py's RMSNorm)."""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["RMSNorm", "rms_norm"]


def rms_norm(x, weight, eps):
    """x * rsqrt(mean(x^2) + eps) * weight, computed in float32 and cast
    back to x's dtype (the decoders' `_rms`)."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (y * weight.float()).to(x.dtype)


class RMSNorm(nn.Module):
    """The reference's signature, with the port's trailing ``device`` and
    ``dtype`` keywords. A ``weight_attr`` other than None raises
    NotImplementedError: ParamAttr is not ported."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, *, device=None, dtype=None):
        super().__init__()
        if weight_attr is not None:
            raise NotImplementedError(
                "RMSNorm: weight_attr (ParamAttr) is not ported; pass "
                "weight_attr=None")
        self.eps = epsilon
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)
