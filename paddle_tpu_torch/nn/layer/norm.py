"""RMSNorm and LayerNorm (counterparts of paddle_tpu/nn/layer/norm.py's)."""
from __future__ import annotations

import torch
from torch import nn

from ..functional.norm import layer_norm

__all__ = ["RMSNorm", "rms_norm", "LayerNorm"]


def rms_norm(x, weight, eps):
    """x * rsqrt(mean(x^2) + eps) * weight, computed in float32 and cast
    back to x's dtype (the decoders' `_rms`)."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (y * weight.float()).to(x.dtype)


def _no_param_attr(layer, name, attr, allowed=(None,)):
    if not any(attr is a for a in allowed):
        raise NotImplementedError(
            f"{layer}: {name} (ParamAttr) is not ported; pass "
            + " or ".join(f"{name}={a}" for a in allowed))


class RMSNorm(nn.Module):
    """The reference's signature, with the port's trailing ``device`` and
    ``dtype`` keywords. A ``weight_attr`` other than None raises
    NotImplementedError: ParamAttr is not ported."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, *, device=None, dtype=None):
        super().__init__()
        _no_param_attr("RMSNorm", "weight_attr", weight_attr)
        self.eps = epsilon
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


class LayerNorm(nn.Module):
    """Layer normalisation over the trailing ``normalized_shape`` axes with
    a weight of ones and a bias of zeros, as the JAX layer creates them.
    ``weight_attr=False`` or ``bias_attr=False`` drops that parameter (the
    attribute is then None); any other ParamAttr raises
    NotImplementedError. ``device`` and ``dtype`` are the port's trailing
    keywords."""

    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        super().__init__()
        _no_param_attr("LayerNorm", "weight_attr", weight_attr, (None, False))
        _no_param_attr("LayerNorm", "bias_attr", bias_attr, (None, False))
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(
            self._normalized_shape, device=device, dtype=dtype)) \
            if weight_attr is not False else None
        self.bias = nn.Parameter(torch.zeros(
            self._normalized_shape, device=device, dtype=dtype)) \
            if bias_attr is not False else None

    def forward(self, x):
        return layer_norm(x, self._normalized_shape, self.weight, self.bias,
                          self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"
