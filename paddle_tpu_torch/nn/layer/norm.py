"""RMSNorm, LayerNorm and the batch norms (counterparts of
paddle_tpu/nn/layer/norm.py's).

The batch norms are the port's own ``_BatchNormBase`` over
``functional.batch_norm``, not ``torch.nn.BatchNorm2d``: torch's module
weights its running statistics the other way round, stores the unbiased
variance and carries a ``num_batches_tracked`` buffer, while the
reference keeps ``_mean`` and ``_variance`` and nothing else, so a state
carried across the two packages keeps its names and meaning.
"""
from __future__ import annotations

import torch
from torch import nn

from ...framework.device import resolve_device
from ..functional.norm import batch_norm, layer_norm

__all__ = ["RMSNorm", "rms_norm", "LayerNorm", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "SyncBatchNorm"]


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


class _BatchNormBase(nn.Module):
    """The reference's signature, with the port's trailing ``device``
    (default ``cuda``; raises without a card unless ``device="cpu"``) and
    ``dtype`` keywords: a weight of ones and a bias of zeros (None with
    ``weight_attr=False`` / ``bias_attr=False``; any other ParamAttr
    raises NotImplementedError), and the buffers ``_mean`` (zeros) and
    ``_variance`` (ones), updated in training as the reference does."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None):
        super().__init__()
        layer = type(self).__name__
        _no_param_attr(layer, "weight_attr", weight_attr, (None, False))
        _no_param_attr(layer, "bias_attr", bias_attr, (None, False))
        dev = resolve_device(device)
        dt = dtype or torch.float32
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = nn.Parameter(torch.ones(
            num_features, device=dev, dtype=dt)) \
            if weight_attr is not False else None
        self.bias = nn.Parameter(torch.zeros(
            num_features, device=dev, dtype=dt)) \
            if bias_attr is not False else None
        self.register_buffer("_mean", torch.zeros(num_features, device=dev,
                                                  dtype=dt))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     device=dev, dtype=dt))

    def forward(self, x):
        return batch_norm(x, self._mean, self._variance, self.weight,
                          self.bias, training=self.training,
                          momentum=self._momentum, epsilon=self._epsilon,
                          data_format=self._data_format,
                          use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, name,
                         device=device, dtype=dtype)


class SyncBatchNorm(_BatchNormBase):
    """Batch norm over the whole batch. On one card that is the same
    computation as BatchNorm's; across cards it waits for the NCCL
    collectives (not ported)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every batch norm below it (itself included)
        replaced by a SyncBatchNorm holding the same weights and running
        statistics, as the reference converts them."""
        out = layer
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            out = cls(layer._num_features, layer._momentum, layer._epsilon,
                      data_format=layer._data_format,
                      device=layer._mean.device, dtype=layer._mean.dtype)
            with torch.no_grad():
                for dst, src in ((out.weight, layer.weight),
                                 (out.bias, layer.bias)):
                    if src is not None:
                        dst.copy_(src)
                out._mean.copy_(layer._mean)
                out._variance.copy_(layer._variance)
        for name, sub in list(layer.named_children()):
            out._modules[name] = cls.convert_sync_batchnorm(sub)
        return out
