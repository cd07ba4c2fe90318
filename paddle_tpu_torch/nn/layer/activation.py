"""Activation layers (counterpart of paddle_tpu/nn/layer/activation.py).

``ReLU`` and ``GELU`` call the port's functionals. The reference's other
activation layers have no functional in the port yet: each is named here
and raises NotImplementedError when built.
"""
from __future__ import annotations

from torch import nn

from .. import functional as F

__all__ = ["ReLU", "GELU", "ReLU6", "ELU", "SELU", "CELU", "Sigmoid",
           "LogSigmoid", "Tanh", "Hardtanh", "Hardsigmoid", "Hardswish",
           "Hardshrink", "LeakyReLU", "PReLU", "RReLU", "Silu", "Swish",
           "Mish", "Softplus", "Softshrink", "Softsign", "Tanhshrink",
           "ThresholdedReLU", "Softmax", "LogSoftmax", "Maxout", "GLU"]


class ReLU(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


class GELU(nn.Module):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, self.approximate)


def _unported(name):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"nn.{name} is not ported to the PyTorch "
                                  f"package yet")
    return type(name, (nn.Module,), {"__init__": __init__})


(ReLU6, ELU, SELU, CELU, Sigmoid, LogSigmoid, Tanh, Hardtanh, Hardsigmoid,
 Hardswish, Hardshrink, LeakyReLU, PReLU, RReLU, Silu, Swish, Mish,
 Softplus, Softshrink, Softsign, Tanhshrink, ThresholdedReLU, Softmax,
 LogSoftmax, Maxout, GLU) = [_unported(n) for n in __all__[2:]]
