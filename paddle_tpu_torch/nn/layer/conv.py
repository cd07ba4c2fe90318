"""Convolution layers (counterpart of paddle_tpu/nn/layer/conv.py).

The reference's signatures, with the port's trailing ``device`` (default
``cuda``; raises without a card unless ``device="cpu"``), ``dtype``
(default float32) and ``generator`` keywords; the initial values are drawn
from ``generator`` (a torch.Generator on that device, seed 0 when None) as
the reference initialises them: the weight KaimingUniform, U(-a, a) with
a = sqrt(6 / fan_in), and the bias U(-1 / sqrt(fan_in), 1 / sqrt(fan_in)),
fan_in = in_channels / groups * prod(kernel_size). The weight is
[out, in / groups, *k] ([in, out / groups, *k] transposed), as in the
reference. ``bias_attr=False`` drops the bias; any other ParamAttr raises
NotImplementedError. The reference accepts ``padding_mode`` and ignores
it (a "reflect" convolution pads with zeros there); the port takes only
"zeros" and raises for any other mode.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...framework.device import resolve_device, seed
from .. import functional as F

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


class _ConvNd(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, nd, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 transpose=False, output_padding=0, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        layer = type(self).__name__
        if padding_mode != "zeros":
            raise NotImplementedError(
                f"{layer}(padding_mode={padding_mode!r}) is not ported: the "
                f"reference ignores it and pads with zeros; pass 'zeros'")
        if weight_attr is not None:
            raise NotImplementedError(f"{layer}: weight_attr (ParamAttr) is "
                                      f"not ported; pass weight_attr=None")
        if bias_attr not in (None, False):
            raise NotImplementedError(f"{layer}: bias_attr (ParamAttr) is "
                                      f"not ported; pass None or False")
        if isinstance(kernel_size, int):
            kernel_size = [kernel_size] * nd
        dev = resolve_device(device)
        gen = seed(0, dev) if generator is None else generator
        dt = dtype or torch.float32
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = list(kernel_size)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        self._output_padding = output_padding
        self._transpose = transpose
        if transpose:
            wshape = [in_channels, out_channels // groups] + self._kernel_size
        else:
            wshape = [out_channels, in_channels // groups] + self._kernel_size
        fan_in = in_channels // groups * math.prod(self._kernel_size)
        a = math.sqrt(6.0 / fan_in)
        self.weight = nn.Parameter(torch.empty(wshape, device=dev, dtype=dt)
                                   .uniform_(-a, a, generator=gen))
        if bias_attr is not False:
            b = 1.0 / math.sqrt(fan_in)
            self.bias = nn.Parameter(torch.empty(out_channels, device=dev,
                                                 dtype=dt)
                                     .uniform_(-b, b, generator=gen))
        else:
            self.bias = None

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}, "
                f"padding={self._padding}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, dtype=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, device=device, dtype=dtype,
                         generator=generator)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, device=device, dtype=dtype,
                         generator=generator)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None, dtype=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, device=device, dtype=dtype,
                         generator=generator)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class _ConvNdTranspose(_ConvNd):
    _nd = None

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format=None, *,
                 device=None, dtype=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, self._nd,
                         stride, padding, dilation, groups, "zeros",
                         weight_attr, bias_attr, data_format, transpose=True,
                         output_padding=output_padding, device=device,
                         dtype=dtype, generator=generator)

    def forward(self, x, output_size=None):
        fn = (F.conv1d_transpose, F.conv2d_transpose,
              F.conv3d_transpose)[self._nd - 1]
        return fn(x, self.weight, self.bias, self._stride, self._padding,
                  self._output_padding, self._groups, self._dilation,
                  output_size, self._data_format)


class Conv1DTranspose(_ConvNdTranspose):
    _nd = 1

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, dtype=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, groups, dilation,
                         weight_attr, bias_attr, data_format, device=device,
                         dtype=dtype, generator=generator)


class Conv2DTranspose(_ConvNdTranspose):
    _nd = 2

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, groups, dilation,
                         weight_attr, bias_attr, data_format, device=device,
                         dtype=dtype, generator=generator)


class Conv3DTranspose(_ConvNdTranspose):
    _nd = 3

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None, dtype=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, groups, dilation,
                         weight_attr, bias_attr, data_format, device=device,
                         dtype=dtype, generator=generator)
