"""The port's pools against the JAX package's, on the CPU.

Inputs and output gradients from numpy with a seed go through both
packages' functionals; the outputs and the input gradients are compared.
The cases cover ``ceil_mode`` where the reference's rule keeps a last
window that torch's own drops, ``exclusive`` on and off, "SAME", pairs and
pads larger than half the window (both through the explicit pad),
channels-last layouts, ``return_mask`` (the same int32 indices), and
adaptive sizes that divide the input and sizes that do not. Then each
pooling layer against its functional, and the options that raise.

Tolerance: 1e-5 of each array's largest magnitude (float32 window sums in
another order by XLA and by torch's CPU kernels; maxima are exact;
measured 2.0e-7).
"""
import zlib

import numpy as np
import pytest
import torch

import paddle_tpu as pt

import paddle_tpu_torch as ptt
from paddle_tpu_torch.nn import functional as TF
from test_torch_conv_pool import _close, _rand, _run_jax, _run_port

JF = pt.nn.functional


# name: (functional, x shape, keyword arguments)
POOL = {
    "max2d_resnet": ("max_pool2d", (2, 3, 12, 12),
                     dict(kernel_size=3, stride=2, padding=1)),
    "max2d_k2": ("max_pool2d", (2, 3, 9, 8), dict(kernel_size=2)),
    "max2d_ceil": ("max_pool2d", (2, 3, 10, 10),
                   dict(kernel_size=3, stride=2, padding=1, ceil_mode=True)),
    "max2d_ceil_window_in_pad": ("max_pool2d", (2, 3, 5, 5),
                                 dict(kernel_size=2, stride=2, padding=1,
                                      ceil_mode=True)),
    "max2d_same": ("max_pool2d", (2, 3, 9, 8),
                   dict(kernel_size=3, stride=2, padding="SAME")),
    "max2d_pad_past_half": ("max_pool2d", (2, 3, 7, 7),
                            dict(kernel_size=3, stride=1, padding=2)),
    "max2d_pairs": ("max_pool2d", (2, 3, 7, 7),
                    dict(kernel_size=3, stride=2, padding=[0, 1, 1, 0])),
    "max2d_nhwc": ("max_pool2d", (2, 9, 9, 3),
                   dict(kernel_size=3, stride=2, padding=1,
                        data_format="NHWC")),
    "max1d": ("max_pool1d", (2, 3, 11),
              dict(kernel_size=3, stride=2, padding=1, ceil_mode=True)),
    "max1d_nlc": ("max_pool1d", (2, 11, 3),
                  dict(kernel_size=3, stride=2, data_format="NLC")),
    "max3d_ceil": ("max_pool3d", (1, 2, 5, 6, 7),
                   dict(kernel_size=2, stride=2, ceil_mode=True)),
    "avg2d_resnet_exclusive": ("avg_pool2d", (2, 3, 12, 12),
                               dict(kernel_size=3, stride=2, padding=1)),
    "avg2d_inclusive": ("avg_pool2d", (2, 3, 12, 12),
                        dict(kernel_size=3, stride=2, padding=1,
                             exclusive=False)),
    "avg2d_ceil_exclusive": ("avg_pool2d", (2, 3, 10, 10),
                             dict(kernel_size=3, stride=2, padding=1,
                                  ceil_mode=True)),
    "avg2d_ceil_inclusive": ("avg_pool2d", (2, 3, 10, 10),
                             dict(kernel_size=3, stride=2, padding=1,
                                  ceil_mode=True, exclusive=False)),
    "avg2d_same": ("avg_pool2d", (2, 3, 9, 8),
                   dict(kernel_size=3, stride=2, padding="SAME")),
    "avg2d_pad_past_half": ("avg_pool2d", (2, 3, 7, 7),
                            dict(kernel_size=3, stride=1, padding=2)),
    "avg2d_nhwc": ("avg_pool2d", (2, 9, 9, 3),
                   dict(kernel_size=2, stride=2, data_format="NHWC",
                        ceil_mode=True)),
    "avg1d_ceil": ("avg_pool1d", (2, 3, 11),
                   dict(kernel_size=3, stride=2, padding=1, ceil_mode=True)),
    "avg1d_inclusive": ("avg_pool1d", (2, 3, 11),
                        dict(kernel_size=4, stride=3, padding=2,
                             exclusive=False)),
    "avg3d_ceil": ("avg_pool3d", (1, 2, 5, 6, 7),
                   dict(kernel_size=2, stride=2, ceil_mode=True,
                        exclusive=False)),
    "adaptive_avg2d_1x1": ("adaptive_avg_pool2d", (2, 3, 7, 7),
                           dict(output_size=1)),
    "adaptive_avg2d_divides": ("adaptive_avg_pool2d", (2, 3, 8, 12),
                               dict(output_size=(4, 3))),
    "adaptive_avg2d_uneven": ("adaptive_avg_pool2d", (2, 3, 7, 10),
                              dict(output_size=(3, 4))),
    "adaptive_avg2d_nhwc": ("adaptive_avg_pool2d", (2, 7, 10, 3),
                            dict(output_size=(3, 4), data_format="NHWC")),
    "adaptive_avg1d_uneven": ("adaptive_avg_pool1d", (2, 3, 11),
                              dict(output_size=4)),
    "adaptive_avg3d_uneven": ("adaptive_avg_pool3d", (1, 2, 5, 7, 6),
                              dict(output_size=(2, 3, 4))),
    "adaptive_max2d_divides": ("adaptive_max_pool2d", (2, 3, 8, 12),
                               dict(output_size=(2, 4))),
    "adaptive_max2d_uneven": ("adaptive_max_pool2d", (2, 3, 7, 10),
                              dict(output_size=(3, 4))),
    "adaptive_max1d_uneven": ("adaptive_max_pool1d", (2, 3, 11),
                              dict(output_size=4)),
    "adaptive_max3d_uneven": ("adaptive_max_pool3d", (1, 2, 5, 7, 6),
                              dict(output_size=(2, 3, 4))),
}


@pytest.mark.parametrize("case", list(POOL))
def test_pool_matches_jax(case):
    fn, xs, kw = POOL[case]
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    x = _rand(rng, xs)
    ref_out = getattr(JF, fn)(pt.to_tensor(x), **kw)
    g = _rand(rng, tuple(ref_out.shape))
    jout, (jdx,) = _run_jax(getattr(JF, fn), [x], g, **kw)
    tout, (tdx,) = _run_port(getattr(TF, fn), [x], g, **kw)
    assert tout.shape == jout.shape
    _close(tout, jout)
    _close(tdx, jdx)


def test_ceil_mode_keeps_the_window_torch_drops():
    """At size 5, k 2, s 2, padding 1 the reference's ceil rule keeps a
    fourth window that starts in the right padding; torch's ceil_mode
    gives 3."""
    x = torch.arange(25.0).reshape(1, 1, 5, 5)
    out = TF.max_pool2d(x, 2, 2, 1, ceil_mode=True)
    assert out.shape == (1, 1, 4, 4)
    assert torch.nn.functional.max_pool2d(x, 2, 2, 1,
                                          ceil_mode=True).shape[-1] == 4 - 1


@pytest.mark.parametrize("nd,xs,kw", [
    (2, (2, 3, 9, 9), dict(kernel_size=3, stride=2, padding=1)),
    (2, (2, 3, 9, 8), dict(kernel_size=2, stride=2, ceil_mode=True)),
    (2, (2, 3, 10, 10), dict(kernel_size=3, stride=2, padding=1,
                             ceil_mode=True)),
    (1, (2, 3, 11), dict(kernel_size=3, stride=2, padding=1)),
    (3, (1, 2, 5, 6, 7), dict(kernel_size=2, stride=2, ceil_mode=True)),
], ids=["2d_resnet", "2d_ceil", "2d_pad_ceil", "1d", "3d_ceil"])
def test_max_pool_mask_matches_jax(nd, xs, kw):
    fn = f"max_pool{nd}d"
    x = _rand(np.random.default_rng(nd), xs)
    jout, jmask = getattr(JF, fn)(pt.to_tensor(x), return_mask=True, **kw)
    tout, tmask = getattr(TF, fn)(torch.from_numpy(x), return_mask=True,
                                  **kw)
    _close(tout.numpy(), jout.numpy())
    assert tmask.dtype == torch.int32
    np.testing.assert_array_equal(tmask.numpy(), jmask.numpy())
    # each mask entry indexes the window's maximum in the flat input
    flat = x.reshape(xs[0], xs[1], -1)
    picked = np.take_along_axis(flat, tmask.numpy().reshape(
        xs[0], xs[1], -1).astype(np.int64), axis=2)
    np.testing.assert_array_equal(picked.reshape(tout.shape), tout.numpy())


@pytest.mark.parametrize("name,args,fn,kw", [
    ("MaxPool2D", (3, 2, 1), "max_pool2d", dict(ceil_mode=True)),
    ("AvgPool2D", (3, 2, 1), "avg_pool2d", dict(exclusive=False)),
    ("MaxPool1D", (3, 2), "max_pool1d", {}),
    ("AvgPool1D", (2,), "avg_pool1d", dict(ceil_mode=True)),
    ("MaxPool3D", (2,), "max_pool3d", {}),
    ("AvgPool3D", (2, 1), "avg_pool3d", {}),
    ("AdaptiveAvgPool2D", ((1, 1),), "adaptive_avg_pool2d", {}),
    ("AdaptiveAvgPool1D", (3,), "adaptive_avg_pool1d", {}),
    ("AdaptiveAvgPool3D", (2,), "adaptive_avg_pool3d", {}),
    ("AdaptiveMaxPool2D", (3,), "adaptive_max_pool2d", {}),
    ("AdaptiveMaxPool1D", (3,), "adaptive_max_pool1d", {}),
    ("AdaptiveMaxPool3D", (2,), "adaptive_max_pool3d", {}),
])
def test_pool_layer_is_its_functional(name, args, fn, kw):
    nd = int(fn[-2])
    x = torch.randn((2, 3) + (7,) * nd,
                    generator=torch.Generator().manual_seed(nd))
    layer = getattr(ptt.nn, name)(*args, **kw)
    assert torch.equal(layer(x), getattr(TF, fn)(x, *args, **kw))


def test_pool_options_that_raise():
    with pytest.raises(NotImplementedError, match="divisor_override"):
        TF.avg_pool2d(torch.zeros(1, 1, 4, 4), 2, divisor_override=3)
    with pytest.raises(NotImplementedError, match="return_mask"):
        ptt.nn.AdaptiveMaxPool2D(2, return_mask=True)(
            torch.zeros(1, 1, 4, 4))
    with pytest.raises(ValueError, match="channels-first"):
        TF.max_pool2d(torch.zeros(1, 4, 4, 1), 2, return_mask=True,
                      data_format="NHWC")
