"""The port's convolutions and pools against the JAX package's, on the CPU.

Inputs, weights, biases and output gradients from numpy with a seed go
through both packages' functionals; the outputs and the gradients of the
input, weight and bias are compared. The cases cover every padding form
of the reference's ``_norm_padding`` (an int, one per dim, [lo, hi]
pairs, the full [[0, 0], [0, 0], [lo, hi], ...] form, "SAME" at stride 2
and "VALID"), dilation, groups, channels-last layouts and no bias; for the
transposed convolutions ``output_padding`` and ``output_size`` too. Then
the layers: their initial values' bounds, the refused ``padding_mode``
and other options, and Conv2D / Conv2DTranspose against the JAX layers.
The pools are in tests/test_torch_pool.py.

Two reference faults the port does not copy: conv1d and
conv1d_transpose treat NLC as NCL (their channels-last test does not name
the 1-D form) and fail on a channels-last input, so the port's NLC is held
to the reference's NCL on the transposed input; and a 2-D full padding
form fails there (see REF_PADDING).

Tolerance: 1e-5 of each array's largest magnitude, outputs and gradients
alike (float32 sums in another order by XLA and by torch's CPU kernels;
the largest gap measured was 6.9e-7 of the largest).
"""
import math
import zlib

import numpy as np
import pytest
import torch

import paddle_tpu as pt

import paddle_tpu_torch as ptt
from paddle_tpu_torch.nn import functional as TF

JF = pt.nn.functional
TOL = 1e-5


def _close(got, ref, tol=TOL):
    """Element by element to tol of the largest finite |ref|; infinities
    (a max-pool window wholly in its padding) must match exactly."""
    ref = np.asarray(ref, np.float32)
    finite = np.abs(ref[np.isfinite(ref)])
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=tol * max(finite.max(initial=0), 1e-30))


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _run_jax(fn, arrays, g, **kw):
    ts = [None if a is None else pt.to_tensor(a, stop_gradient=False)
          for a in arrays]
    out = fn(*ts, **kw)
    (out * pt.to_tensor(g)).sum().backward()
    return out.numpy(), [None if t is None else t.grad.numpy() for t in ts]


def _run_port(fn, arrays, g, **kw):
    ts = [None if a is None else torch.from_numpy(a).requires_grad_()
          for a in arrays]
    out = fn(*ts, **kw)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), [None if t is None else t.grad.numpy()
                                  for t in ts]


# name: (functional, x shape, weight shape, bias, keyword arguments)
CONV = {
    "2d_pad1": ("conv2d", (2, 4, 9, 9), (6, 4, 3, 3), True,
                dict(padding=1)),
    "2d_stride2_per_dim": ("conv2d", (2, 4, 9, 8), (6, 4, 3, 3), True,
                           dict(stride=2, padding=[1, 2])),
    "2d_pairs": ("conv2d", (2, 4, 9, 9), (6, 4, 3, 3), True,
                 dict(stride=(2, 1), padding=[0, 2, 1, 0])),
    "2d_full_form": ("conv2d", (2, 4, 9, 9), (6, 4, 3, 3), True,
                     dict(padding=[[0, 0], [0, 0], [1, 0], [2, 1]])),
    "2d_nhwc_full_form": ("conv2d", (2, 9, 9, 4), (6, 4, 3, 3), True,
                          dict(padding=[[0, 0], [1, 0], [0, 0], [0, 0]],
                               data_format="NHWC")),
    "2d_same_stride2": ("conv2d", (2, 4, 10, 9), (6, 4, 3, 3), True,
                        dict(stride=2, padding="SAME")),
    "2d_same_stride2_k4": ("conv2d", (2, 4, 9, 9), (6, 4, 4, 4), True,
                           dict(stride=2, padding="same")),
    "2d_valid": ("conv2d", (2, 4, 9, 9), (6, 4, 3, 3), True,
                 dict(padding="VALID")),
    "2d_dilation2": ("conv2d", (2, 4, 11, 11), (6, 4, 3, 3), True,
                     dict(padding=2, dilation=2)),
    "2d_groups2_nobias": ("conv2d", (2, 4, 9, 9), (6, 2, 3, 3), False,
                          dict(padding=1, groups=2)),
    "2d_depthwise_stride2": ("conv2d", (2, 4, 9, 9), (4, 1, 3, 3), True,
                             dict(stride=2, padding=1, groups=4)),
    "2d_nhwc": ("conv2d", (2, 9, 9, 4), (6, 4, 3, 3), True,
                dict(stride=2, padding=1, data_format="NHWC")),
    "2d_nhwc_same": ("conv2d", (2, 9, 8, 4), (6, 4, 3, 3), False,
                     dict(stride=2, padding="SAME", data_format="NHWC")),
    "1d_pad1": ("conv1d", (2, 4, 11), (6, 4, 3), True, dict(padding=1)),
    "1d_pairs_stride2": ("conv1d", (2, 4, 11), (6, 4, 3), True,
                         dict(stride=2, padding=[2, 0])),
    "1d_same_dilation2": ("conv1d", (2, 4, 11), (6, 4, 3), False,
                          dict(padding="SAME", dilation=2)),
    "1d_full_form": ("conv1d", (2, 4, 11), (6, 4, 3), True,
                     dict(padding=[[0, 0], [0, 0], [2, 1]])),
    "3d_stride2": ("conv3d", (2, 3, 5, 6, 6), (4, 3, 3, 3, 3), True,
                   dict(stride=2, padding=1)),
    "3d_ndhwc_groups": ("conv3d", (2, 5, 6, 6, 4), (4, 2, 3, 3, 3), True,
                        dict(padding=[1, 0, 1], groups=2,
                             data_format="NDHWC")),
    "3d_same": ("conv3d", (1, 3, 5, 6, 7), (4, 3, 2, 3, 3), True,
                dict(stride=2, padding="SAME")),
    "3d_full_form": ("conv3d", (1, 3, 5, 6, 7), (4, 3, 3, 3, 3), True,
                     dict(padding=[[0, 0], [0, 0], [1, 0], [0, 1],
                                   [1, 1]])),
}

# transposed weights are [in, out / groups, *k]
CONV_T = {
    "2d_stride2_opad": ("conv2d_transpose", (2, 4, 5, 5), (4, 3, 3, 3),
                        True, dict(stride=2, padding=1, output_padding=1)),
    "2d_pairs": ("conv2d_transpose", (2, 4, 5, 6), (4, 3, 3, 3), True,
                 dict(stride=2, padding=[0, 2, 1, 0])),
    "2d_same": ("conv2d_transpose", (2, 4, 5, 5), (4, 3, 4, 4), True,
                dict(stride=2, padding="SAME")),
    "2d_valid_output_size": ("conv2d_transpose", (2, 4, 5, 5),
                             (4, 3, 3, 3), True,
                             dict(stride=2, padding="VALID",
                                  output_size=[12, 11])),
    "2d_groups2_dilation2": ("conv2d_transpose", (2, 4, 5, 5),
                             (4, 3, 3, 3), False,
                             dict(stride=2, padding=1, groups=2,
                                  dilation=2)),
    "2d_nhwc": ("conv2d_transpose", (2, 5, 5, 4), (4, 3, 3, 3), True,
                dict(stride=2, padding=1, data_format="NHWC")),
    "2d_full_form_opad_past_crop": ("conv2d_transpose", (2, 4, 5, 5),
                                    (4, 3, 3, 3), True,
                                    dict(stride=3, output_padding=2,
                                         padding=[[0, 0], [0, 0], [1, 1],
                                                  [0, 1]])),
    "1d": ("conv1d_transpose", (2, 4, 7), (4, 3, 3), True,
           dict(stride=2, padding=1, output_padding=1)),
    "3d": ("conv3d_transpose", (1, 3, 3, 4, 4), (3, 2, 3, 3, 3), True,
           dict(stride=2, padding=1)),
}


# the reference fails on a 2-D full form (it reads its four pairs as
# flattened ints) and reads a channels-last one from the wrong end: these
# cases hand it the same pads as flattened pairs
REF_PADDING = {"2d_full_form": [1, 0, 2, 1],
               "2d_nhwc_full_form": [1, 0, 0, 0],
               "T_2d_full_form_opad_past_crop": [1, 1, 0, 1]}


@pytest.mark.parametrize("case", list(CONV) + [f"T_{c}" for c in CONV_T])
def test_conv_matches_jax(case):
    table, key = (CONV_T, case[2:]) if case.startswith("T_") \
        else (CONV, case)
    fn, xs, ws, bias, kw = table[key]
    jkw = dict(kw, padding=REF_PADDING.get(case, kw.get("padding", 0)))
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    x, w = _rand(rng, xs), _rand(rng, ws)
    b = _rand(rng, (ws[1] * kw.get("groups", 1) if fn.endswith("transpose")
                    else ws[0],)) if bias else None
    ref_out = getattr(JF, fn)(pt.to_tensor(x), pt.to_tensor(w),
                              None if b is None else pt.to_tensor(b), **jkw)
    g = _rand(rng, tuple(ref_out.shape))
    jout, jgrads = _run_jax(getattr(JF, fn), [x, w, b], g, **jkw)
    tout, tgrads = _run_port(getattr(TF, fn), [x, w, b], g, **kw)
    assert tout.shape == jout.shape
    _close(tout, jout)
    for got, ref in zip(tgrads, jgrads):
        if ref is not None:
            _close(got, ref)


@pytest.mark.parametrize("fn", ["conv1d", "conv1d_transpose"])
def test_conv1d_nlc_is_ncl_transposed(fn):
    rng = np.random.default_rng(3)
    x = _rand(rng, (2, 9, 4))                       # N, L, C
    w = _rand(rng, (6, 4, 3) if fn == "conv1d" else (4, 6, 3))
    b = _rand(rng, (6,))
    kw = dict(stride=2, padding=1)
    ref = getattr(JF, fn)(pt.to_tensor(x.transpose(0, 2, 1)),
                          pt.to_tensor(w), pt.to_tensor(b), **kw).numpy()
    got = getattr(TF, fn)(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b), data_format="NLC", **kw)
    _close(got.numpy(), ref.transpose(0, 2, 1))


LAYERS = [
    ("Conv1D", (4, 6, 3), dict(groups=2), 4 // 2 * 3),
    ("Conv2D", (4, 6, 3), dict(stride=2, padding=1), 4 * 9),
    ("Conv3D", (3, 4, (2, 3, 3)), {}, 3 * 18),
    ("Conv1DTranspose", (4, 6, 3), {}, 4 * 3),
    ("Conv2DTranspose", (4, 6, 3), dict(groups=2), 2 * 9),
    ("Conv3DTranspose", (2, 4, 2), {}, 2 * 8),
]


@pytest.mark.parametrize("name,args,kw,fan_in", LAYERS,
                         ids=[lay[0] for lay in LAYERS])
def test_conv_layer_initial_bounds(name, args, kw, fan_in):
    """KaimingUniform weight, U(+-1/sqrt(fan_in)) bias, drawn from the
    generator (two layers from one seed are equal, another seed differs);
    bias_attr=False drops the bias."""
    cls = getattr(ptt.nn, name)
    layer = cls(*args, device="cpu", generator=ptt.seed(1, "cpu"), **kw)
    a, b = math.sqrt(6.0 / fan_in), 1.0 / math.sqrt(fan_in)
    w = layer.weight.detach()
    assert w.abs().max() <= a and w.abs().max() > 0.8 * a
    assert layer.bias.detach().abs().max() <= b
    assert w.dtype == torch.float32 and layer.bias.shape == (args[1],)
    again = cls(*args, device="cpu", generator=ptt.seed(1, "cpu"), **kw)
    assert torch.equal(again.weight, layer.weight)
    other = cls(*args, device="cpu", generator=ptt.seed(2, "cpu"), **kw)
    assert not torch.equal(other.weight, layer.weight)
    assert cls(*args, device="cpu", bias_attr=False, **kw).bias is None


def test_conv_layer_options_that_raise():
    with pytest.raises(NotImplementedError, match="padding_mode"):
        ptt.nn.Conv2D(3, 4, 3, padding_mode="reflect", device="cpu")
    with pytest.raises(NotImplementedError, match="weight_attr"):
        ptt.nn.Conv2D(3, 4, 3, weight_attr=object(), device="cpu")
    with pytest.raises(ValueError, match="data_format"):
        TF.conv2d(torch.zeros(1, 3, 4, 4), torch.zeros(2, 3, 1, 1),
                  data_format="NCWH")


def test_conv_layers_match_jax_layers():
    """Conv2D and Conv2DTranspose layers with the same weights: the port
    layer's forward is the JAX layer's."""
    rng = np.random.default_rng(9)
    x = _rand(rng, (2, 4, 8, 8))
    for name, kw in (("Conv2D", dict(stride=2, padding="SAME", groups=2)),
                     ("Conv2DTranspose", dict(stride=2, padding=1,
                                              output_padding=1))):
        jl = getattr(pt.nn, name)(4, 6, 3, **kw)
        tl = getattr(ptt.nn, name)(4, 6, 3, device="cpu", **kw)
        jl.set_state_dict({k: pt.to_tensor(v.detach().numpy())
                           for k, v in tl.state_dict().items()})
        _close(tl(torch.from_numpy(x)).detach().numpy(),
               jl(pt.to_tensor(x)).numpy())
