"""Convolutions (counterpart of paddle_tpu/nn/functional/conv.py).

The JAX package convolves with ``jax.lax.conv_general_dilated`` (XLA, no
Pallas kernel), so the port calls ``torch.nn.functional.conv{1,2,3}d`` and
``conv_transpose{1,2,3}d`` (cuDNN on the card). The weight layout is the
same in both packages: [out, in / groups, *k], and [in, out / groups, *k]
for a transposed convolution.

Padding takes every form of the reference's ``_norm_padding``: an int, one
int per spatial dim, ``[lo, hi]`` pairs flattened, one pair per spatial
dim, the full ``[[0, 0], [0, 0], [lo, hi], ...]`` form (``[[0, 0], [lo,
hi], ..., [0, 0]]`` for channels-last data), and "SAME" / "VALID". The
reference reads a 2-D full form (four pairs, 2 x nd entries) as flattened
ints and fails on it, and a channels-last full form with a zero spatial
pair from the wrong end; the port reads both as written. XLA's SAME
gives ceil(in / stride) outputs and puts the odd pixel of padding on the
high side, which torch's ``padding="same"`` (stride 1 only) does not, so
SAME and every asymmetric or negative pad go through an explicit ``F.pad``
first; symmetric pads go to torch as they are. Channels-last layouts (NLC,
NHWC, NDHWC) are a permute around the channels-first op. A transposed
convolution is torch's with no padding, then cropped by the reference's
(lo, hi) and extended by ``output_padding`` (``output_size`` fixes it), as
the reference's lhs-dilated convolution gives it.
"""
from __future__ import annotations

from torch.nn import functional as F

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}
_FORMATS = {1: ("NCL", "NLC"), 2: ("NCHW", "NHWC"), 3: ("NCDHW", "NDHWC")}


def _norm_padding(padding, nd, channels_last=False):
    """A padding spec -> [(lo, hi)] * nd, or "SAME"/"VALID": an int, one
    int per spatial dim, [lo, hi] pairs flattened, nd pairs, or the full
    form of nd + 2 pairs in the data's layout (the batch and channel
    pairs zero)."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    padding = list(padding)
    if all(isinstance(p, int) for p in padding):
        if len(padding) == nd:
            return [(p, p) for p in padding]
        if len(padding) == 2 * nd:
            return [(padding[2 * i], padding[2 * i + 1]) for i in range(nd)]
    elif len(padding) == nd + 2:
        return [tuple(p) for p in
                (padding[1:-1] if channels_last else padding[2:])]
    elif len(padding) == nd:
        return [tuple(p) for p in padding]
    raise ValueError(f"padding {padding!r} is none of the forms of a "
                     f"{nd}-D window")


def _tup(v, nd):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * nd


def _channels_last(data_format, nd):
    if data_format not in _FORMATS[nd]:
        raise ValueError(f"data_format must be one of {_FORMATS[nd]}, got "
                         f"{data_format!r}")
    return data_format == _FORMATS[nd][1]


def _pad_arg(pads):
    """[(lo, hi)] per spatial dim -> F.pad's flat list, last dim first."""
    return [v for lo, hi in reversed(pads) for v in (lo, hi)]


def _conv_impl(x, weight, bias, stride, padding, dilation, groups, nd,
               data_format):
    channels_last = _channels_last(data_format, nd)
    strides, dilations = _tup(stride, nd), _tup(dilation, nd)
    if channels_last:
        x = x.movedim(-1, 1)
    pads = _norm_padding(padding, nd, channels_last)
    if pads == "VALID":
        pads = [(0, 0)] * nd
    elif pads == "SAME":
        pads = []
        for size, k, s, d in zip(x.shape[2:], weight.shape[2:], strides,
                                 dilations):
            total = max((-(-size // s) - 1) * s + d * (k - 1) + 1 - size, 0)
            pads.append((total // 2, total - total // 2))
    elif isinstance(pads, str):
        raise ValueError(f"padding must be 'SAME', 'VALID' or numbers, got "
                         f"{padding!r}")
    if all(lo == hi >= 0 for lo, hi in pads):
        out = _CONV[nd](x, weight, bias, strides, [lo for lo, _ in pads],
                        dilations, int(groups))
    else:
        out = _CONV[nd](F.pad(x, _pad_arg(pads)), weight, bias, strides, 0,
                        dilations, int(groups))
    return out.movedim(1, -1) if channels_last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv_impl(x, weight, bias, stride, padding, dilation, groups, 1,
                      data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv_impl(x, weight, bias, stride, padding, dilation, groups, 2,
                      data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv_impl(x, weight, bias, stride, padding, dilation, groups, 3,
                      data_format)


def _conv_transpose_impl(x, weight, bias, stride, padding, output_padding,
                         dilation, groups, nd, data_format, output_size):
    channels_last = _channels_last(data_format, nd)
    strides, dilations = _tup(stride, nd), _tup(dilation, nd)
    if channels_last:
        x = x.movedim(-1, 1)
    k = weight.shape[2:]
    pads = _norm_padding(padding, nd, channels_last)
    if pads == "VALID":
        pads = [(0, 0)] * nd
    elif pads == "SAME":
        pads = [((dilations[i] * (k[i] - 1)) // 2,
                 (dilations[i] * (k[i] - 1) + 1) // 2) for i in range(nd)]
    elif isinstance(pads, str):
        raise ValueError(f"padding must be 'SAME', 'VALID' or numbers, got "
                         f"{padding!r}")
    opad = _tup(output_padding, nd)
    if output_size is not None:
        opad = tuple(
            int(output_size[i]) - ((x.shape[2 + i] - 1) * strides[i]
                                   - pads[i][0] - pads[i][1]
                                   + dilations[i] * (k[i] - 1) + 1)
            for i in range(nd))
    full = _CONV_T[nd](x, weight, None, strides, 0, 0, int(groups),
                       dilations)
    # the reference's output is full[lo : len - hi + opad], zeros past the
    # end of full
    out = F.pad(full, _pad_arg([(-lo, op - hi)
                                for (lo, hi), op in zip(pads, opad)]))
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return out.movedim(1, -1) if channels_last else out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_transpose_impl(x, weight, bias, stride, padding,
                                output_padding, dilation, groups, 1,
                                data_format, output_size)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose_impl(x, weight, bias, stride, padding,
                                output_padding, dilation, groups, 2,
                                data_format, output_size)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose_impl(x, weight, bias, stride, padding,
                                output_padding, dilation, groups, 3,
                                data_format, output_size)
