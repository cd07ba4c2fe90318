"""Pooling (counterpart of paddle_tpu/nn/functional/pooling.py).

The JAX package pools with ``lax.reduce_window`` (XLA, no Pallas kernel),
so the port calls torch's pools. The window rules are the reference's
(``_pool_impl``): max pools pad with -inf; "SAME" pads ((k - 1) // 2,
k // 2) whatever the stride; ``ceil_mode`` extends the high side until the
last window ends on the padded edge, so a last window that starts in the
right padding is kept (torch's own ``ceil_mode`` drops it); an average
divides by prod(k) (``exclusive=False``) or by the real elements under the
window. Where those pads are symmetric and at most half the window, torch
pads in the pool itself; otherwise they go through an explicit ``F.pad``
first. ``return_mask`` gives the flat input index of each window's first
maximum, as the reference's ``_max_pool_mask``. Adaptive pools take
torch-style boundaries (start floor(i * in / out), end ceil((i + 1) * in /
out)), which are torch's own.
"""
from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from .conv import _channels_last, _norm_padding, _pad_arg, _tup

__all__ = [
    "avg_pool1d", "avg_pool2d", "avg_pool3d", "max_pool1d", "max_pool2d",
    "max_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
    "adaptive_avg_pool3d", "adaptive_max_pool1d", "adaptive_max_pool2d",
    "adaptive_max_pool3d",
]

_MAX = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG = {2: F.avg_pool2d, 3: F.avg_pool3d}
_ADAPTIVE = {("avg", 1): F.adaptive_avg_pool1d,
             ("avg", 2): F.adaptive_avg_pool2d,
             ("avg", 3): F.adaptive_avg_pool3d,
             ("max", 1): F.adaptive_max_pool1d,
             ("max", 2): F.adaptive_max_pool2d,
             ("max", 3): F.adaptive_max_pool3d}
# the mask's fill below every float32 value (the reference's -3.4e38)
_MASK_FILL = -3.4e38


def _window(x, kernel_size, stride, padding, nd, ceil_mode, channels_last):
    """(k, s, [(lo, hi)] per spatial dim) of the reference's rule, ceil
    extension included, for x already channels-first."""
    k = _tup(kernel_size, nd)
    s = _tup(stride if stride is not None else kernel_size, nd)
    pads = _norm_padding(padding, nd, channels_last)
    if pads == "VALID":
        pads = [(0, 0)] * nd
    elif pads == "SAME":
        pads = [((k[i] - 1) // 2, k[i] // 2) for i in range(nd)]
    elif isinstance(pads, str):
        raise ValueError(f"padding must be 'SAME', 'VALID' or numbers, got "
                         f"{padding!r}")
    if ceil_mode:
        pads = [(lo, hi + (s[i] - (x.shape[2 + i] + lo + hi - k[i]) % s[i])
                 % s[i]) for i, (lo, hi) in enumerate(pads)]
    return k, s, [tuple(p) for p in pads]


def _native(k, pads):
    """The pads torch's pool can take itself: symmetric, at most k // 2."""
    return all(lo == hi and 0 <= lo <= kk // 2
               for (lo, hi), kk in zip(pads, k))


def _window_sum(x, k, s, pads):
    """Sum of each window of x padded with zeros (avg_pool with divisor 1;
    1-D goes through the 2-D pool)."""
    nd = len(k)
    if nd == 1:
        return _window_sum(x.unsqueeze(2), (1,) + k, (1,) + s,
                           [(0, 0)] + pads).squeeze(2)
    if _native(k, pads):
        return _AVG[nd](x, k, s, [lo for lo, _ in pads],
                        count_include_pad=True, divisor_override=1)
    return _AVG[nd](F.pad(x, _pad_arg(pads)), k, s, 0, divisor_override=1)


def _pool_impl(kind, x, kernel_size, stride, padding, nd, data_format,
               ceil_mode=False, exclusive=True):
    channels_last = _channels_last(data_format, nd)
    if channels_last:
        x = x.movedim(-1, 1)
    k, s, pads = _window(x, kernel_size, stride, padding, nd, ceil_mode,
                         channels_last)
    if kind == "max":
        if _native(k, pads):
            out = _MAX[nd](x, k, s, [lo for lo, _ in pads])
        else:
            out = _MAX[nd](F.pad(x, _pad_arg(pads), value=-math.inf), k, s)
    else:
        out = _window_sum(x, k, s, pads)
        if exclusive:
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            out = out / _window_sum(ones, k, s, pads)
        else:
            out = out / float(math.prod(k))
    return out.movedim(1, -1) if channels_last else out


def _max_pool_mask(x, kernel_size, stride, padding, nd, ceil_mode):
    """Flat input index (int32) of each window's first maximum, as the
    reference's _max_pool_mask: x padded with -3.4e38 by ``padding`` (ints
    only) and, under ceil_mode, on the high side to the pooled size."""
    k = _tup(kernel_size, nd)
    s = k if stride is None else _tup(stride, nd)
    if not isinstance(padding, int) and not (
            isinstance(padding, (list, tuple)) and len(padding) == nd
            and all(isinstance(p, int) for p in padding)):
        raise NotImplementedError(
            "return_mask takes an int or one int per spatial dim as padding")
    p = _tup(padding, nd)
    spatial = x.shape[2:]
    pads = []
    for i in range(nd):
        size = spatial[i] + 2 * p[i] - k[i]
        extra = s[i] - size % s[i] if ceil_mode and size % s[i] else 0
        pads.append((p[i], p[i] + extra))
    win = F.pad(x.detach().float(), _pad_arg(pads), value=_MASK_FILL)
    for d in range(nd):
        win = win.unfold(2 + d, k[d], s[d])
    out_sp = win.shape[2:2 + nd]
    arg = win.reshape(win.shape[:2 + nd] + (-1,)).argmax(-1)
    flat = torch.zeros_like(arg)
    for d in range(nd):
        tail_k = math.prod(k[d + 1:])
        off = (arg // tail_k) % k[d]
        grid = torch.arange(out_sp[d], device=x.device).reshape(
            [-1 if i == d else 1 for i in range(nd)])
        flat = flat + (grid * s[d] - p[d] + off) * math.prod(spatial[d + 1:])
    return flat.to(torch.int32)


def _max_pool(x, kernel_size, stride, padding, return_mask, ceil_mode,
              data_format, nd):
    out = _pool_impl("max", x, kernel_size, stride, padding, nd, data_format,
                     ceil_mode)
    if not return_mask:
        return out
    if _channels_last(data_format, nd):
        raise ValueError(f"return_mask needs channels-first data, got "
                         f"{data_format!r}")
    return out, _max_pool_mask(x, kernel_size, stride, padding, nd, ceil_mode)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    return _max_pool(x, kernel_size, stride, padding, return_mask, ceil_mode,
                     data_format, 1)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, return_mask, ceil_mode,
                     data_format, 2)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, return_mask, ceil_mode,
                     data_format, 3)


def _no_divisor_override(divisor_override):
    if divisor_override is not None:
        raise NotImplementedError("avg_pool's divisor_override is not "
                                  "ported to the PyTorch package yet")


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool_impl("avg", x, kernel_size, stride, padding, 1, data_format,
                      ceil_mode, exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    _no_divisor_override(divisor_override)
    return _pool_impl("avg", x, kernel_size, stride, padding, 2, data_format,
                      ceil_mode, exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    _no_divisor_override(divisor_override)
    return _pool_impl("avg", x, kernel_size, stride, padding, 3, data_format,
                      ceil_mode, exclusive)


def _adaptive(kind, x, output_size, nd, data_format, return_mask=False):
    if return_mask:
        raise NotImplementedError(
            "adaptive_max_pool's return_mask is not ported to the PyTorch "
            "package yet")
    channels_last = _channels_last(data_format, nd)
    if channels_last:
        x = x.movedim(-1, 1)
    out = _ADAPTIVE[kind, nd](x, _tup(output_size, nd))
    return out.movedim(1, -1) if channels_last else out


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive("avg", x, output_size, 1, "NCL")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive("avg", x, output_size, 2, data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive("avg", x, output_size, 3, data_format)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive("max", x, output_size, 1, "NCL", return_mask)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive("max", x, output_size, 2, "NCHW", return_mask)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive("max", x, output_size, 3, "NCDHW", return_mask)
