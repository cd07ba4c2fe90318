"""RMSNorm over the last dim of a 2-D view: the CUDA kernels' wrappers,
their plain PyTorch versions and the autograd Function that joins them.

Counterpart of paddle_tpu/kernels/pallas/rms_norm.py: the forward
(`_rms_fwd`) and the backward (`_rms_bwd`, whose dw the JAX package
leaves to an XLA einsum) are ``csrc/rms_norm.cu``; the source's note says
what bounds them. The backward kernel writes per-block float32 dw
partials and a second small kernel sums them in a fixed order, so dw is
the same bits on every run. rstd is float32 [n] (the JAX kernel's [n, 1]
without the unit dim).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .flash_attention import _DTYPE_CODE

__all__ = ["rms_norm_fwd", "rms_norm_bwd", "rms_norm_fwd_plain",
           "rms_norm_bwd_plain", "RMSNorm2d", "rms_norm"]

# the widest row the kernels take (csrc/rms_norm.cu: 32 columns for each
# of at most 512 threads)
MAX_WIDTH = 16384
_SIG = {"rms_norm_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        "rms_norm_bwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
        + [ctypes.c_void_p]}


def rms_norm_fwd_plain(x, w, eps):
    """The forward kernel's function in plain PyTorch, as
    nn/layer/norm.py's rms_norm computes it: x [n, h], w [h] -> (x *
    rsqrt(mean(x^2) + eps) * w in float32 cast to x's dtype, rstd float32
    [n])."""
    xf = x.float()
    rstd = torch.rsqrt(xf.pow(2).mean(-1) + eps)
    return (xf * rstd[:, None] * w.float()).to(x.dtype), rstd


def rms_norm_bwd_plain(x, w, rstd, g):
    """The backward's function in plain PyTorch from the saved rstd, with
    `_rms_bwd`'s formulas: xhat = x rstd, dx = rstd (g w - xhat mean(g w
    xhat)) in x's dtype, dw = sum over rows of g x rstd in float32, cast
    to w's dtype."""
    xf, gf, wf = x.float(), g.float(), w.float()
    r = rstd[:, None]
    xhat = xf * r
    wg = gf * wf
    dx = r * (wg - xhat * (wg * xhat).mean(-1, keepdim=True))
    dw = (gf * xf * r).sum(0)
    return dx.to(x.dtype), dw.to(w.dtype)


def _check(x, w):
    if x.dim() != 2 or w.dim() != 1 or w.shape[0] != x.shape[1]:
        raise ValueError(f"the RMSNorm kernels take x [n, h] and w [h], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    n, h = x.shape
    if h % 128 or h > MAX_WIDTH or n < 1:
        raise ValueError(f"the RMSNorm kernels take n >= 1 rows of h a "
                         f"multiple of 128 up to {MAX_WIDTH}, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE or w.dtype not in _DTYPE_CODE:
        raise TypeError(f"the RMSNorm kernels take float32 or bfloat16 x "
                        f"and w, got {x.dtype} and {w.dtype}")
    if w.device != x.device:
        raise ValueError("the RMSNorm kernels' inputs must be on one device")


def _aligned(t):
    """t contiguous with a 16-byte aligned start (the row-wise kernels load
    16-byte vectors)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.lru_cache(maxsize=None)
def _partial_blocks(index):
    # about four blocks of the backward for each SM; a function of the
    # card only, so the dw summation order is fixed for a given card
    return 4 * torch.cuda.get_device_properties(index).multi_processor_count


def rms_norm_fwd(x, w, eps):
    """RMSNorm forward: x [n, h], w [h] -> (out [n, h] in x's dtype, rstd
    float32 [n]). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (or raises)."""
    if x.device.type == "cpu":
        return rms_norm_fwd_plain(x, w, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"no RMSNorm kernel for {x.device}")
    _check(x, w)
    x, w = _aligned(x), _aligned(w)
    n, h = x.shape
    out = torch.empty_like(x)
    rstd = torch.empty(n, dtype=torch.float32, device=x.device)
    lib = _build.load("rms_norm", _SIG)
    with torch.cuda.device(x.device):
        rc = lib.rms_norm_fwd(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), rstd.data_ptr(), n,
            h, float(eps), _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype],
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"rms_norm_fwd launch failed: CUDA error {rc}")
    rms_norm_fwd.launches += 1
    return out, rstd


rms_norm_fwd.launches = 0


def rms_norm_bwd(x, w, rstd, g):
    """RMSNorm backward from the forward's rstd: (dx [n, h] in x's dtype,
    dw [h] in w's dtype). A CPU tensor takes the plain version; a CUDA
    tensor launches the kernels (or raises)."""
    if x.device.type == "cpu":
        return rms_norm_bwd_plain(x, w, rstd, g)
    if x.device.type != "cuda":
        raise RuntimeError(f"no RMSNorm kernel for {x.device}")
    _check(x, w)
    n, h = x.shape
    if tuple(g.shape) != (n, h) or tuple(rstd.shape) != (n,) or \
            rstd.dtype != torch.float32:
        raise ValueError(f"g must be [{n}, {h}] and rstd float32 [{n}], got "
                         f"{tuple(g.shape)} and {rstd.dtype} "
                         f"{tuple(rstd.shape)}")
    if g.device != x.device or rstd.device != x.device:
        raise ValueError("the RMSNorm kernels' inputs must be on one device")
    x, w, rstd = _aligned(x), _aligned(w), rstd.contiguous()
    g = _aligned(g.to(x.dtype))
    dev = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    rows = -(-n // _partial_blocks(dev))
    nb = -(-n // rows)
    dx = torch.empty_like(x)
    partial = torch.empty(nb, h, dtype=torch.float32, device=x.device)
    dw = torch.empty(h, dtype=w.dtype, device=x.device)
    lib = _build.load("rms_norm", _SIG)
    with torch.cuda.device(x.device):
        rc = lib.rms_norm_bwd(
            x.data_ptr(), w.data_ptr(), rstd.data_ptr(), g.data_ptr(),
            dx.data_ptr(), partial.data_ptr(), dw.data_ptr(), n, h, rows,
            _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype],
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"rms_norm_bwd launch failed: CUDA error {rc}")
    rms_norm_bwd.launches += 1
    return dx, dw


rms_norm_bwd.launches = 0


class RMSNorm2d(torch.autograd.Function):
    """RMSNorm of x [n, h] with weight w [h]: the forward saves x, w and
    the float32 rstd, and the backward is the backward kernel (the JAX
    package's custom VJP, `_rms2d`)."""

    @staticmethod
    def forward(ctx, x, w, eps):
        out, rstd = rms_norm_fwd(x, w, eps)
        ctx.save_for_backward(x, w, rstd)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, rstd = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, w, rstd, g)
        return dx, dw, None


def rms_norm(x, w, eps=1e-6):
    """RMSNorm over the last dim of x (any rank) with w [h], through the
    kernels: the JAX package's `rms_norm_jax`."""
    shape = x.shape
    return RMSNorm2d.apply(x.reshape(-1, shape[-1]), w,
                           float(eps)).reshape(shape)
