"""Rotary position embedding (rotate-half) and the causal softmax: the
CUDA kernels' wrappers, their plain PyTorch versions and the autograd
Functions that join them.

Counterpart of paddle_tpu/kernels/pallas/fused_elementwise.py: `_rope_core`
(one kernel for both directions) and `_smut_fwd_core` / `_smut_bwd_core`
are ``csrc/fused_elementwise.cu``; the source's note says what bounds
them. RoPE takes x [B, S, H, D] and float32 tables [S, D] (or [1, D],
broadcast over S) read in place: the TPU wrapper's [B*S, D] tiled copy is
not made. The softmax keeps column c of row r iff c <= r and saves its
output p in x's dtype for the backward, as `_smut_fwd` does.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_attention import _DTYPE_CODE, NEG_INF
from .rms_norm import _aligned

__all__ = ["rope", "rope_plain", "Rope", "rope_supported",
           "causal_softmax_fwd", "causal_softmax_bwd",
           "causal_softmax_fwd_plain", "causal_softmax_bwd_plain",
           "CausalSoftmax", "masked_softmax_upper_tri",
           "masked_softmax_supported"]

_SIG = {"rope_apply": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        "causal_softmax_fwd": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
        + [ctypes.c_void_p],
        "causal_softmax_bwd": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        + [ctypes.c_void_p]}


# -- rotary embedding ----------------------------------------------------------

def rope_supported(x):
    """The JAX package's routing to its kernel (`fused_rotary_position_
    embedding`, rotate-half without position ids): 4-D x with D a multiple
    of 128."""
    return x.dim() == 4 and x.shape[-1] % 128 == 0


def rope_plain(x, cos, sin, backward=False):
    """The kernel's function in plain PyTorch: x [B, S, H, D], tables
    [S or 1, D]; in float32 with x1, x2 the halves of D, the forward gives
    (x1 c1 - x2 s1, x2 c2 + x1 s2) and the backward (the transpose) (x1 c1
    + x2 s2, x2 c2 - x1 s1), cast to x's dtype."""
    half = x.shape[-1] // 2
    xf = x.float()
    c = cos.float()[None, :, None, :]
    s = sin.float()[None, :, None, :]
    x1, x2 = xf[..., :half], xf[..., half:]
    c1, c2 = c[..., :half], c[..., half:]
    s1, s2 = s[..., :half], s[..., half:]
    if backward:
        o = torch.cat([x1 * c1 + x2 * s2, x2 * c2 - x1 * s1], -1)
    else:
        o = torch.cat([x1 * c1 - x2 * s1, x2 * c2 + x1 * s2], -1)
    return o.to(x.dtype)


def rope(x, cos, sin, backward=False):
    """RoPE (rotate-half) of x [B, S, H, D] with tables [S or 1, D]; the
    transpose with backward=True. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (or raises)."""
    if x.device.type == "cpu":
        return rope_plain(x, cos, sin, backward)
    if x.device.type != "cuda":
        raise RuntimeError(f"no RoPE kernel for {x.device}")
    if not rope_supported(x) or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"the RoPE kernel takes float32 or bfloat16 x [B, "
                         f"S, H, D] with D a multiple of 128, got "
                         f"{x.dtype} {tuple(x.shape)}")
    b, s, h, d = x.shape
    if cos.shape != sin.shape or cos.dim() != 2 or cos.shape[1] != d or \
            cos.shape[0] not in (s, 1):
        raise ValueError(f"the RoPE kernel takes cos and sin [{s} or 1, "
                         f"{d}], got {tuple(cos.shape)} and "
                         f"{tuple(sin.shape)}")
    if cos.device != x.device or sin.device != x.device:
        raise ValueError("the RoPE kernel's inputs must be on one device")
    x = _aligned(x)
    cos, sin = _aligned(cos.float()), _aligned(sin.float())
    out = torch.empty_like(x)
    lib = _build.load("fused_elementwise", _SIG)
    with torch.cuda.device(x.device):
        rc = lib.rope_apply(
            x.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(), b,
            s, h, d, d if cos.shape[0] == s else 0, int(bool(backward)),
            _DTYPE_CODE[x.dtype], torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"rope launch failed: CUDA error {rc}")
    rope.launches += 1
    return out


rope.launches = 0


class Rope(torch.autograd.Function):
    """RoPE of x with its backward (the same kernel, transposed). The
    tables get no gradient: they are buffers, as in `_rope_bwd`."""

    @staticmethod
    def forward(ctx, x, cos, sin):
        ctx.save_for_backward(cos, sin)
        return rope(x, cos, sin)

    @staticmethod
    def backward(ctx, g):
        cos, sin = ctx.saved_tensors
        return rope(g, cos, sin, backward=True), None, None


# -- upper-triangle masked (causal) softmax -------------------------------------

def masked_softmax_supported(x):
    """The JAX package's routing to its kernel: square [..., S, S] scores
    with S a multiple of 128."""
    return x.dim() >= 2 and x.shape[-1] % 128 == 0 and \
        x.shape[-1] == x.shape[-2]


def _keep(s, device):
    return torch.ones(s, s, dtype=torch.bool, device=device).tril()


def causal_softmax_fwd_plain(x):
    """The forward kernel's function in plain PyTorch, as `_smut_kernel`
    computes it: x [N, S, S], -1e30 where column > row, softmax in float32
    (e / sum e), cast to x's dtype."""
    keep = _keep(x.shape[-1], x.device)
    masked = torch.where(keep, x.float(), NEG_INF)
    e = torch.exp(masked - masked.amax(-1, keepdim=True))
    return (e / e.sum(-1, keepdim=True)).to(x.dtype)


def causal_softmax_bwd_plain(p, g):
    """The backward kernel's function in plain PyTorch: dx = p (g - sum(p
    g)) in float32 over the columns <= row, 0 beyond, in p's dtype. g's
    masked half is never read, so a NaN there stays out of dx (the JAX
    kernel's p = 0 times a NaN there would not)."""
    keep = _keep(p.shape[-1], p.device)
    pf = p.float()
    gf = torch.where(keep, g.float(), 0.0)
    dot = (pf * gf).sum(-1, keepdim=True)
    return torch.where(keep, pf * (gf - dot), 0.0).to(p.dtype)


def _check_scores(x, what):
    if x.dim() != 3 or x.shape[1] != x.shape[2] or x.shape[2] % 128 or \
            x.shape[0] < 1:
        raise ValueError(f"the causal softmax kernels take {what} [N, S, S] "
                         f"with S a multiple of 128, got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the causal softmax kernels take float32 or "
                        f"bfloat16, got {x.dtype}")


def causal_softmax_fwd(x):
    """Causal softmax of x [N, S, S] -> p in x's dtype. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel (or raises)."""
    if x.device.type == "cpu":
        return causal_softmax_fwd_plain(x)
    if x.device.type != "cuda":
        raise RuntimeError(f"no causal softmax kernel for {x.device}")
    _check_scores(x, "x")
    x = _aligned(x)
    p = torch.empty_like(x)
    n, s, _ = x.shape
    lib = _build.load("fused_elementwise", _SIG)
    with torch.cuda.device(x.device):
        rc = lib.causal_softmax_fwd(x.data_ptr(), p.data_ptr(), n, s,
                                    _DTYPE_CODE[x.dtype],
                                    torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"causal_softmax_fwd launch failed: CUDA error "
                           f"{rc}")
    causal_softmax_fwd.launches += 1
    return p


causal_softmax_fwd.launches = 0


def causal_softmax_bwd(p, g):
    """The causal softmax's backward from its output p [N, S, S] and the
    gradient g -> dx in p's dtype. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (or raises)."""
    if p.device.type == "cpu":
        return causal_softmax_bwd_plain(p, g)
    if p.device.type != "cuda":
        raise RuntimeError(f"no causal softmax kernel for {p.device}")
    _check_scores(p, "p")
    if g.shape != p.shape or g.device != p.device:
        raise ValueError(f"g must be {tuple(p.shape)} on {p.device}, got "
                         f"{tuple(g.shape)} on {g.device}")
    p, g = _aligned(p), _aligned(g.to(p.dtype))
    dx = torch.empty_like(p)
    n, s, _ = p.shape
    lib = _build.load("fused_elementwise", _SIG)
    with torch.cuda.device(p.device):
        rc = lib.causal_softmax_bwd(p.data_ptr(), g.data_ptr(), dx.data_ptr(),
                                    n, s, _DTYPE_CODE[p.dtype],
                                    torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"causal_softmax_bwd launch failed: CUDA error "
                           f"{rc}")
    causal_softmax_bwd.launches += 1
    return dx


causal_softmax_bwd.launches = 0


class CausalSoftmax(torch.autograd.Function):
    """The causal softmax of x [N, S, S]; the forward saves its output p
    (in x's dtype), from which the backward kernel computes dx."""

    @staticmethod
    def forward(ctx, x):
        p = causal_softmax_fwd(x)
        ctx.save_for_backward(p)
        return p

    @staticmethod
    def backward(ctx, g):
        p, = ctx.saved_tensors
        return causal_softmax_bwd(p, g)


def masked_softmax_upper_tri(x):
    """x [..., S, S] scores -> the softmax over each row's columns <= row,
    differentiable through the kernels: the JAX package's
    `masked_softmax_upper_tri_pallas`."""
    shape = x.shape
    return CausalSoftmax.apply(x.reshape(-1, shape[-2], shape[-1])) \
        .reshape(shape)
