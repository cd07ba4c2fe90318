"""Flash attention on [BH, S, D]: the CUDA kernels and their plain
PyTorch versions.

Counterpart of paddle_tpu/kernels/pallas/flash_attention.py: the forward
(`_mha_fwd` and `_mha_fwd_stream`) is ``csrc/flash_attention_fwd.cu`` and
the two-pass backward (`_mha_bwd` and `_mha_bwd_stream`) is
``csrc/flash_attention_bwd.cu``; each source's note says what bounds it
and how it is laid out. Each has a tensor-core kernel ("wgmma": bf16, D 64
or 128, 16-byte aligned operands) and a CUDA-core one ("cuda_core":
float32, D 256). `flash_fwd_route` and `flash_bwd_route` pick one by the
same rule, so the forward and backward of one call take the same kind;
``route_launches`` on each wrapper counts the launches of each route
beside their total ``launches``. These wrappers compute values only; the
autograd Function that ties them together is in
nn/functional/flash_attention.py.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["_flash_bhsd", "_flash_bhsd_bwd", "flash_attention_fwd_plain",
           "flash_attention_bwd_plain", "flash_fwd_route", "flash_bwd_route",
           "masked_fwd_route", "masked_bwd_route", "FLASH_ROUTES",
           "HEAD_DIMS"]

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SIG = {"flash_attention_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
        + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]}
_BWD_SIG = {"flash_attention_bwd": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
            + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]}
# the kernels of each direction, in the order of the route codes of
# csrc/flash_attention_fwd.cu and csrc/flash_attention_bwd.cu
FLASH_ROUTES = ("cuda_core", "wgmma")
_ROUTE_CODE = {r: i for i, r in enumerate(FLASH_ROUTES)}
WGMMA_HEAD_DIMS = (64, 128)


def flash_attention_fwd_plain(q, k, v, causal, scale):
    """The kernel's function in plain PyTorch: scores in float32 with q
    pre-scaled, -1e30 above the diagonal when causal. Returns (o in q's
    dtype, lse float32 [BH, S])."""
    st = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if causal:
        s = q.shape[1]
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        st = st.masked_fill(~keep, NEG_INF)
    lse = torch.logsumexp(st, dim=-1)
    p = torch.exp(st - lse[..., None])
    return torch.matmul(p, v.float()).to(q.dtype), lse


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale):
    """The backward kernels' function in plain PyTorch, with the TPU
    kernels' math: p recomputed from the saved float32 lse with q
    pre-scaled and -1e30 above the diagonal, delta = rowsum(dO * O) in
    float32, ds = p (dp - delta) scale, and dk = ds^T (q scale) / scale.
    Returns (dq, dk, dv), each in its input's dtype."""
    qs = q.float() * scale
    kf, vf, dof = k.float(), v.float(), do.float()
    st = torch.matmul(qs, kf.transpose(-1, -2))
    if causal:
        s = q.shape[1]
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        st = st.masked_fill(~keep, NEG_INF)
    p = torch.exp(st - lse[..., None])
    del st
    delta = (dof * o.float()).sum(-1)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    del dp
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qs) / scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v):
    if not (q.shape == k.shape == v.shape) or q.dim() != 3:
        raise ValueError(f"q, k, v must share one [BH, S, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {HEAD_DIMS}")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k, v must be on one device")
    # the outputs carry no autograd graph, so a caller that needs gradients
    # would lose them silently (autograd.Function.forward runs with grad
    # mode off, so flash_attention passes)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "the flash-attention kernel wrappers compute values only; call "
            "nn.functional.flash_attention for gradients")


def flash_fwd_route(dtype, d, ptrs):
    """The kernel a CUDA forward launches, and the kernel pair a CUDA
    backward launches (``flash_bwd_route`` is this function, so the two
    directions of one call take the same kind): "wgmma" (tensor cores, P
    and dS as bf16 hi + lo pairs) for bf16 at D 64 or 128 with every
    operand in ``ptrs`` (q, k, v and, backward, dO) 16-byte aligned, else
    "cuda_core" (float32 arithmetic; in practice float32 inputs, which
    TF32 would round, and D 256, whose float32 accumulators would take
    128 or more registers a thread)."""
    if (dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS
            and all(p % 16 == 0 for p in ptrs)):
        return "wgmma"
    return "cuda_core"


flash_bwd_route = flash_fwd_route


def masked_fwd_route(dtype, d, ptrs, strides):
    """The kernel a CUDA masked forward (kernels/flash_varlen.py and
    flash_sparse_mask.py, one body in csrc/flash_masked.cuh) launches, and
    the kernel pair a masked backward launches (``masked_bwd_route`` is
    this function): the dense rule of `flash_fwd_route` on q, k, v and,
    backward, dO (``ptrs``), when every row, head and batch stride
    (``strides``, in elements, dO's too) is a multiple of 8, so that every
    row the tensor-core tiles copy is 16-byte aligned; else "cuda_core"."""
    if all(s % 8 == 0 for s in strides):
        return flash_fwd_route(dtype, d, ptrs)
    return "cuda_core"


masked_bwd_route = masked_fwd_route


def _flash_bhsd(q, k, v, causal, scale=None):
    """Attention forward on [BH, S, D] -> (o [BH, S, D] in q's dtype,
    lse float32 [BH, S]). A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel `flash_fwd_route` picks (or raises)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"no flash-attention kernel for {q.device}")
    _check(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bh, s, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(bh, s, dtype=torch.float32, device=q.device)
    route = flash_fwd_route(q.dtype, d, [t.data_ptr() for t in (q, k, v)])
    lib = _build.load("flash_attention_fwd", _SIG)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, s, d, float(scale), int(bool(causal)),
            _DTYPE_CODE[q.dtype], _ROUTE_CODE[route],
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention_fwd launch failed ({route} "
                           f"kernel): CUDA error {rc}")
    _flash_bhsd.launches += 1
    _flash_bhsd.route_launches[route] += 1
    return o, lse


_flash_bhsd.launches = 0
_flash_bhsd.route_launches = dict.fromkeys(FLASH_ROUTES, 0)


def _flash_bhsd_bwd(q, k, v, o, lse, do, causal, scale=None):
    """Attention backward on [BH, S, D] from the forward's o and float32
    lse -> (dq, dk, dv), each in its input's dtype. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel pair
    `flash_bwd_route` picks (or raises)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"no flash-attention kernel for {q.device}")
    _check(q, k, v)
    bh, s, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape or \
            o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"o and dO must match q {tuple(q.shape)} "
                         f"{q.dtype}, got {tuple(o.shape)} {o.dtype} and "
                         f"{tuple(do.shape)} {do.dtype}")
    if tuple(lse.shape) != (bh, s) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 [{bh}, {s}], got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if not all(t.device == q.device for t in (o, lse, do)):
        raise ValueError("the backward's inputs must be on one device")
    # autograd hands dO over in any layout; the kernels read rows
    q, k, v, do = q.contiguous(), k.contiguous(), v.contiguous(), \
        do.contiguous()
    lse = lse.contiguous()
    # delta = rowsum(dO * O) in float32, outside the kernels, as _mha_bwd
    # computes it in jnp before its pallas_calls
    delta = (do.float() * o.float()).sum(-1)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    route = flash_bwd_route(q.dtype, q.shape[-1], [t.data_ptr() for t in
                                                  (q, k, v, do)])
    lib = _build.load("flash_attention_bwd", _BWD_SIG)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), bh, s, q.shape[-1], float(scale),
            int(bool(causal)), _DTYPE_CODE[q.dtype], _ROUTE_CODE[route],
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention_bwd launch failed ({route} "
                           f"pair): CUDA error {rc}")
    _flash_bhsd_bwd.launches += 1
    _flash_bhsd_bwd.route_launches[route] += 1
    return dq, dk, dv


_flash_bhsd_bwd.launches = 0
_flash_bhsd_bwd.route_launches = dict.fromkeys(FLASH_ROUTES, 0)
