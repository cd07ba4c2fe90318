"""Flash attention forward on [BH, S, D]: the CUDA kernel and its plain
PyTorch version.

Counterpart of paddle_tpu/kernels/pallas/flash_attention.py's forward
(`_mha_fwd` and `_mha_fwd_stream`, reached through `_flash_bhsd`). The
kernel is ``csrc/flash_attention_fwd.cu``; its note says what bounds it
and how it is laid out. The backward kernels belong to the training slice
of the port and are not here: on a CUDA tensor that needs a gradient the
wrapper raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["_flash_bhsd", "flash_attention_fwd_plain", "HEAD_DIMS"]

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SIG = {"flash_attention_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}


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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "the CUDA flash-attention kernel is forward only; its backward "
            "comes with the training slice of the port")


def _flash_bhsd(q, k, v, causal, scale=None):
    """Attention forward on [BH, S, D] -> (o [BH, S, D] in q's dtype,
    lse float32 [BH, S]). A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (or raises)."""
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
    lib = _build.load("flash_attention_fwd", _SIG)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, s, d, float(scale), int(bool(causal)),
            _DTYPE_CODE[q.dtype], torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{rc}")
    _flash_bhsd.launches += 1
    return o, lse


_flash_bhsd.launches = 0
