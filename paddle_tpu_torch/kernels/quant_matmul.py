"""Block-scaled int8/fp8 weight matmul: the codec, the CUDA kernel's
wrapper and its plain PyTorch version.

Counterpart of paddle_tpu/kernels/pallas/quant_matmul.py (the codec and
`quant_matmul`, the Pallas kernel `_qmm_kernel`). A weight is stored as
codes (int8 or float8 e4m3, one byte per element) and one float32 scale
per (output column, block of ``block_k`` contraction rows); the matmul
dequantizes inside the kernel, so the full-width weight never exists in
device memory.

Layout. The JAX codec quantizes paddle's [K, N] weights in blocks along
K. The port keeps torch.nn.Linear's [N, K] layout: ``codes`` [.., N, K]
and ``scales`` [.., N, K // block_k], blocks along the last dim, which
keeps each output column's K codes contiguous for the kernel. They equal
the JAX codec's codes and scales transposed, bit for bit (both round half
to even). The kernel is ``csrc/quant_matmul.cu``; its note says what
bounds it and how it is laid out.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["QK_BLOCK", "INT8_MAX", "FP8_MAX", "quantize_weight_blockwise",
           "dequantize_weight_blockwise", "quant_error_bound",
           "blockwise_weight_bytes", "quant_matmul", "quant_matmul_plain"]

# one scale row per 128 contraction rows, as in the JAX package
QK_BLOCK = 128
INT8_MAX = 127.0
FP8_MAX = 448.0                  # float8_e4m3fn's largest finite value

_CODE_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
_QMAX = {"int8": INT8_MAX, "fp8": FP8_MAX}
_X_CODE = {torch.float32: 0, torch.bfloat16: 1}
_Q_CODE = {torch.int8: 0, torch.float8_e4m3fn: 1}
_SIG = {"quant_matmul_fwd":
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}


def _pick_tile(n, pref):
    """Largest divisor of n that is <= pref (the JAX package's
    grouped_matmul._pick_tile)."""
    n, pref = int(n), int(pref)
    if n <= pref:
        return n
    for c in range(pref, 0, -1):
        if n % c == 0:
            return c
    return n


def _block_of(k, block_k):
    if block_k in (None, 0):
        return _pick_tile(k, QK_BLOCK)
    block_k = int(block_k)
    if k % block_k:
        raise ValueError(f"block_k={block_k} must divide the contraction "
                         f"dim K={k}")
    return block_k


# -- codec -------------------------------------------------------------------

def quantize_weight_blockwise(w, block_k=None, qdtype="int8"):
    """w [.., N, K] -> (codes [.., N, K] int8 or float8_e4m3fn, scales
    [.., N, K // block_k] float32), one scale per (output column, K-block):
    scale = amax / QMAX over the block. A zero block gets scale 1, so it
    dequantizes exactly."""
    if qdtype not in _CODE_DTYPES:
        raise ValueError(f"qdtype must be 'int8' or 'fp8', got {qdtype!r}")
    n, k = w.shape[-2:]
    block = _block_of(k, block_k)
    kb = k // block
    wf = w.float().reshape(*w.shape[:-1], kb, block)
    amax = wf.abs().amax(dim=-1)                          # [.., N, KB]
    scale = torch.where(amax > 0, amax / _QMAX[qdtype],
                        torch.ones((), dtype=torch.float32,
                                   device=w.device))
    xb = wf / scale[..., None]
    if qdtype == "int8":
        q = torch.clamp(torch.round(xb), -INT8_MAX, INT8_MAX).to(torch.int8)
    else:
        q = xb.to(torch.float8_e4m3fn)
    return q.reshape(w.shape), scale


def dequantize_weight_blockwise(codes, scales):
    """codes [.., N, K] times scales [.., N, KB] broadcast over each
    K-block -> float32 [.., N, K]."""
    k = codes.shape[-1]
    kb = scales.shape[-1]
    q = codes.float().reshape(*codes.shape[:-1], kb, k // kb)
    return (q * scales.float()[..., None]).reshape(codes.shape)


def quant_error_bound(w, scales, qdtype="int8"):
    """Elementwise worst-case round-trip error of the codec for w [.., N,
    K]: half a scale step for int8; for fp8 e4m3 a relative half ulp
    (2^-4) with the subnormal step scale * 2^-9 as its floor."""
    k = w.shape[-1]
    sb = scales.float().repeat_interleave(k // scales.shape[-1], dim=-1)
    if qdtype == "int8":
        return sb * 0.5
    return torch.maximum(w.float().abs() * 2.0 ** -4, sb * 2.0 ** -9)


def blockwise_weight_bytes(k, n, block_k=None, qdtype="int8"):
    """(quantized bytes, bf16-equivalent bytes) of one full read of a
    K x N weight: codes at one byte each plus a float32 scale per block
    of block_k rows, against two bytes per element."""
    k, n = int(k), int(n)
    block = _block_of(k, block_k)
    return k * n * 1 + (k // block) * n * 4, k * n * 2


# -- the matmul ----------------------------------------------------------------

def quant_matmul_plain(x, codes, scales):
    """The kernel's function in plain PyTorch, as the JAX reference branch
    computes it: dequantize to float32, multiply in float32, round to
    x's dtype. x [.., K]; codes [N, K]; scales [N, KB] -> [.., N]."""
    w = dequantize_weight_blockwise(codes, scales)
    return torch.matmul(x.float(), w.t()).to(x.dtype)


def _check(x, codes, scales):
    if codes.dim() != 2 or scales.dim() != 2:
        raise ValueError(f"want codes [N, K] and scales [N, KB], got "
                         f"{tuple(codes.shape)}, {tuple(scales.shape)}")
    n, k = codes.shape
    if x.shape[-1] != k or scales.shape[0] != n or scales.shape[1] < 1 \
            or k % scales.shape[1]:
        raise ValueError(f"x {tuple(x.shape)}, codes {tuple(codes.shape)} "
                         f"and scales {tuple(scales.shape)} do not match")
    if x.dtype not in _X_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if codes.dtype not in _Q_CODE:
        raise TypeError(f"codes must be int8 or float8_e4m3fn, got "
                        f"{codes.dtype}")
    if scales.dtype != torch.float32:
        raise TypeError(f"scales must be float32, got {scales.dtype}")
    for t in (codes, scales):
        if t.device != x.device:
            raise ValueError("x, codes and scales must share a device")
        if not t.is_contiguous():
            raise ValueError("codes and scales must be contiguous")


def quant_matmul(x, codes, scales):
    """x [.., K] @ dequant(codes [N, K], scales [N, KB]).T -> [.., N] in
    x's dtype (float32 or bfloat16); the block is K // KB, any divisor of
    K. A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises)."""
    if x.device.type == "cpu":
        _check(x, codes, scales)
        return quant_matmul_plain(x, codes, scales)
    if x.device.type != "cuda":
        raise RuntimeError(f"no quant_matmul kernel for {x.device}")
    _check(x, codes, scales)
    n, k = codes.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out.reshape(*lead, n)
    lib = _build.load("quant_matmul", _SIG)
    with torch.cuda.device(x.device):
        rc = lib.quant_matmul_fwd(
            x2.data_ptr(), codes.data_ptr(), scales.data_ptr(),
            out.data_ptr(), m, n, k, scales.shape[1], k // scales.shape[1],
            _X_CODE[x.dtype], _Q_CODE[codes.dtype],
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"quant_matmul launch failed: CUDA error {rc}")
    quant_matmul.launches += 1
    return out.reshape(*lead, n)


quant_matmul.launches = 0
