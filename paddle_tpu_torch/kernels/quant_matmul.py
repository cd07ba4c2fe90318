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

The grouped form (`quant_grouped_matmul`, the Pallas kernel `_gq_kernel`)
runs the MoE expert products over grouped_matmul's expert-sorted layout
with per-expert codes [E, N, K] and scales [E, N, K // block_k]
(``csrc/quant_grouped_matmul.cu``). `quantized_grouped_linear` is its
training front door: the forward quantizes the [E, K, N] expert stack and
runs the quantized kernel, the backward is the straight-through estimator
(the grouped kernels against the full-precision weight).
`configure_matmul_quant` / `get_matmul_quant` hold the process-wide
quantized-matmul dtype (``PT_MATMUL_QUANT``) that MoELayer's
``expert_quant="auto"`` reads.
"""
from __future__ import annotations

import ctypes
import os

import torch

from . import _build
from .grouped_matmul import (DEFAULT_BM, _check_layout, _ref_fwd,
                             _row_experts, _stream, grouped_backward)

__all__ = ["QK_BLOCK", "INT8_MAX", "FP8_MAX", "quantize_weight_blockwise",
           "dequantize_weight_blockwise", "quant_error_bound",
           "blockwise_weight_bytes", "quant_matmul", "quant_matmul_plain",
           "quant_grouped_matmul", "quant_grouped_matmul_plain",
           "quantized_grouped_linear", "configure_matmul_quant",
           "get_matmul_quant"]

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
_GQ_SIG = {"quant_grouped_matmul_fwd":
           [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]}


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
    [.., N, K // block_k] float32, both contiguous), one scale per (output
    column, K-block):
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
    # contiguous even from a transposed view of w (the expert stacks)
    return q.reshape(w.shape).contiguous(), scale.contiguous()


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


# -- the grouped (MoE expert) form ---------------------------------------------

def quant_grouped_matmul_plain(x, codes, scales, offsets, counts, bm):
    """The grouped kernel's function in plain PyTorch, as the JAX
    reference computes it: dequantize every expert to float32, then
    grouped_matmul's tiled product, rounded to x's dtype."""
    w = dequantize_weight_blockwise(codes, scales)            # [E, N, K]
    return _ref_fwd(x, w, None, offsets, counts, bm, x.dtype,
                    transpose_w=True)


def quant_grouped_matmul(x, codes, scales, *, group_offsets, group_counts,
                         bm=DEFAULT_BM):
    """grouped_matmul over quantized expert weights: out[r] = x[r] .
    dequant(codes[e(r)], scales[e(r)])^T, with x [Tp, K] in
    grouped_metadata's layout, codes [E, N, K] and scales [E, N, KB]
    (quantize_weight_blockwise of the [E, N, K] stack; they equal the JAX
    codec's [E, K, N] codes and [E, KB, N] scales transposed). Returns
    [Tp, N] in x's dtype; rows past a group's live tiles are unspecified.
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises)."""
    offsets = group_offsets.to(torch.int32)
    counts = group_counts.to(torch.int32)
    if codes.dim() != 3 or scales.dim() != 3:
        raise ValueError(f"want codes [E, N, K] and scales [E, N, KB], got "
                         f"{tuple(codes.shape)}, {tuple(scales.shape)}")
    e, n, k = codes.shape
    _check_layout(x, offsets, counts, e, bm)
    if tuple(scales.shape[:2]) != (e, n):
        raise ValueError(f"scales {tuple(scales.shape)} do not match codes "
                         f"{tuple(codes.shape)}")
    # one expert's codes and scales as quant_matmul takes them, and the
    # stacks contiguous as the kernel reads them
    _check(x, codes[0], scales[0])
    if not (codes.is_contiguous() and scales.is_contiguous()):
        raise ValueError("codes and scales must be contiguous")
    if x.device.type == "cpu":
        return quant_grouped_matmul_plain(x, codes, scales, offsets, counts,
                                          bm)
    if x.device.type != "cuda":
        raise RuntimeError(f"no quant_grouped_matmul kernel for {x.device}")
    x = x.contiguous()
    tp = x.shape[0]
    kb = scales.shape[2]
    out = torch.empty((tp, n), dtype=x.dtype, device=x.device)
    lib = _build.load("quant_grouped_matmul", _GQ_SIG)
    rc = lib.quant_grouped_matmul_fwd(
        x.data_ptr(), codes.data_ptr(), scales.data_ptr(), out.data_ptr(),
        offsets.data_ptr(), counts.data_ptr(), e, tp, k, n, kb, k // kb,
        int(bm), _X_CODE[x.dtype], _Q_CODE[codes.dtype], _stream(x))
    if rc:
        raise RuntimeError(f"quant_grouped_matmul launch failed: CUDA error "
                           f"{rc}")
    quant_grouped_matmul.launches += 1
    return out


quant_grouped_matmul.launches = 0


class _QuantizedGroupedLinear(torch.autograd.Function):
    """Quantized forward, full-precision backward (the straight-through
    estimator of the JAX package's `_qgmm_vjp`)."""

    @staticmethod
    def forward(ctx, x, w, b, offsets, counts, qdtype, block_k, bm):
        codes, scales = quantize_weight_blockwise(w.transpose(1, 2),
                                                  block_k, qdtype)
        y = quant_grouped_matmul(x, codes, scales, group_offsets=offsets,
                                 group_counts=counts, bm=bm)
        if b is not None:
            e_of_row, _ = _row_experts(offsets, counts, x.shape[0],
                                       w.shape[0])
            y = (y.float() + b[e_of_row.long()].float()).to(y.dtype)
        ctx.save_for_backward(x, w, offsets, counts)
        ctx.bm, ctx.has_bias = bm, b is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, offsets, counts = ctx.saved_tensors
        dx, dw, db = grouped_backward(x, w, dy.to(x.dtype), offsets, counts,
                                      ctx.bm, ctx.has_bias)
        return dx, dw, db, None, None, None, None, None


def quantized_grouped_linear(x, w, b=None, *, group_offsets, group_counts,
                             qdtype="int8", block_k=None, bm=DEFAULT_BM):
    """grouped_matmul (x [Tp, K], w [E, K, N], b [E, N] or [E, 1, N] or
    None) with the weight quantized per block of block_k contraction rows
    on the forward and the gradients in full precision: the MoE expert
    products' quantized path."""
    if qdtype not in _CODE_DTYPES:
        raise ValueError(f"qdtype must be 'int8' or 'fp8', got {qdtype!r}")
    if b is not None and b.dim() == 3:        # the [E, 1, N] layer form
        b = b.reshape(b.shape[0], b.shape[2])
    return _QuantizedGroupedLinear.apply(
        x, w, b, group_offsets.to(torch.int32), group_counts.to(torch.int32),
        qdtype, block_k, int(bm))


# -- the process-wide quantized-matmul dtype -----------------------------------

def _env_default():
    d = os.environ.get("PT_MATMUL_QUANT", "").strip().lower()
    return d if d in _CODE_DTYPES else None


_MATMUL_QUANT = {"dtype": _env_default()}
_UNCHANGED = "__unchanged__"


def configure_matmul_quant(dtype=_UNCHANGED):
    """Set the process-wide quantized-matmul dtype (None, "int8" or
    "fp8"), which MoELayer(expert_quant="auto") reads when it is built.
    With no argument, read it without changing it. Returns the setting."""
    if dtype is not _UNCHANGED:
        if dtype in ("none", "", False):
            dtype = None
        if dtype is not None and dtype not in _CODE_DTYPES:
            raise ValueError(f"matmul_quant must be None, 'int8' or 'fp8', "
                             f"got {dtype!r}")
        _MATMUL_QUANT["dtype"] = dtype
    return dict(_MATMUL_QUANT)


def get_matmul_quant():
    return _MATMUL_QUANT["dtype"]
