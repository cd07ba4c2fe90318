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
to even). The kernels are in ``csrc/quant_matmul.cu``; its note says what
bounds them and how they are laid out. `qmm_route` picks one of its four
kernels for a call: the decode GEMV on the tensor cores ("gemv_tc", bf16
x) or on the CUDA cores ("rows", float32 x and the rest), the prefill
product on the tensor cores ("wgmma", bf16 x) or on the CUDA cores
("tiled"); ``quant_matmul.route_launches`` counts the launches of each
and ``quant_matmul.launches`` their total.

The grouped form (`quant_grouped_matmul`, the Pallas kernel `_gq_kernel`)
runs the MoE expert products over grouped_matmul's expert-sorted layout
with per-expert codes [E, N, K] and scales [E, N, K // block_k]
(``csrc/quant_grouped_matmul.cu``). `gq_route` picks one of its two
kernels: the tensor-core product ("wgmma"; float32 x as three exact bf16
pieces, `split3_bf16`, bf16 x as it is) or the CUDA-core tile
("cuda_core"); ``quant_grouped_matmul.route_launches`` counts each beside
``quant_grouped_matmul.launches``. `quantized_grouped_linear` is its
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
           "get_matmul_quant", "qmm_route", "QMM_ROUTES", "ROWS_MAX_M",
           "WGMMA_BLOCK_K", "GEMV_TC_BLOCK_K", "gq_route", "GQ_ROUTES",
           "GQ_WGMMA_BM", "split3_bf16"]

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
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]}
# the kernels of csrc/quant_matmul.cu, in the order of its route codes
QMM_ROUTES = ("rows", "tiled", "wgmma", "gemv_tc")
_ROUTE_CODE = {r: i for i, r in enumerate(QMM_ROUTES)}
ROWS_MAX_M = 32          # the GEMVs take up to this many rows of x
WGMMA_BLOCK_K = 64       # the tensor-core product's blocks: multiples of this
GEMV_TC_BLOCK_K = 16     # the tensor-core GEMV's blocks: multiples of this
_GQ_SIG = {"quant_grouped_matmul_fwd":
           [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]}
# the kernels of csrc/quant_grouped_matmul.cu, in the order of its route
# codes
GQ_ROUTES = ("cuda_core", "wgmma")
_GQ_ROUTE_CODE = {r: i for i, r in enumerate(GQ_ROUTES)}
GQ_WGMMA_BM = 128        # the tensor-core product's token tile: bm % this


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


def qmm_route(m, x_dtype, block_k, x_ptr, codes_ptr):
    """The kernel a CUDA quant_matmul launches for m rows of x. Up to
    ROWS_MAX_M rows, a GEMV: "gemv_tc" (tensor cores) for bf16 x with
    blocks of whole k16 steps and 16-byte aligned x and codes, else "rows"
    (CUDA cores; in practice float32 x, the head, which the tensor cores
    would round). Above, "wgmma" (tensor cores) for bf16 x with blocks of
    whole 64-deep stages (the codec's default block is 128) and 16-byte
    aligned x and codes, else "tiled" (CUDA cores; float32 x, which TF32
    would round)."""
    bf16_aligned = (x_dtype == torch.bfloat16 and x_ptr % 16 == 0
                    and codes_ptr % 16 == 0)
    if m <= ROWS_MAX_M:
        if bf16_aligned and block_k % GEMV_TC_BLOCK_K == 0:
            return "gemv_tc"
        return "rows"
    if bf16_aligned and block_k % WGMMA_BLOCK_K == 0:
        return "wgmma"
    return "tiled"


def _launch(route, x2, codes, scales, out):
    """Launch the kernel of `route` on x2 [M, K] (contiguous, on the card)
    into out [M, N]; raises if the kernel does not take the inputs. It
    counts nothing: `quant_matmul` counts its launches."""
    m, k = x2.shape
    kb = scales.shape[1]
    lib = _build.load("quant_matmul", _SIG)
    with torch.cuda.device(x2.device):
        rc = lib.quant_matmul_fwd(
            x2.data_ptr(), codes.data_ptr(), scales.data_ptr(),
            out.data_ptr(), m, codes.shape[0], k, kb, k // kb,
            _X_CODE[x2.dtype], _Q_CODE[codes.dtype], _ROUTE_CODE[route],
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"quant_matmul launch failed ({route} kernel): "
                           f"CUDA error {rc}")


def quant_matmul(x, codes, scales):
    """x [.., K] @ dequant(codes [N, K], scales [N, KB]).T -> [.., N] in
    x's dtype (float32 or bfloat16); the block is K // KB, any divisor of
    K. A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel `qmm_route` picks (or raises)."""
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
    route = qmm_route(m, x.dtype, k // scales.shape[1], x2.data_ptr(),
                      codes.data_ptr())
    _launch(route, x2, codes, scales, out)
    quant_matmul.launches += 1
    quant_matmul.route_launches[route] += 1
    return out.reshape(*lead, n)


quant_matmul.launches = 0
quant_matmul.route_launches = dict.fromkeys(QMM_ROUTES, 0)


# -- the grouped (MoE expert) form ---------------------------------------------

_HI16 = -(1 << 16)                     # 0xFFFF0000 as an int32


def split3_bf16(x):
    """float32 x -> (hi, mid, lo) bf16 with hi + mid + lo == x exactly, the
    rule of the grouped tensor-core kernel (``split3`` in csrc/wgmma.cuh):
    hi is the top 16 bits of x, mid the top 16 bits of r = x - hi, lo = r
    - mid (at most 8 significant bits, exact in bf16 for |x| >= 2^-100).
    Truncation, so hi never overflows. A non-finite x goes whole into hi,
    a NaN with its quiet bit set, and mid = lo = 0."""
    x = x.float().contiguous()
    u = x.view(torch.int32)
    hu = u & _HI16
    r = x - hu.view(torch.float32)
    mu = r.view(torch.int32) & _HI16
    lu = (r - mu.view(torch.float32)).view(torch.int32) & _HI16
    finite = torch.isfinite(x)
    zero = torch.zeros((), dtype=torch.int32, device=x.device)
    hu = torch.where(torch.isnan(x), hu | (1 << 22), hu)
    mu = torch.where(finite, mu, zero)
    lu = torch.where(finite, lu, zero)
    return tuple((v >> 16).to(torch.int16).view(torch.bfloat16)
                 for v in (hu, mu, lu))


def gq_route(x_dtype, block_k, bm, ptrs):
    """The kernel a CUDA quant_grouped_matmul launches: "wgmma" (tensor
    cores: float32 x as three exact bf16 pieces, bf16 x as it is) for
    float32 or bf16 x with blocks of whole 64-deep stages, groups of whole
    128-row token tiles and every pointer in ``ptrs`` (x and the codes)
    16-byte aligned, else "cuda_core"."""
    if (x_dtype in (torch.float32, torch.bfloat16)
            and block_k % WGMMA_BLOCK_K == 0 and bm % GQ_WGMMA_BM == 0
            and all(p % 16 == 0 for p in ptrs)):
        return "wgmma"
    return "cuda_core"


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
    kernel `gq_route` picks (or raises)."""
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
    route = gq_route(x.dtype, k // kb, int(bm),
                     (x.data_ptr(), codes.data_ptr()))
    lib = _build.load("quant_grouped_matmul", _GQ_SIG)
    rc = lib.quant_grouped_matmul_fwd(
        x.data_ptr(), codes.data_ptr(), scales.data_ptr(), out.data_ptr(),
        offsets.data_ptr(), counts.data_ptr(), e, tp, k, n, kb, k // kb,
        int(bm), _X_CODE[x.dtype], _Q_CODE[codes.dtype],
        _GQ_ROUTE_CODE[route], _stream(x))
    if rc:
        raise RuntimeError(f"quant_grouped_matmul launch failed ({route} "
                           f"kernel): CUDA error {rc}")
    quant_grouped_matmul.launches += 1
    quant_grouped_matmul.route_launches[route] += 1
    return out


quant_grouped_matmul.launches = 0
quant_grouped_matmul.route_launches = dict.fromkeys(GQ_ROUTES, 0)


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
