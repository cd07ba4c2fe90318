"""Grouped matmul for the dropless MoE expert path: the routing layout,
the CUDA kernels' wrappers, their plain PyTorch versions and the
differentiable ``grouped_matmul``.

Counterpart of paddle_tpu/kernels/pallas/grouped_matmul.py. Routes are
sorted by expert into contiguous groups, each at a row offset that is a
multiple of ``bm`` (``grouped_metadata``), and each expert's product runs
over exactly its rows: no capacity buffer, no dropped route. The forward
kernel (`_fwd_kernel`) and the weight-gradient kernel (`_dw_kernel`) are
``csrc/grouped_matmul.cu``; its note says what bounds them and how they
are laid out. The routing stays on the card: the metadata is built from
one-hot cumsums in int32 (no sort, no host round trip), and the kernels
read the group offsets and counts from device memory.

Weights keep the JAX package's [E, K, N] layout (``x @ w[e]``), so an
expert stack converts as it is.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["DEFAULT_BM", "default_block_m", "aligned_group_size",
           "grouped_metadata", "grouped_matmul", "grouped_matmul_fwd",
           "grouped_matmul_dw", "grouped_bias_grad"]

# the CUDA kernels' row tile: a group aligned to it fills whole blocks
DEFAULT_BM = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SIG = {"grouped_matmul_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
        + [ctypes.c_void_p],
        "grouped_matmul_dw": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
        + [ctypes.c_void_p]}


def default_block_m():
    """The group alignment ``bm`` for this card: the kernels' 128-row
    tile (the autotune cache of the JAX package is not ported)."""
    return DEFAULT_BM


def aligned_group_size(n_routes, num_expert, bm):
    """Rows of the tile-aligned sorted buffer: each group padded up to a
    multiple of bm adds at most bm - 1 rows, plus one spare tile."""
    return (math.ceil(max(int(n_routes), 1) / bm) + int(num_expert)) * bm


def _onehot_ranks(expert_ids, num_expert):
    """(counts [E], rank [T]) in int32: rank is a route's position among
    the routes to its expert in route order (the stable expert-sort
    order), from one-hot cumsums; no sort runs. The one-hot is [E, T], so
    the cumsum runs along the contiguous dim (a scan down the outer dim of
    [T, E] takes milliseconds on the card at 16,384 routes)."""
    e = expert_ids.reshape(-1).to(torch.int32)
    oh = (torch.arange(num_expert, dtype=torch.int32,
                       device=e.device)[:, None] == e[None, :]) \
        .to(torch.int32)                                     # [E, T]
    counts = oh.sum(1, dtype=torch.int32)
    csum = oh.cumsum(1, dtype=torch.int32) - 1
    rank = csum.gather(0, e.long()[None, :])[0]
    return counts, rank


def grouped_metadata(expert_ids, num_expert, bm, total_rows=None):
    """Routing metadata of the sorted-token grouped layout, int32 on the
    routes' device: counts [E], offsets [E] (tile-aligned row offset of
    each group), dest [T] (buffer row of route i), row_src [Tp] (buffer row
    -> route, -1 for padding) and row_valid [Tp] (bool). Tp = total_rows
    or aligned_group_size(T, E, bm)."""
    e = expert_ids.reshape(-1).to(torch.int32)
    t = e.shape[0]
    tp = int(total_rows) if total_rows is not None \
        else aligned_group_size(t, num_expert, bm)
    counts, rank = _onehot_ranks(e, num_expert)
    tiles = (counts + (bm - 1)) // bm
    offsets = torch.zeros_like(counts)
    offsets[1:] = tiles.cumsum(0, dtype=torch.int32)[:-1] * bm
    dest = offsets[e.long()] + rank
    row_src = torch.full((tp,), -1, dtype=torch.int32, device=e.device)
    row_src.scatter_(0, dest.long(),
                     torch.arange(t, dtype=torch.int32, device=e.device))
    return {"counts": counts, "offsets": offsets, "dest": dest,
            "row_src": row_src, "row_valid": row_src >= 0}


# -- plain versions (the JAX package's XLA reference) ---------------------------

def _row_experts(offsets, counts, t_rows, num_expert):
    """Buffer row -> (expert id, valid) from the aligned group layout."""
    rows = torch.arange(t_rows, dtype=torch.int32, device=offsets.device)
    ge = rows[:, None] >= offsets[None, :]
    exp = (ge.sum(1, dtype=torch.int32) - 1).clamp(0, num_expert - 1)
    el = exp.long()
    valid = rows < offsets[el] + counts[el]
    return exp, valid


def _tile_experts(offsets, t_rows, bm, num_expert):
    """Tile index -> expert id (alignment makes it unique)."""
    toffs = offsets // bm
    tiles = torch.arange(t_rows // bm, dtype=torch.int32,
                         device=offsets.device)
    ge = tiles[:, None] >= toffs[None, :]
    return (ge.sum(1, dtype=torch.int32) - 1).clamp(0, num_expert - 1)


def _ref_fwd(x, w, b, offsets, counts, bm, out_dtype, transpose_w=False):
    """The forward kernel's function: one batched product over bm-row
    tiles with a per-tile weight gather, in float32, rounded to
    out_dtype. transpose_w: x . w[e]^T (the input gradient)."""
    t_rows, k = x.shape
    texp = _tile_experts(offsets, t_rows, bm, w.shape[0]).long()
    wg = w[texp].float()
    xt = x.float().reshape(-1, bm, k)
    out = torch.matmul(xt, wg.transpose(1, 2) if transpose_w else wg)
    if b is not None:
        out = out + b[texp][:, None, :].float()
    return out.reshape(t_rows, -1).to(out_dtype)


def _ref_dw(x, dy, offsets, counts, bm, num_expert):
    """The dw kernel's function: per-expert x^T dy over the live rows, in
    float32. Rows past each group's count are selected out of x and dy
    both, so a NaN there cannot reach dw."""
    t_rows, k = x.shape
    _, valid = _row_experts(offsets, counts, t_rows, num_expert)
    texp = _tile_experts(offsets, t_rows, bm, num_expert).long()
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    xm = torch.where(valid[:, None], x.float(), zero)
    dym = torch.where(valid[:, None], dy.float(), zero)
    dwt = torch.matmul(xm.reshape(-1, bm, k).transpose(1, 2),
                       dym.reshape(-1, bm, dy.shape[1]))       # [MT, K, N]
    dw = torch.zeros((num_expert, k, dy.shape[1]), dtype=torch.float32,
                     device=x.device)
    return dw.index_add_(0, texp, dwt)


def grouped_bias_grad(dy, offsets, counts, num_expert):
    """db [E, N] float32: the per-expert sum of dy over each group's live
    rows (a plain masked sum, as in the JAX package); padding rows are
    selected out, not multiplied by 0."""
    e_of_row, valid = _row_experts(offsets, counts, dy.shape[0],
                                   num_expert)
    oh = (e_of_row[:, None] == torch.arange(
        num_expert, dtype=torch.int32, device=dy.device)[None, :]) \
        & valid[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=dy.device)
    dym = torch.where(valid[:, None], dy.float(), zero)
    return oh.float().t() @ dym


# -- the kernels' wrappers ------------------------------------------------------

def _check_layout(x, offsets, counts, num_expert, bm):
    if x.dim() != 2:
        raise ValueError(f"want a [T, K] token buffer, got {tuple(x.shape)}")
    if x.shape[0] % bm:
        raise ValueError(f"token buffer rows {x.shape[0]} must be a "
                         f"multiple of bm={bm}")
    for name, t in (("group_offsets", offsets), ("group_counts", counts)):
        if tuple(t.shape) != (num_expert,) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 [{num_expert}], got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} must lie on the buffer's device")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")


def _stream(x):
    with torch.cuda.device(x.device):
        return torch.cuda.current_stream().cuda_stream


def grouped_matmul_fwd(x, w, b, offsets, counts, bm, transpose_w=False):
    """out[r] = x[r] . w[e(r)] (+ b[e(r)]) over each group's live tiles.
    x [Tp, K]; w [E, K, N] (or [E, N, K] read transposed when
    transpose_w); b [E, N] or None; offsets, counts int32 [E]. Returns
    [Tp, N] in x's dtype; rows past a group's live tiles are unspecified.
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises)."""
    e = w.shape[0]
    _check_layout(x, offsets, counts, e, bm)
    kdim = 2 if transpose_w else 1
    if w.dim() != 3 or w.shape[kdim] != x.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         f"match (transpose_w={transpose_w})")
    n = w.shape[3 - kdim]
    if w.dtype != x.dtype or (b is not None and b.dtype != x.dtype):
        raise TypeError(f"x, w and b must share a dtype, got {x.dtype}, "
                        f"{w.dtype}, {None if b is None else b.dtype}")
    if b is not None and tuple(b.shape) != (e, n):
        raise ValueError(f"b must be [{e}, {n}], got {tuple(b.shape)}")
    if x.device.type == "cpu":
        return _ref_fwd(x, w, b, offsets, counts, bm, x.dtype,
                        transpose_w=transpose_w)
    if x.device.type != "cuda":
        raise RuntimeError(f"no grouped_matmul kernel for {x.device}")
    if w.device != x.device or (b is not None and b.device != x.device):
        raise ValueError("x, w and b must share a device")
    x, w = x.contiguous(), w.contiguous()
    b = b.contiguous() if b is not None else None
    tp, k = x.shape
    out = torch.empty((tp, n), dtype=x.dtype, device=x.device)
    lib = _build.load("grouped_matmul", _SIG)
    rc = lib.grouped_matmul_fwd(
        x.data_ptr(), w.data_ptr(), b.data_ptr() if b is not None else None,
        out.data_ptr(), offsets.data_ptr(), counts.data_ptr(), e, tp, k, n,
        int(bm), int(bool(transpose_w)), _DTYPE_CODE[x.dtype],
        _stream(x))
    if rc:
        raise RuntimeError(f"grouped_matmul_fwd launch failed: CUDA error "
                           f"{rc}")
    grouped_matmul_fwd.launches += 1
    return out


grouped_matmul_fwd.launches = 0


def grouped_matmul_dw(x, dy, offsets, counts, bm, num_expert):
    """dw [E, K, N] float32 = per-expert x^T dy over each group's rows
    below its count (rows past it are never read). x [Tp, K], dy [Tp, N]
    of one dtype. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (or raises)."""
    _check_layout(x, offsets, counts, num_expert, bm)
    if dy.dim() != 2 or dy.shape[0] != x.shape[0] or dy.dtype != x.dtype:
        raise ValueError(f"dy {dy.dtype} {tuple(dy.shape)} does not match "
                         f"x {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return _ref_dw(x, dy, offsets, counts, bm, num_expert)
    if x.device.type != "cuda":
        raise RuntimeError(f"no grouped_matmul kernel for {x.device}")
    if dy.device != x.device:
        raise ValueError("x and dy must share a device")
    x, dy = x.contiguous(), dy.contiguous()
    tp, k = x.shape
    n = dy.shape[1]
    dw = torch.empty((num_expert, k, n), dtype=torch.float32,
                     device=x.device)
    lib = _build.load("grouped_matmul", _SIG)
    rc = lib.grouped_matmul_dw(
        x.data_ptr(), dy.data_ptr(), dw.data_ptr(), offsets.data_ptr(),
        counts.data_ptr(), num_expert, tp, k, n, _DTYPE_CODE[x.dtype],
        _stream(x))
    if rc:
        raise RuntimeError(f"grouped_matmul_dw launch failed: CUDA error "
                           f"{rc}")
    grouped_matmul_dw.launches += 1
    return dw


grouped_matmul_dw.launches = 0


def grouped_backward(x, w, dy, offsets, counts, bm, has_bias):
    """(dx, dw, db) of out = x . w[e] (+ b[e]): dx is the forward kernel
    against w^T, dw the dw kernel, db the masked per-expert sum (None
    without a bias), each in its primal's dtype (db in w's)."""
    dy = dy.contiguous()
    e = w.shape[0]
    dx = grouped_matmul_fwd(dy, w, None, offsets, counts, bm,
                            transpose_w=True).to(x.dtype)
    dw = grouped_matmul_dw(x, dy, offsets, counts, bm, e).to(w.dtype)
    db = grouped_bias_grad(dy, offsets, counts, e).to(w.dtype) \
        if has_bias else None
    return dx, dw, db


class _GroupedMatmul(torch.autograd.Function):
    """grouped_matmul with the JAX package's custom VJP: dx through the
    forward kernel against w^T, dw through the dw kernel, db a masked
    per-expert sum."""

    @staticmethod
    def forward(ctx, x, w, b, offsets, counts, bm):
        ctx.save_for_backward(x, w, offsets, counts)
        ctx.bm, ctx.has_bias = bm, b is not None
        return grouped_matmul_fwd(x, w, b, offsets, counts, bm)

    @staticmethod
    def backward(ctx, dy):
        x, w, offsets, counts = ctx.saved_tensors
        dx, dw, db = grouped_backward(x, w, dy.to(x.dtype), offsets, counts,
                                      ctx.bm, ctx.has_bias)
        return dx, dw, db, None, None, None


def grouped_matmul(x, w, b=None, *, group_offsets, group_counts,
                   bm=DEFAULT_BM):
    """Per-expert matmul over expert-sorted rows: out[r] = x[r] . w[e(r)]
    (+ b[e(r)]), e(r) the group row r belongs to. x [T, K] with each
    group at its tile-aligned ``group_offsets[e]`` (grouped_metadata
    builds the layout), w [E, K, N], b [E, N] or [E, 1, N] or None,
    group_counts [E]; T a multiple of bm. Padding rows give unspecified
    values and never reach a gradient. Differentiable; the gradients are
    summed in float32 and returned in each primal's dtype."""
    if b is not None and b.dim() == 3:        # the [E, 1, N] layer form
        b = b.reshape(b.shape[0], b.shape[2])
    return _GroupedMatmul.apply(x, w, b, group_offsets.to(torch.int32),
                                group_counts.to(torch.int32), int(bm))
