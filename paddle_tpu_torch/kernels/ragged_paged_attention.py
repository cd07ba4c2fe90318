"""Ragged paged attention for the decode step: the CUDA kernel, its plain
PyTorch version, and the KV-traffic accounting.

Counterpart of paddle_tpu/kernels/pallas/ragged_paged_attention.py
(`ragged_paged_attention`, the Pallas kernel `_kernel`). One query per
slot attends to its paged KV through the slot's block table, window
0..seq_lens[s] inclusive; pages past the live one are never read. The
kernel is ``csrc/ragged_paged_attention.cu``; its note says what bounds
it and how it is laid out.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build

__all__ = ["ragged_paged_attention", "ragged_paged_attention_plain",
           "ragged_hbm_bytes", "dense_gather_hbm_bytes", "HEAD_DIMS",
           "GROUP_SIZES"]

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
GROUP_SIZES = (1, 2, 4, 8)        # query heads per kv head the kernel takes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SIG = {"ragged_paged_attention_fwd":
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]}


def ragged_paged_attention_plain(q, kpool, vpool, tables, seq_lens, scale):
    """The kernel's function in plain PyTorch. Gathers each slot's window
    through its table, reading table entries only up to the live block
    and zeroing tokens past seq_lens[s] before any arithmetic, so pages
    past the window (trash, garbage ids, NaN) never reach the output."""
    S, nh, hd = q.shape
    _, bs, nkv, _ = kpool.shape
    mb = tables.shape[1]
    nrep = nh // nkv
    dev = q.device
    pos = seq_lens.to(dev, torch.long)
    live_blk = (torch.arange(mb, device=dev)[None, :]
                <= (pos // bs)[:, None])
    tabs = torch.where(live_blk, tables.to(dev, torch.long), 0)
    live = (torch.arange(mb * bs, device=dev)[None, :]
            <= pos[:, None])                                # [S, W]
    keep = live[:, :, None, None]
    kw = kpool[tabs].reshape(S, mb * bs, nkv, hd).float()
    vw = vpool[tabs].reshape(S, mb * bs, nkv, hd).float()
    kw = torch.where(keep, kw, 0.0)
    vw = torch.where(keep, vw, 0.0)
    qg = q.float().reshape(S, nkv, nrep, hd) * scale
    att = torch.einsum("bgnd,bwgd->bgnw", qg, kw)
    att = att.masked_fill(~live[:, None, None, :], NEG_INF)
    p = torch.softmax(att, dim=-1)
    o = torch.einsum("bgnw,bwgd->bgnd", p, vw)
    return o.reshape(S, nh, hd).to(q.dtype)


def _check(q, kpool, vpool, tables, seq_lens):
    if q.dim() != 3 or kpool.dim() != 4 or kpool.shape != vpool.shape:
        raise ValueError(f"want q [S, nh, hd] and pools [NB, bs, nkv, hd], "
                         f"got {tuple(q.shape)}, {tuple(kpool.shape)}, "
                         f"{tuple(vpool.shape)}")
    S, nh, hd = q.shape
    _, _, nkv, hd_p = kpool.shape
    if hd_p != hd or nh % nkv:
        raise ValueError(f"q {tuple(q.shape)} does not match pools "
                         f"{tuple(kpool.shape)}")
    if hd not in HEAD_DIMS or nh // nkv not in GROUP_SIZES:
        raise ValueError(f"kernel takes head dim in {HEAD_DIMS} and "
                         f"nh/nkv in {GROUP_SIZES}, got hd={hd}, "
                         f"nh/nkv={nh // nkv}")
    if not (q.dtype == kpool.dtype == vpool.dtype) \
            or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q and pools must share float32 or bfloat16, got "
                        f"{q.dtype}, {kpool.dtype}, {vpool.dtype}")
    if tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("tables and seq_lens must be int32")
    if tables.dim() != 2 or tables.shape[0] != S or seq_lens.shape != (S,):
        raise ValueError(f"want tables [S, MB] and seq_lens [S] for S={S}, "
                         f"got {tuple(tables.shape)}, "
                         f"{tuple(seq_lens.shape)}")
    for t in (kpool, vpool, tables, seq_lens):
        if t.device != q.device:
            raise ValueError("all inputs must be on q's device")
    for t in (kpool, vpool):
        if not t.is_contiguous():
            raise ValueError("pools must be contiguous")


def ragged_paged_attention(q, kpool, vpool, tables, seq_lens, scale=None):
    """Grouped decode attention straight off the paged pool.

    q [S, nh, hd]; kpool/vpool [num_blocks, block_size, nkv, hd]; tables
    [S, blocks_per_seq] int32 pool-block ids; seq_lens [S] int32, the
    position of the token just written (the window is 0..seq_lens[s]
    inclusive). Returns [S, nh, hd] in q's dtype. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (or raises)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(q, kpool, vpool, tables,
                                            seq_lens, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"no ragged-attention kernel for {q.device}")
    _check(q, kpool, vpool, tables, seq_lens)
    q = q.contiguous()
    tables, seq_lens = tables.contiguous(), seq_lens.contiguous()
    S, nh, hd = q.shape
    _, bs, nkv, _ = kpool.shape
    out = torch.empty_like(q)
    lib = _build.load("ragged_paged_attention", _SIG)
    with torch.cuda.device(q.device):
        rc = lib.ragged_paged_attention_fwd(
            q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
            tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            S, nh, nkv, hd, bs, tables.shape[1], float(scale),
            _DTYPE_CODE[q.dtype], torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"ragged_paged_attention launch failed: CUDA "
                           f"error {rc}")
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0


# -- traffic accounting (own copies of the JAX package's helpers) -----------

def ragged_hbm_bytes(seq_lens, block_size, nkv, hd, itemsize, live=None,
                     scale_bytes=0):
    """KV bytes one ragged step reads, block-granular: whole blocks up to
    each live slot's position (a retired slot reads the trash block).
    scale_bytes: per-token codec-scale bytes of a quantized pool."""
    lens = np.asarray(seq_lens)
    needed = lens // block_size + 1
    if live is not None:
        needed = np.where(np.asarray(live), needed, 1)
    per_block = 2 * block_size * (nkv * hd * itemsize + scale_bytes)
    return int(needed.sum()) * per_block


def dense_gather_hbm_bytes(n_slots, blocks_per_seq, block_size, nkv, hd,
                           itemsize, scale_bytes=0):
    """KV bytes one dense-gather step reads: the full [S, W] window read by
    the gather and read again by attention, for every slot."""
    window = n_slots * blocks_per_seq * block_size \
        * (nkv * hd * itemsize + scale_bytes)
    return 2 * 2 * window
