"""Ragged paged attention for the decode step: the CUDA kernels, their
plain PyTorch versions, the int8 KV row codec, and the KV-traffic
accounting.

Counterpart of paddle_tpu/kernels/pallas/ragged_paged_attention.py. One
query per slot attends to its paged KV through the slot's block table,
window 0..seq_lens[s] inclusive; no position past it is read. Three
kernels, each a wrapper here over a source in ``csrc/`` whose note says
what bounds it and how it is laid out:

- ``ragged_paged_attention`` (Pallas `_kernel`):
  ``csrc/ragged_paged_attention.cu``;
- ``ragged_paged_attention_quant`` (Pallas `_qkernel`), over an int8 pool
  of codes and one float32 scale per token row (``kv_quantize_rows``):
  ``csrc/ragged_paged_attention_quant.cu``;
- ``ragged_paged_attention_partials`` (Pallas `_pkernel`), the per-shard
  online-softmax partials that ``ragged_paged_attention_sharded`` merges
  by the lse rescale: ``csrc/ragged_paged_attention_partials.cu``. All
  shards go in one launch (split-KV); the JAX package launches once per
  shard.

The three are instances of one body, ``csrc/ragged_decode.cuh``, which
splits each shard's window (the whole table for the first two) over a
thread-block cluster by a plan it makes from the device's seq_lens
(``decode_stage_tokens``, ``decode_split`` and ``partials_split`` mirror
it).
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build

__all__ = ["ragged_paged_attention", "ragged_paged_attention_plain",
           "ragged_paged_attention_quant",
           "ragged_paged_attention_quant_plain",
           "ragged_paged_attention_partials",
           "ragged_paged_attention_partials_plain",
           "ragged_paged_attention_sharded", "merge_partials",
           "kv_quantize_rows", "kv_dequantize_rows", "kv_row_error_bound",
           "ragged_hbm_bytes", "dense_gather_hbm_bytes", "HEAD_DIMS",
           "GROUP_SIZES", "decode_route", "DECODE_ROUTES",
           "decode_stage_tokens", "decode_split",
           "decode_cluster_size", "partials_split",
           "partials_cluster_size"]

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
GROUP_SIZES = (1, 2, 4, 8)        # query heads per kv head the kernel takes
DECODE_ROUTES = ("kernel", "plain")


def decode_route(dtype, head_dim, group_size):
    """The route of a decoder's decode attention, from the query dtype, the
    head dim and the query heads per KV head alone: "kernel" (the ragged,
    int8-pool or split-context kernel, or its plain version on a CPU
    tensor) for float32 or bf16 queries at a head dim in HEAD_DIMS and a
    group size in GROUP_SIZES, else "plain" (the decoder's dense path, the
    reference's math), as the reference serves a model of any head dim."""
    if (dtype in _DTYPE_CODE and head_dim in HEAD_DIMS
            and group_size in GROUP_SIZES):
        return "kernel"
    return "plain"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SIG = {"ragged_paged_attention_fwd":
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
        "ragged_paged_attention_cluster": [ctypes.c_int] * 5}
_QSIG = {"ragged_paged_attention_quant_fwd":
         [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
         + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
         "ragged_paged_attention_quant_cluster": [ctypes.c_int] * 5}
_PSIG = {"ragged_paged_attention_partials_fwd":
         [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
         + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
         "ragged_paged_attention_partials_cluster": [ctypes.c_int] * 6}


def _live_windows(kpool, vpool, tables, seq_lens, dequant=None):
    """Each slot's window [S, W, nkv, hd] in float32 and its live mask
    [S, W] (position <= seq_lens[s]). Table entries are read only up to
    the live block and positions past seq_lens[s] are zeroed before any
    arithmetic, so pages past the window (trash, garbage ids, NaN) never
    reach a result. ``dequant(tabs)`` gives a quantized pool's gathered
    K and V blocks in float32."""
    S, mb = tables.shape
    bs, nkv, hd = kpool.shape[1:4]
    dev = tables.device
    pos = seq_lens.to(dev, torch.long)
    live_blk = (torch.arange(mb, device=dev)[None, :]
                <= (pos // bs)[:, None])
    tabs = torch.where(live_blk, tables.long(), 0)
    live = (torch.arange(mb * bs, device=dev)[None, :]
            <= pos[:, None])                                # [S, W]
    keep = live[:, :, None, None]
    if dequant is None:
        kw, vw = kpool[tabs].float(), vpool[tabs].float()
    else:
        kw, vw = dequant(tabs)
    kw = torch.where(keep, kw.reshape(S, mb * bs, nkv, hd), 0.0)
    vw = torch.where(keep, vw.reshape(S, mb * bs, nkv, hd), 0.0)
    return kw, vw, live


def _softmax_attend(q, kw, vw, live, scale):
    nh, hd = q.shape[1:]
    S, _, nkv, _ = kw.shape
    qg = q.float().reshape(S, nkv, nh // nkv, hd) * scale
    att = torch.einsum("bgnd,bwgd->bgnw", qg, kw)
    att = att.masked_fill(~live[:, None, None, :], NEG_INF)
    p = torch.softmax(att, dim=-1)
    o = torch.einsum("bgnw,bwgd->bgnd", p, vw)
    return o.reshape(S, nh, hd).to(q.dtype)


def ragged_paged_attention_plain(q, kpool, vpool, tables, seq_lens, scale):
    """The kernel's function in plain PyTorch: each slot's live window,
    gathered through its table, then softmax attention in float32."""
    kw, vw, live = _live_windows(kpool, vpool, tables.to(q.device),
                                 seq_lens)
    return _softmax_attend(q, kw, vw, live, scale)


def _check(q, kpool, vpool, tables, seq_lens, pool_dtype=None):
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
    want = q.dtype if pool_dtype is None else pool_dtype
    if not (want == kpool.dtype == vpool.dtype) \
            or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q must be float32 or bfloat16 and the pools "
                        f"{want}, got {q.dtype}, {kpool.dtype}, "
                        f"{vpool.dtype}")
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
        if t.data_ptr() % 16:
            raise ValueError("pools must be 16-byte aligned (the kernel "
                             "copies whole rows in 16-byte pieces)")


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


# -- the decode body's plan (csrc/ragged_decode.cuh), mirrored -------------
# A block of the kernel's cluster takes a run of stages of TS tokens; TS is
# set by the instance's layout: G lanes a key (8..32, so that a lane's q
# columns stay within 32 registers and a vector load is at least 8 bytes),
# 32 / G keys a warp at once, U of them a group a stage, about 2 KB of K a
# stage.

def decode_stage_tokens(hd, itemsize, nrep):
    """TS, the tokens of one ring stage of the decode body for head dim
    hd, a pool of ``itemsize``-byte elements (1 for int8 codes) and nrep
    query heads per kv head (`Cfg::TS` in csrc/ragged_decode.cuh)."""
    g = min(32, hd * itemsize // 8, max(8, nrep * hd // 32))
    ngw = 32 // g
    return ngw * max(1, min(4, 2048 // (ngw * hd * itemsize)))


def _stage_runs(n, splits, ts):
    """n tokens in units of ts, split evenly over `splits` ranks: the runs
    [a, b) in rank order; an empty run has a == b."""
    units = -(-n // ts) if n > 0 else 0
    runs = []
    for c in range(splits):
        u0, u1 = c * units // splits, (c + 1) * units // splits
        runs.append((u0 * ts, max(u0 * ts, min(u1 * ts, n))))
    return runs


def decode_split(seq_len, mb, bs, splits, ts):
    """The token runs [a, b) the kernel's cluster ranks 0..splits-1 take
    of one slot's window (positions 0..min(seq_len, mb * bs - 1)): the
    window's tokens in units of ts, split evenly; an empty run has a ==
    b."""
    return _stage_runs(max(min(int(seq_len), mb * bs - 1) + 1, 0), splits,
                       ts)


def partials_split(seq_len, mb, bs, num_shards, splits, ts):
    """The partials kernel's plan for one slot: for each shard that holds
    a block, the shard-local token runs [a, b) its cluster ranks
    0..splits-1 take (decode_split over the shard's live tokens, which
    start at the shard's first block: shard z holds table entries z spb ..
    min(z spb + spb, mb), spb = ceil(mb / num_shards)). A shard with no
    live token gives every rank an empty run."""
    spb, shards = _shard_plan(mb, num_shards)
    plan = []
    for z in range(shards):
        b0 = z * spb
        width = min(spb, mb - b0)
        n = max(min(int(seq_len) - b0 * bs, width * bs - 1) + 1, 0)
        plan.append(_stage_runs(n, splits, ts))
    return plan


def partials_cluster_size(S, nh, nkv, hd, shards, dtype):
    """The cluster size (1-8) the partials kernel takes for these shapes
    and ``shards`` shards (those that hold a block) on the current card:
    the largest whose S * nkv * shards clusters all fit at once. dtype is
    q's (float32 or bfloat16). Needs the card."""
    lib = _build.load("ragged_paged_attention_partials", _PSIG)
    c = lib.ragged_paged_attention_partials_cluster(S, nh, nkv, hd, shards,
                                                    _DTYPE_CODE[dtype])
    if c < 1:
        raise RuntimeError(f"ragged_paged_attention_partials: cluster size "
                           f"query failed: CUDA error {-c}")
    return c


def decode_cluster_size(S, nh, nkv, hd, dtype, quant=False):
    """The cluster size (1-8) the kernel takes for these shapes on the
    current card: the largest whose S * nkv clusters all fit at once.
    dtype is q's (float32 or bfloat16). Needs the card."""
    name = ("ragged_paged_attention_quant" if quant
            else "ragged_paged_attention")
    lib = _build.load(name, _QSIG if quant else _SIG)
    c = getattr(lib, f"{name}_cluster")(S, nh, nkv, hd, _DTYPE_CODE[dtype])
    if c < 1:
        raise RuntimeError(f"{name}: cluster size query failed: CUDA error "
                           f"{-c}")
    return c


# -- int8 paged KV: the per-row codec and its kernel --------------------------
# One quantization group per pool token row: the [nkv, hd] K (or V) vector
# a token writes, so appending a token touches its own codes and one float32
# scale and never requantizes a neighbour. With a = max|x| over the row,
# scale = a / 127 and rounding to nearest (half to even) give |dequant(x) -
# x| <= a / 254 per element; a zero row stores scale 1 and codes 0.

def kv_quantize_rows(x):
    """x [..., nkv, hd] -> (codes int8 [..., nkv, hd], scales float32
    [...]), one symmetric scale per token row; equal to the JAX package's
    codec bit for bit."""
    xf = x.float()
    amax = xf.abs().amax(dim=(-2, -1))
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(xf / scale[..., None, None]), -127.0, 127.0)
    return q.to(torch.int8), scale


def kv_dequantize_rows(codes, scales):
    """Inverse of kv_quantize_rows, in float32."""
    return codes.float() * scales[..., None, None]


def kv_row_error_bound(x):
    """Per-row bound on |dequant - x| for x [..., nkv, hd]: amax / 254,
    half an int8 step at scale amax / 127."""
    return x.float().abs().amax(dim=(-2, -1)) / 254.0


def ragged_paged_attention_quant_plain(q, kcodes, kscale, vcodes, vscale,
                                       tables, seq_lens, scale):
    """The quantized kernel's function in plain PyTorch: the live window's
    codes and row scales, dequantized after the gather (positions past
    seq_lens[s] are zeroed, whatever code or scale they hold), then the
    same float32 softmax attention."""
    def dequant(tabs):
        return (kv_dequantize_rows(kcodes[tabs], kscale[tabs]),
                kv_dequantize_rows(vcodes[tabs], vscale[tabs]))

    kw, vw, live = _live_windows(kcodes, vcodes, tables.to(q.device),
                                 seq_lens, dequant)
    return _softmax_attend(q, kw, vw, live, scale)


def _check_quant(q, kcodes, kscale, vcodes, vscale, tables, seq_lens):
    _check(q, kcodes, vcodes, tables, seq_lens, pool_dtype=torch.int8)
    if kscale.dtype != torch.float32 or vscale.dtype != torch.float32:
        raise TypeError("row scales must be float32")
    if kscale.shape != kcodes.shape[:2] or vscale.shape != kscale.shape:
        raise ValueError(f"want scales [NB, bs] for pools "
                         f"{tuple(kcodes.shape)}, got "
                         f"{tuple(kscale.shape)}, {tuple(vscale.shape)}")
    for t in (kscale, vscale):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("scales must be contiguous on q's device")


def ragged_paged_attention_quant(q, kcodes, kscale, vcodes, vscale, tables,
                                 seq_lens, scale=None):
    """ragged_paged_attention over an int8 pool: kcodes/vcodes
    [num_blocks, block_size, nkv, hd] int8, kscale/vscale [num_blocks,
    block_size] float32 (the kv_quantize_rows layout). q [S, nh, hd]
    float32 or bfloat16; returns [S, nh, hd] in q's dtype. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (or
    raises)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return ragged_paged_attention_quant_plain(
            q, kcodes, kscale, vcodes, vscale, tables, seq_lens, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"no ragged-attention kernel for {q.device}")
    _check_quant(q, kcodes, kscale, vcodes, vscale, tables, seq_lens)
    q = q.contiguous()
    tables, seq_lens = tables.contiguous(), seq_lens.contiguous()
    S, nh, hd = q.shape
    _, bs, nkv, _ = kcodes.shape
    out = torch.empty_like(q)
    lib = _build.load("ragged_paged_attention_quant", _QSIG)
    with torch.cuda.device(q.device):
        rc = lib.ragged_paged_attention_quant_fwd(
            q.data_ptr(), kcodes.data_ptr(), kscale.data_ptr(),
            vcodes.data_ptr(), vscale.data_ptr(), tables.data_ptr(),
            seq_lens.data_ptr(), out.data_ptr(), S, nh, nkv, hd, bs,
            tables.shape[1], float(scale), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"ragged_paged_attention_quant launch failed: "
                           f"CUDA error {rc}")
    ragged_paged_attention_quant.launches += 1
    return out


ragged_paged_attention_quant.launches = 0


# -- split-context attention: per-shard partials, merged by the lse ----------
# A slot's block table is cut into contiguous shards of ceil(MB / shards)
# blocks. Each shard gives its online-softmax partial, o normalised within
# the shard and lse = m + log(max(l, 1e-30)); with M = max_k lse_k and
# w_k = exp(lse_k - M), out = sum_k w_k o_k / sum_k w_k (the ring-attention
# combine). A shard with no live token has lse ~ -1e30, so w_k is 0.

def _shard_plan(mb, num_shards):
    """(blocks per shard, number of shards that hold a block)."""
    num_shards = int(num_shards)
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if num_shards > mb:
        raise ValueError(f"num_shards {num_shards} exceeds blocks_per_seq "
                         f"{mb}")
    spb = -(-mb // num_shards)
    return spb, -(-mb // spb)


def ragged_paged_attention_partials_plain(q, kpool, vpool, tables, seq_lens,
                                          num_shards, scale):
    """The partials kernel's function in plain PyTorch: (o [K, S, nh, hd],
    lse [K, S, nh]), both float32, for the K shards that hold a block."""
    S, nh, hd = q.shape
    bs, nkv = kpool.shape[1], kpool.shape[2]
    mb = tables.shape[1]
    spb, shards = _shard_plan(mb, num_shards)
    lens = seq_lens.to(q.device, torch.long)
    outs, lses = [], []
    for k in range(shards):
        lo, hi = k * spb, min((k + 1) * spb, mb)
        # shard-local position of the last live token; -1 = empty shard
        local = (lens + 1 - lo * bs).clamp(0, (hi - lo) * bs) - 1
        kw, vw, live = _live_windows(kpool, vpool,
                                     tables[:, lo:hi].to(q.device), local)
        qg = q.float().reshape(S, nkv, nh // nkv, hd) * scale
        att = torch.einsum("bgnd,bwgd->bgnw", qg, kw)
        att = att.masked_fill(~live[:, None, None, :], NEG_INF)
        m = att.amax(dim=-1, keepdim=True)
        p = torch.where(live[:, None, None, :], torch.exp(att - m), 0.0)
        l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        o = torch.einsum("bgnw,bwgd->bgnd", p, vw) / l_safe
        outs.append(o.reshape(S, nh, hd))
        lses.append((m + torch.log(l_safe)).reshape(S, nh))
    return torch.stack(outs), torch.stack(lses)


def ragged_paged_attention_partials(q, kpool, vpool, tables, seq_lens,
                                    num_shards, scale=None):
    """Per-shard partials (o [K, S, nh, hd], lse [K, S, nh], float32) of
    ragged paged attention over ``num_shards`` contiguous sub-tables of
    ceil(MB / num_shards) blocks (K = the shards that hold a block). Same
    inputs as ragged_paged_attention; seq_lens are global positions. A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel
    once for all shards (or raises)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return ragged_paged_attention_partials_plain(
            q, kpool, vpool, tables, seq_lens, num_shards, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"no ragged-attention kernel for {q.device}")
    _check(q, kpool, vpool, tables, seq_lens)
    q = q.contiguous()
    tables, seq_lens = tables.contiguous(), seq_lens.contiguous()
    S, nh, hd = q.shape
    _, bs, nkv, _ = kpool.shape
    mb = tables.shape[1]
    spb, shards = _shard_plan(mb, num_shards)
    o = torch.empty((shards, S, nh, hd), dtype=torch.float32,
                    device=q.device)
    lse = torch.empty((shards, S, nh), dtype=torch.float32, device=q.device)
    lib = _build.load("ragged_paged_attention_partials", _PSIG)
    with torch.cuda.device(q.device):
        rc = lib.ragged_paged_attention_partials_fwd(
            q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
            tables.data_ptr(), seq_lens.data_ptr(), o.data_ptr(),
            lse.data_ptr(), S, nh, nkv, hd, bs, mb, spb, shards,
            float(scale), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"ragged_paged_attention_partials launch "
                           f"failed: CUDA error {rc}")
    ragged_paged_attention_partials.launches += 1
    return o, lse


ragged_paged_attention_partials.launches = 0


def merge_partials(o, lse, dtype):
    """Combine shard partials o [K, S, nh, hd], lse [K, S, nh] by the lse
    rescale -> [S, nh, hd] in ``dtype``."""
    w = torch.exp(lse - lse.amax(dim=0, keepdim=True))  # empty shards -> 0
    num = torch.einsum("ksh,kshd->shd", w, o)
    den = w.sum(dim=0).clamp_min(1e-30)
    return (num / den[..., None]).to(dtype)


def ragged_paged_attention_sharded(q, kpool, vpool, tables, seq_lens,
                                   num_shards, scale=None):
    """Context-length-sharded ragged paged attention: the contract of
    ragged_paged_attention, computed as ``num_shards`` shard partials
    (ragged_paged_attention_partials) merged by the lse rescale in
    PyTorch. One shard gives the unsharded result."""
    o, lse = ragged_paged_attention_partials(q, kpool, vpool, tables,
                                             seq_lens, num_shards, scale)
    return merge_partials(o, lse, q.dtype)


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
