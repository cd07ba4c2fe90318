"""Packed (varlen) flash attention: segment ids, the CUDA kernels'
wrappers and their plain PyTorch versions.

Counterpart of paddle_tpu/kernels/pallas/flash_varlen.py: the forward
(`_fwd_kernel`), dq (`_dq_kernel`) and dk/dv (`_dkv_kernel`) are
``csrc/flash_varlen.cu`` over the shared body ``csrc/flash_masked.cuh``;
the source's note says what bounds them and how they prune. The forward
and the backward each have a tensor-core route ("wgmma": bf16, D 64 or
128, 16-byte aligned rows; the backward's dO too) and a CUDA-core one
("cuda_core": float32, D 256), picked by `masked_fwd_route` and
`masked_bwd_route` (one rule); ``route_launches`` on each wrapper counts
each route's launches beside ``launches``. Tokens
stay in the entry point's [total, H, D] layout (the kernels read it in
place with strides; the TPU wrapper swaps it to [H, total, D]), and lse is
float32 [H, total] as JAX's.

The pruning ranges are computed here on the device from the segment ids,
with no host round trip (``varlen_tile_ranges``). The wrappers compute
values only; the autograd Function is in nn/functional/flash_attention.py.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .flash_attention import (_DTYPE_CODE, _ROUTE_CODE, FLASH_ROUTES,
                              HEAD_DIMS, NEG_INF, masked_bwd_route,
                              masked_fwd_route)

__all__ = ["segments_from_cu", "varlen_tile_ranges", "flash_varlen_fwd",
           "flash_varlen_bwd", "flash_varlen_fwd_plain",
           "flash_varlen_bwd_plain", "varlen_supported", "KEYLESS_LSE"]

# q rows per block of the forward and dq kernels, and key rows per block
# of the dk/dv kernel (csrc/flash_masked.cuh: kBQ and 8 * dkv_rows<HD>)
BQ = 64


def dkv_block(d):
    """Key rows per block of the dk/dv kernel at head dim d."""
    return 32 if d >= 256 else 64


# the lse of a row that sees no key: m = -1e30 and l clamped to 1e-30, in
# float32 (where log(1e-30) vanishes against 1e30)
KEYLESS_LSE = float(torch.tensor(NEG_INF, dtype=torch.float32)
                    + torch.tensor(math.log(1e-30), dtype=torch.float32))

_I64 = ctypes.c_longlong
# scale, causal, dtype, route, stream: the end of both entry points
_TAIL = [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
# one library, loaded once with both entry points' signatures
_SIG = {"flash_varlen_fwd": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
        + [_I64] * 6 + _TAIL,
        "flash_varlen_bwd": [ctypes.c_void_p] * 14 + [ctypes.c_int]
        + [ctypes.c_void_p] + [ctypes.c_int] * 5 + [_I64] * 8 + _TAIL}


def segments_from_cu(cu, total):
    """cu_seqlens [B+1] -> (seg [total] int32, local pos [total] int32) on
    cu's device, with no host sync. The same ids as JAX's
    ``cumsum(zeros(total).at[cu[1:-1]].add(1))``, edge cases included: a
    repeated boundary (an empty document) adds twice, and a boundary that
    falls outside [0, total) after JAX's wrap of negative indices (one
    equal to total: a trailing empty document) is dropped, as JAX's
    scatter drops it."""
    cu = torch.as_tensor(cu)
    dev = cu.device
    cu = cu.to(torch.int32)
    idx = cu[1:-1].to(torch.int64)
    idx = torch.where(idx < 0, idx + total, idx)
    # out-of-range boundaries go to a spare slot that is cut off below
    idx = torch.where((idx < 0) | (idx >= total), total, idx)
    bumps = torch.zeros(total + 1, dtype=torch.int32, device=dev)
    bumps.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    seg = torch.cumsum(bumps[:total], 0, dtype=torch.int32)
    starts = cu[:-1][seg.long()]
    pos = torch.arange(total, dtype=torch.int32, device=dev) - starts
    return seg, pos


def varlen_tile_ranges(seg_a, pos_a, seg_b, pos_b, tile, causal, a_is_q):
    """For each tile of ``tile`` rows of side a (the side a kernel's block
    owns), the range [lo, hi) of side-b rows that any of its rows can see,
    as int32 [n_tiles, 2] on the device, with no host sync.

    Segment ids are nondecreasing and positions rise by one per row inside
    a segment, so a tile covering segments s_lo..s_hi needs exactly the b
    rows of those segments. When causal, a q tile (a_is_q) needs no key of
    its last segment past that segment's last row's position, and a k tile
    no q row of its first segment before that segment's first key's
    position; the rows of the other segments stay in range."""
    ta, tb = seg_a.numel(), seg_b.numel()
    dev = seg_a.device
    first = torch.arange(0, ta, tile, device=dev)
    last = (first + tile - 1).clamp(max=ta - 1)
    s_lo, s_hi = seg_a[first], seg_a[last]
    lo = torch.searchsorted(seg_b, s_lo)
    hi = torch.searchsorted(seg_b, s_hi, right=True)
    if causal and a_is_q:
        fb = torch.searchsorted(seg_b, s_hi)            # first key of s_hi
        has = fb < hi
        bound = fb + (pos_a[last] - pos_b[fb.clamp(max=tb - 1)]) + 1
        hi = torch.where(has, torch.minimum(hi, torch.maximum(bound, fb)),
                         hi)
    elif causal:
        eb = torch.searchsorted(seg_b, s_lo, right=True)  # end of s_lo in b
        has = lo < eb
        bound = lo + (pos_a[first] - pos_b[lo.clamp(max=tb - 1)])
        lo = torch.where(has, torch.maximum(lo, torch.minimum(bound, eb)),
                         lo)
    return torch.stack([lo, hi], 1).to(torch.int32).contiguous()


def _segment_blocks(seg_q, seg_k):
    """Host-side (q rows, k rows) slice pairs of each q segment: the plain
    versions' loop (they are not on the path, so they may sync)."""
    sq, sk = seg_q.cpu(), seg_k.cpu()
    ids, counts = torch.unique_consecutive(sq, return_counts=True)
    ka = torch.searchsorted(sk, ids).tolist()
    kb = torch.searchsorted(sk, ids, right=True).tolist()
    qa = 0
    for n, a, b in zip(counts.tolist(), ka, kb):
        yield slice(qa, qa + n), slice(a, b)
        qa += n


def _keep(pos_q, pos_k, causal):
    if not causal:
        return torch.ones(pos_q.numel(), pos_k.numel(), dtype=torch.bool,
                          device=pos_q.device)
    return pos_q[:, None] >= pos_k[None, :]


def flash_varlen_fwd_plain(q, k, v, seg_q, pos_q, seg_k, pos_k, causal,
                           scale):
    """The kernel's function in plain PyTorch, one document at a time (so
    that no [H, total, total] tensor exists): scores in float32 with q
    pre-scaled, -1e30 where masked, p = 0 there by an explicit test, l
    clamped to 1e-30 (a keyless row emits zeros and lse KEYLESS_LSE).
    q [tq, H, D], k/v [tk, H, D] -> (o [tq, H, D] in q's dtype, lse
    float32 [H, tq])."""
    tq, h, _ = q.shape
    o = torch.zeros_like(q)
    lse = torch.full((h, tq), KEYLESS_LSE, dtype=torch.float32,
                     device=q.device)
    for rq, rk in _segment_blocks(seg_q, seg_k):
        if rk.stop <= rk.start:
            continue                                  # keyless rows
        qs = q[rq].float().transpose(0, 1) * scale    # [h, n, d]
        ks = k[rk].float().transpose(0, 1)
        vs = v[rk].float().transpose(0, 1)
        keep = _keep(pos_q[rq], pos_k[rk], causal)
        st = torch.where(keep, torch.matmul(qs, ks.transpose(-1, -2)),
                         NEG_INF)
        m = st.amax(-1, keepdim=True)
        p = torch.where(keep, torch.exp(st - m), 0.0)
        l = p.sum(-1, keepdim=True).clamp_min(1e-30)
        o[rq] = (torch.matmul(p, vs) / l).transpose(0, 1).to(q.dtype)
        lse[:, rq] = (m + torch.log(l))[..., 0]
    return o, lse


def flash_varlen_bwd_plain(q, k, v, o, lse, do, seg_q, pos_q, seg_k, pos_k,
                           causal, scale):
    """The backward kernels' function in plain PyTorch, one document at a
    time, with the TPU kernels' math: p recomputed from the saved float32
    lse (0 where masked, by an explicit test), delta = rowsum(dO * O) in
    float32, ds = p (dp - delta) scale, dq = ds k, dk = ds^T (q scale) /
    scale, dv = p^T dO. Returns (dq, dk, dv), each in its input's dtype."""
    dq = torch.zeros_like(q)
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    delta = (do.float() * o.float()).sum(-1)          # [tq, h]
    for rq, rk in _segment_blocks(seg_q, seg_k):
        if rk.stop <= rk.start:
            continue
        qs = q[rq].float().transpose(0, 1) * scale
        ks = k[rk].float().transpose(0, 1)
        vs = v[rk].float().transpose(0, 1)
        dos = do[rq].float().transpose(0, 1)
        keep = _keep(pos_q[rq], pos_k[rk], causal)
        st = torch.where(keep, torch.matmul(qs, ks.transpose(-1, -2)),
                         NEG_INF)
        p = torch.where(keep, torch.exp(st - lse[:, rq, None]), 0.0)
        dp = torch.matmul(dos, vs.transpose(-1, -2))
        ds = p * (dp - delta[rq].transpose(0, 1)[..., None]) * scale
        dq[rq] = torch.matmul(ds, ks).transpose(0, 1).to(q.dtype)
        dk[rk] = (torch.matmul(ds.transpose(-1, -2), qs) / scale) \
            .transpose(0, 1).to(k.dtype)
        dv[rk] = torch.matmul(p.transpose(-1, -2), dos).transpose(0, 1) \
            .to(v.dtype)
    return dq, dk, dv


def varlen_supported(total_q, total_k, d):
    """Whether the CUDA kernels take these sizes: any totals (tail tiles
    are masked, unlike the TPU kernels' 128-divisible totals) and a head
    dim in HEAD_DIMS."""
    return d in HEAD_DIMS and total_q >= 1 and total_k >= 1


def _strides(x):
    # token and head strides in elements; the kernels need D contiguous
    if x.stride(-1) != 1:
        x = x.contiguous()
    return x, x.stride(0), x.stride(1)


def _check(q, k, v, seg_q, pos_q, seg_k, pos_k):
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 or \
            q.shape[1:] != k.shape[1:]:
        raise ValueError(f"q must be [total_q, H, D] and k, v one [total_k,"
                         f" H, D], got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {HEAD_DIMS}")
    for name, t, n in (("seg_q", seg_q, q.shape[0]), ("pos_q", pos_q,
                                                      q.shape[0]),
                       ("seg_k", seg_k, k.shape[0]), ("pos_k", pos_k,
                                                      k.shape[0])):
        if t.dtype != torch.int32 or tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be int32 [{n}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if not all(t.device == q.device for t in (k, v, seg_q, pos_q, seg_k,
                                              pos_k)):
        raise ValueError("the varlen kernels' inputs must be on one device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "the varlen kernel wrappers compute values only; call "
            "nn.functional.flash_attn_unpadded for gradients")


def flash_varlen_fwd(q, k, v, seg_q, pos_q, seg_k, pos_k, causal, scale):
    """Packed attention forward: q [tq, H, D], k/v [tk, H, D] with the
    segments of segments_from_cu -> (o [tq, H, D] in q's dtype, lse float32
    [H, tq]). A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel `masked_fwd_route` picks (or raises)."""
    if q.device.type == "cpu":
        return flash_varlen_fwd_plain(q, k, v, seg_q, pos_q, seg_k, pos_k,
                                      causal, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"no varlen flash-attention kernel for "
                           f"{q.device}")
    _check(q, k, v, seg_q, pos_q, seg_k, pos_k)
    seg_q, pos_q, seg_k, pos_k = (t.contiguous() for t in
                                  (seg_q, pos_q, seg_k, pos_k))
    (q, qs, qh), (k, ks, kh), (v, vs, vh) = map(_strides, (q, k, v))
    tq, h, d = q.shape
    tk = k.shape[0]
    rq = varlen_tile_ranges(seg_q, pos_q, seg_k, pos_k, BQ, causal, True)
    o = torch.empty(tq, h, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(h, tq, dtype=torch.float32, device=q.device)
    route = masked_fwd_route(q.dtype, d, [t.data_ptr() for t in (q, k, v)],
                             (qs, qh, ks, kh, vs, vh))
    lib = _build.load("flash_varlen", _SIG)
    with torch.cuda.device(q.device):
        rc = lib.flash_varlen_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), seg_q.data_ptr(), pos_q.data_ptr(),
            seg_k.data_ptr(), pos_k.data_ptr(), rq.data_ptr(), rq.shape[0],
            h, tq, tk, d, qs, qh, ks, kh, vs, vh, float(scale),
            int(bool(causal)), _DTYPE_CODE[q.dtype], _ROUTE_CODE[route],
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"flash_varlen_fwd launch failed ({route} "
                           f"kernel): CUDA error {rc}")
    flash_varlen_fwd.launches += 1
    flash_varlen_fwd.route_launches[route] += 1
    return o, lse


flash_varlen_fwd.launches = 0
flash_varlen_fwd.route_launches = dict.fromkeys(FLASH_ROUTES, 0)


def flash_varlen_bwd(q, k, v, o, lse, do, seg_q, pos_q, seg_k, pos_k,
                     causal, scale):
    """Packed attention backward from the forward's o and float32 lse
    [H, tq] -> (dq, dk, dv), each in its input's dtype and layout. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel pair
    `masked_bwd_route` picks (or raises): a dO that is misaligned or off
    the 8-element stride grid takes the CUDA-core pair, not a copy."""
    if q.device.type == "cpu":
        return flash_varlen_bwd_plain(q, k, v, o, lse, do, seg_q, pos_q,
                                      seg_k, pos_k, causal, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"no varlen flash-attention kernel for "
                           f"{q.device}")
    _check(q, k, v, seg_q, pos_q, seg_k, pos_k)
    tq, h, d = q.shape
    tk = k.shape[0]
    if o.shape != q.shape or do.shape != q.shape or \
            o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"o and dO must match q {tuple(q.shape)} "
                         f"{q.dtype}, got {tuple(o.shape)} {o.dtype} and "
                         f"{tuple(do.shape)} {do.dtype}")
    if tuple(lse.shape) != (h, tq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 [{h}, {tq}], got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if not all(t.device == q.device for t in (o, lse, do)):
        raise ValueError("the backward's inputs must be on one device")
    seg_q, pos_q, seg_k, pos_k = (t.contiguous() for t in
                                  (seg_q, pos_q, seg_k, pos_k))
    (q, qs, qh), (k, ks, kh), (v, vs, vh), (do, ds_, dh) = \
        map(_strides, (q, k, v, do))
    lse = lse.contiguous()
    # delta = rowsum(dO * O) in float32, outside the kernels, as
    # _varlen_bwd computes it before its pallas_calls
    delta = (do.float() * o.float()).sum(-1).transpose(0, 1).contiguous()
    rq = varlen_tile_ranges(seg_q, pos_q, seg_k, pos_k, BQ, causal, True)
    rk = varlen_tile_ranges(seg_k, pos_k, seg_q, pos_q, dkv_block(d), causal,
                            False)
    dq = torch.empty(tq, h, d, dtype=q.dtype, device=q.device)
    dk = torch.empty(tk, h, d, dtype=k.dtype, device=q.device)
    dv = torch.empty(tk, h, d, dtype=v.dtype, device=q.device)
    route = masked_bwd_route(q.dtype, d, [t.data_ptr() for t in
                                          (q, k, v, do)],
                             (qs, qh, ks, kh, vs, vh, ds_, dh))
    lib = _build.load("flash_varlen", _SIG)
    with torch.cuda.device(q.device):
        rc = lib.flash_varlen_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), seg_q.data_ptr(), pos_q.data_ptr(),
            seg_k.data_ptr(), pos_k.data_ptr(), rq.data_ptr(), rq.shape[0],
            rk.data_ptr(), rk.shape[0], h, tq, tk, d, qs, qh, ks, kh, vs, vh,
            ds_, dh, float(scale), int(bool(causal)), _DTYPE_CODE[q.dtype],
            _ROUTE_CODE[route], torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"flash_varlen_bwd launch failed ({route} pair): "
                           f"CUDA error {rc}")
    flash_varlen_bwd.launches += 1
    flash_varlen_bwd.route_launches[route] += 1
    return dq, dk, dv


flash_varlen_bwd.launches = 0
flash_varlen_bwd.route_launches = dict.fromkeys(FLASH_ROUTES, 0)
