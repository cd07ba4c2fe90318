"""FlashMask attention (per-column start rows): the CUDA kernels' wrappers
and their plain PyTorch versions.

Counterpart of paddle_tpu/kernels/pallas/flash_sparse_mask.py: the
forward (`_fwd_kernel`), dq (`_dq_kernel`) and dk/dv (`_dkv_kernel`) are
``csrc/flash_sparse_mask.cu`` over the shared body
``csrc/flash_masked.cuh``; the source's note says what bounds them and how
they prune. The forward and the backward each have a tensor-core route
("wgmma": bf16, D 64 or 128, 16-byte aligned rows; the backward's dO too)
and a CUDA-core one ("cuda_core": float32, D 256), picked by
`masked_fwd_route` and `masked_bwd_route` (one rule), with
``route_launches`` beside ``launches``. Row r sees column c
iff r < start[b*h, c] (and r >= c when causal). q, k, v stay in the
entry point's [B, S, H, D] layout (the kernels read it in place with
strides; the TPU wrapper folds it to [B*H, S, D]); lse is float32
[B*H, S] as JAX's.

The per-tile start maxima that drive the pruning (JAX's `_prep`) are
computed here on the device. The wrappers compute values only; the
autograd Function is in nn/functional/extras.py.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_attention import (_DTYPE_CODE, _ROUTE_CODE, FLASH_ROUTES,
                              HEAD_DIMS, NEG_INF, masked_bwd_route,
                              masked_fwd_route)

__all__ = ["tile_max", "flash_sparse_mask_fwd", "flash_sparse_mask_bwd",
           "flash_sparse_mask_fwd_plain", "flash_sparse_mask_bwd_plain",
           "sparse_mask_supported"]

# columns per key tile of the CUDA-core forward and dq kernels
# (csrc/flash_masked.cuh kTile): tile_max holds one start maximum per TILE
# columns; the tensor-core forward's 64-key tile reads two of them
TILE = 32

_I64 = ctypes.c_longlong
# scale, causal, dtype, route, stream: the end of both entry points
_TAIL = [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
# one library, loaded once with both entry points' signatures
_SIG = {"flash_sparse_mask_fwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
        + [_I64] * 9 + _TAIL,
        "flash_sparse_mask_bwd": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
        + [_I64] * 12 + _TAIL}


def tile_max(start):
    """start int32 [BH, S] -> int32 [BH, ceil(S / TILE)], the largest start
    of each TILE columns (a tail tile is padded with 0, which raises no
    maximum), on start's device: the TPU kernels' per-kv-block maxima."""
    bh, s = start.shape
    n = -(-s // TILE)
    pad = n * TILE - s
    if pad:
        start = torch.cat([start, start.new_zeros(bh, pad)], 1)
    return start.reshape(bh, n, TILE).amax(-1).to(torch.int32).contiguous()


def _fold(x):
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d)


def _unfold(x, b, h):
    bh, s, d = x.shape
    return x.reshape(b, h, s, d).transpose(1, 2).contiguous()


def _keep(start, causal):
    # start [c, S] -> allowed [c, S(rows), S(cols)]
    s = start.shape[-1]
    rows = torch.arange(s, device=start.device)[:, None]
    keep = rows < start[:, None, :]
    if causal:
        keep = keep & (rows >= torch.arange(s, device=start.device)[None, :])
    return keep


def _chunk(s, chunk):
    # [chunk, S, S] float32 scores of at most 2^28 elements (1 GiB)
    return chunk or max(1, (1 << 28) // (s * s))


def flash_sparse_mask_fwd_plain(q, k, v, start, causal, scale, chunk=None):
    """The kernel's function in plain PyTorch, in chunks of the B*H heads
    (a [B*H, S, S] float32 score tensor would not fit at training sizes):
    scores in float32 with q pre-scaled, -1e30 where masked, p = 0 there
    by an explicit test, l clamped to 1e-30 (a row that sees no column
    emits zeros). q/k/v [B, S, H, D], start int32 [B*H, S] -> (o [B, S, H,
    D] in q's dtype, lse float32 [B*H, S])."""
    b, s, h, d = q.shape
    qf, kf, vf = _fold(q), _fold(k), _fold(v)
    o = torch.empty(b * h, s, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b * h, s, dtype=torch.float32, device=q.device)
    c = _chunk(s, chunk)
    for i in range(0, b * h, c):
        j = min(i + c, b * h)
        keep = _keep(start[i:j], causal)
        st = torch.matmul(qf[i:j].float() * scale,
                          kf[i:j].float().transpose(-1, -2))
        st = torch.where(keep, st, NEG_INF)
        m = st.amax(-1, keepdim=True)
        p = torch.where(keep, torch.exp(st - m), 0.0)
        del st
        l = p.sum(-1, keepdim=True).clamp_min(1e-30)
        o[i:j] = (torch.matmul(p, vf[i:j].float()) / l).to(q.dtype)
        lse[i:j] = (m + torch.log(l))[..., 0]
    return _unfold(o, b, h), lse


def flash_sparse_mask_bwd_plain(q, k, v, o, lse, do, start, causal, scale,
                                chunk=None):
    """The backward kernels' function in plain PyTorch, in chunks of B*H,
    with the TPU kernels' math: p from the saved float32 lse (0 where
    masked, by an explicit test), delta = rowsum(dO * O) in float32, ds = p
    (dp - delta) scale, dq = ds k, dk = ds^T (q scale) / scale, dv = p^T
    dO. Returns (dq, dk, dv) [B, S, H, D], each in its input's dtype."""
    b, s, h, d = q.shape
    qf, kf, vf, of, dof = (_fold(x) for x in (q, k, v, o, do))
    dq = torch.empty(b * h, s, d, dtype=q.dtype, device=q.device)
    dk = torch.empty(b * h, s, d, dtype=k.dtype, device=q.device)
    dv = torch.empty(b * h, s, d, dtype=v.dtype, device=q.device)
    c = _chunk(s, chunk)
    for i in range(0, b * h, c):
        j = min(i + c, b * h)
        keep = _keep(start[i:j], causal)
        qs = qf[i:j].float() * scale
        kc, vc, dc = kf[i:j].float(), vf[i:j].float(), dof[i:j].float()
        st = torch.where(keep, torch.matmul(qs, kc.transpose(-1, -2)),
                         NEG_INF)
        p = torch.where(keep, torch.exp(st - lse[i:j, :, None]), 0.0)
        del st
        delta = (dc * of[i:j].float()).sum(-1)
        dp = torch.matmul(dc, vc.transpose(-1, -2))
        ds = p * (dp - delta[..., None]) * scale
        del dp
        dv[i:j] = torch.matmul(p.transpose(-1, -2), dc).to(v.dtype)
        dq[i:j] = torch.matmul(ds, kc).to(q.dtype)
        dk[i:j] = (torch.matmul(ds.transpose(-1, -2), qs) / scale) \
            .to(k.dtype)
    return _unfold(dq, b, h), _unfold(dk, b, h), _unfold(dv, b, h)


def sparse_mask_supported(s, d):
    """Whether the CUDA kernels take these sizes: any S (tail tiles are
    masked, unlike the TPU kernels' 128-divisible S) and a head dim in
    HEAD_DIMS."""
    return d in HEAD_DIMS and s >= 1


def _strides(x):
    # (b, s, h) strides in elements; the kernels need D contiguous
    if x.stride(-1) != 1:
        x = x.contiguous()
    return x, x.stride(0), x.stride(1), x.stride(2)


def _check(q, k, v, start):
    if q.dim() != 4 or not (q.shape == k.shape == v.shape):
        raise ValueError(f"q, k, v must share one [B, S, H, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, s, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if start.dtype != torch.int32 or tuple(start.shape) != (b * h, s):
        raise ValueError(f"start must be int32 [{b * h}, {s}], got "
                         f"{start.dtype} {tuple(start.shape)}")
    if not all(t.device == q.device for t in (k, v, start)):
        raise ValueError("the FlashMask kernels' inputs must be on one "
                         "device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "the FlashMask kernel wrappers compute values only; call "
            "nn.functional.flash_attention_with_sparse_mask for gradients")


def flash_sparse_mask_fwd(q, k, v, start, causal, scale):
    """FlashMask forward: q/k/v [B, S, H, D], start int32 [B*H, S] -> (o
    [B, S, H, D] in q's dtype, lse float32 [B*H, S]). A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel
    `masked_fwd_route` picks (or raises)."""
    if q.device.type == "cpu":
        return flash_sparse_mask_fwd_plain(q, k, v, start, causal, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"no FlashMask kernel for {q.device}")
    _check(q, k, v, start)
    b, s, h, d = q.shape
    start = start.contiguous()
    tmax = tile_max(start)
    (q, *qs), (k, *ks), (v, *vs) = map(_strides, (q, k, v))
    o = torch.empty(b, s, h, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b * h, s, dtype=torch.float32, device=q.device)
    route = masked_fwd_route(q.dtype, d, [t.data_ptr() for t in (q, k, v)],
                             (*qs, *ks, *vs))
    lib = _build.load("flash_sparse_mask", _SIG)
    with torch.cuda.device(q.device):
        rc = lib.flash_sparse_mask_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), start.data_ptr(), tmax.data_ptr(), b, h, s, d,
            *qs, *ks, *vs, float(scale), int(bool(causal)),
            _DTYPE_CODE[q.dtype], _ROUTE_CODE[route],
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"flash_sparse_mask_fwd launch failed ({route} "
                           f"kernel): CUDA error {rc}")
    flash_sparse_mask_fwd.launches += 1
    flash_sparse_mask_fwd.route_launches[route] += 1
    return o, lse


flash_sparse_mask_fwd.launches = 0
flash_sparse_mask_fwd.route_launches = dict.fromkeys(FLASH_ROUTES, 0)


def flash_sparse_mask_bwd(q, k, v, o, lse, do, start, causal, scale):
    """FlashMask backward from the forward's o and float32 lse [B*H, S] ->
    (dq, dk, dv) [B, S, H, D], each in its input's dtype. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel pair
    `masked_bwd_route` picks (or raises): a dO that is misaligned or off
    the 8-element stride grid takes the CUDA-core pair, not a copy."""
    if q.device.type == "cpu":
        return flash_sparse_mask_bwd_plain(q, k, v, o, lse, do, start,
                                           causal, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"no FlashMask kernel for {q.device}")
    _check(q, k, v, start)
    b, s, h, d = q.shape
    if o.shape != q.shape or do.shape != q.shape or \
            o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"o and dO must match q {tuple(q.shape)} "
                         f"{q.dtype}, got {tuple(o.shape)} {o.dtype} and "
                         f"{tuple(do.shape)} {do.dtype}")
    if tuple(lse.shape) != (b * h, s) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 [{b * h}, {s}], got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if not all(t.device == q.device for t in (o, lse, do)):
        raise ValueError("the backward's inputs must be on one device")
    start = start.contiguous()
    tmax = tile_max(start)
    lse = lse.contiguous()
    # delta = rowsum(dO * O) in float32, outside the kernels, as _sm_bwd
    # computes it before its pallas_calls: [B, S, H] -> [B*H, S]
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
        .reshape(b * h, s).contiguous()
    (q, *qs), (k, *ks), (v, *vs), (do, *dos) = map(_strides, (q, k, v, do))
    dq = torch.empty(b, s, h, d, dtype=q.dtype, device=q.device)
    dk = torch.empty(b, s, h, d, dtype=k.dtype, device=q.device)
    dv = torch.empty(b, s, h, d, dtype=v.dtype, device=q.device)
    route = masked_bwd_route(q.dtype, d, [t.data_ptr() for t in
                                          (q, k, v, do)],
                             (*qs, *ks, *vs, *dos))
    lib = _build.load("flash_sparse_mask", _SIG)
    with torch.cuda.device(q.device):
        rc = lib.flash_sparse_mask_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), start.data_ptr(), tmax.data_ptr(), b, h, s, d,
            *qs, *ks, *vs, *dos, float(scale), int(bool(causal)),
            _DTYPE_CODE[q.dtype], _ROUTE_CODE[route],
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"flash_sparse_mask_bwd launch failed ({route} "
                           f"pair): CUDA error {rc}")
    flash_sparse_mask_bwd.launches += 1
    flash_sparse_mask_bwd.route_launches[route] += 1
    return dq, dk, dv


flash_sparse_mask_bwd.launches = 0
flash_sparse_mask_bwd.route_launches = dict.fromkeys(FLASH_ROUTES, 0)
