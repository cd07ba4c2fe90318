"""Collective matmul: the tensor-parallel layers' matmuls decomposed into
permute rings with the matmul's chunks between the hops (counterpart of
paddle_tpu/distributed/fleet/meta_parallel/collective_matmul.py; T3,
arXiv 2401.16677).

Each rank runs its shard's body, in the per-rank idiom of the mp layers:
``x`` and ``w`` are the rank's local shards, ``w`` in torch.nn.Linear's
layout [out, in]. The five kinds, over the mp group of n ranks:

  column_sp      x [B, S/n, K], w [O/n, K] -> [B, S, O/n]
      y = AG_seq(x) @ w^T (ColumnSequenceParallelLinear): the gather
      ring, each hop's matmul runs while the next block is in flight.
  row_sp         x [B, S, K/n], w [O, K/n] -> [B, S/n, O]
      y = RS_seq(x @ w^T) (RowSequenceParallelLinear): the travelling
      accumulator on the reverse ring, one local contribution a hop.
  column         x [B, S, K], w [O/n, K] -> [B, S, O/n]
      no forward collective; the backward's input-gradient all-reduce
      is a reduce-scatter ring and a gather ring over the flattened rows.
  column_gather  x [B, S, K], w [O/n, K] -> [B, S, O]
      the local product, then the feature gather ring; backward as column.
  row            x [B, S, K/n], w [O, K/n] -> [B, S, O]
      the all-reduce as a reduce-scatter ring with the matmul's chunks
      and a gather ring, over the flattened rows.

Each kind is one autograd Function whose backward runs the reference's
transpose rings explicitly. A hop is posted (``collective._post_permute``)
before the chunks it hides and waited for after them; every rank posts
the same (src, dst) pairs in one order. On NCCL the point-to-point work
runs on NCCL's stream, and a received block is read only after its wait.
On gloo a send first copies its block through host memory, which waits
for the block's producer: there the rings move the same bytes but hide
nothing.

The wire codec (``compress``, the PR-4 codecs of collective.py): "bf16"
halves each hop; "int8" ships block codes with one float32 scale a 256
values. A block that travels unchanged around a gather ring is encoded
once at its source, so its error is one quantization, |err| <=
blockmax/254. Only the reduce-scatter accumulator changes between hops
and is encoded again each hop: |err| <= (n-1) hopmax/254.

A rank's x is already its dp slice, so nothing here divides the batch by
dp, and no backward sums the weight gradient over dp: the data-parallel
wrappers do that once.

``impl="reference"`` runs the same per-rank layout on the monolithic
collectives (all-gather, reduce-scatter, all-reduce), the numerical
baseline. ``chunks="auto"`` resolves to DEFAULT_CHUNKS, what the
reference's autotune cache gives when it is cold; the cache itself is
not ported yet. Knobs: DistributedStrategy.mp_overlap /
.mp_activation_compress / .mp_overlap_chunks, set by fleet.init through
``configure_mp_overlap``; ``mp_overlap_ctx`` sets them for a scope.

Counters (``counters``, keyed by kind): the reference's
paddle_tpu_mp_overlap_chunks_total, _bytes_total and
_compressed_bytes_total, added from ``overlap_wire_plan`` for each
``overlapped_linear`` call (forward and backward), and
``posted_wire_bytes``, the bytes this rank's rings actually posted, as
encoded, counted at each send.
"""
from __future__ import annotations

import contextlib

import torch
from torch.nn import functional as F

from ...collective import _post_permute, decode_wire, encode_wire

__all__ = [
    "cm_matmul", "overlapped_linear", "configure_mp_overlap",
    "mp_overlap_config", "mp_overlap_ctx", "overlap_wire_plan",
    "DEFAULT_CHUNKS", "CM_KINDS", "counters", "reset_counters",
]

# the chunk count on a cold autotune cache: sub-matmuls per ring step
DEFAULT_CHUNKS = 4

CM_KINDS = ("column_sp", "row_sp", "column", "column_gather", "row")

_MP_OVERLAP_CONFIG = {"enabled": False, "compress": None, "chunks": "auto"}

_COUNTER_NAMES = ("paddle_tpu_mp_overlap_chunks_total",
                  "paddle_tpu_mp_overlap_bytes_total",
                  "paddle_tpu_mp_overlap_compressed_bytes_total",
                  "posted_wire_bytes")
counters = {name: dict.fromkeys(CM_KINDS, 0) for name in _COUNTER_NAMES}


def reset_counters():
    for c in counters.values():
        for k in c:
            c[k] = 0


def configure_mp_overlap(enabled=None, compress=None, chunks=None):
    """Set the process-wide collective-matmul knobs (fields left None keep
    their value; compress "none" turns the codec off). Returns the
    previous setting."""
    prev = dict(_MP_OVERLAP_CONFIG)
    if enabled is not None:
        _MP_OVERLAP_CONFIG["enabled"] = bool(enabled)
    if compress is not None:
        if compress not in ("int8", "bf16", "none"):
            raise ValueError(
                f"mp_activation_compress must be 'int8', 'bf16' or None, "
                f"got {compress!r}")
        _MP_OVERLAP_CONFIG["compress"] = \
            None if compress == "none" else compress
    if chunks is not None:
        if chunks != "auto":
            chunks = int(chunks)
            if chunks < 1:
                raise ValueError(f"mp_overlap_chunks must be >= 1 or "
                                 f"'auto', got {chunks}")
        _MP_OVERLAP_CONFIG["chunks"] = chunks
    return prev


def mp_overlap_config():
    return dict(_MP_OVERLAP_CONFIG)


@contextlib.contextmanager
def mp_overlap_ctx(enabled=True, compress=None, chunks="auto"):
    """The knobs set for a scope (validated as configure_mp_overlap does)
    and restored on exit."""
    prev = dict(_MP_OVERLAP_CONFIG)
    configure_mp_overlap(enabled=enabled, compress=compress or "none",
                         chunks=chunks)
    try:
        yield
    finally:
        _MP_OVERLAP_CONFIG.clear()
        _MP_OVERLAP_CONFIG.update(prev)


# -- the ring primitives (blocks along dim 1) ---------------------------------

def _fwd_perm(n):
    # after t forward hops rank r holds the block that started at r - t
    return [(i, (i + 1) % n) for i in range(n)]


def _rev_perm(n):
    # the accumulator ring: rank r receives from r + 1 each hop
    return [(i, (i - 1) % n) for i in range(n)]


def _mm_chunks(blk, w, chunks):
    """F.linear(blk [B, S, K], w [O, K]) as ``chunks`` products along S
    (clamped to a divisor of S)."""
    s = blk.shape[1]
    c = max(1, min(int(chunks), s))
    while s % c:
        c -= 1
    if c == 1:
        return F.linear(blk, w)
    step = s // c
    return torch.cat([F.linear(blk[:, j * step:(j + 1) * step], w)
                      for j in range(c)], dim=1)


def _wgrad(dy, x):
    """dy [B, S, O], x [B, S, K] -> sum over rows of dy^T x, [O, K]."""
    return dy.reshape(-1, dy.shape[-1]).t().matmul(x.reshape(-1, x.shape[-1]))


def _gather_ring(y, g, n, compress, box):
    """The all-gather of y [B, sl, ..] on the forward ring, encoded once
    at its source: yields (j, block j) for the n blocks, this rank's
    first. Each hop is posted before its block is yielded and waited for
    after the caller's work on it."""
    parts = encode_wire(y, compress)
    for t in range(n):
        cur = decode_wire(parts, compress, y.shape, y.dtype)
        posted = None if t == n - 1 else \
            _post_permute(parts, _fwd_perm(n), g, box)
        yield (g.rank - t) % n, cur
        if posted is not None:
            parts = tuple(posted.wait())


def _ring_ag_matmul(x, w, g, n, chunks, compress, box):
    """AG_seq(x) @ w^T, x [B, sl, K] this rank's block, each block's
    chunks run while the next block is in flight. -> [B, n sl, O]."""
    b, sl, _ = x.shape
    out = x.new_empty((b, n * sl, w.shape[0]),
                      dtype=torch.promote_types(x.dtype, w.dtype))
    for j, cur in _gather_ring(x, g, n, compress, box):
        out[:, j * sl:(j + 1) * sl] = _mm_chunks(cur, w, chunks)
    return out


def _ring_matmul_rs(x, w, g, n, chunks, compress, box):
    """RS_seq(x @ w^T) on the reverse ring: x [B, S, K], the accumulator
    starts at the block farthest from home and gains one contribution a
    hop, computed while the hop is in flight; it is encoded again each
    hop. -> [B, S/n, O]."""
    sl = x.shape[1] // n
    idx = g.rank

    def blk(j):
        return x[:, j * sl:(j + 1) * sl]

    acc = _mm_chunks(blk((idx + 1) % n), w, chunks)
    for t in range(1, n):
        posted = _post_permute(encode_wire(acc, compress), _rev_perm(n), g,
                               box)
        mine = _mm_chunks(blk((idx + 1 + t) % n), w, chunks)
        acc = decode_wire(tuple(posted.wait()), compress, acc.shape,
                          acc.dtype) + mine
    return acc


def _ring_ag(y, g, n, compress, box):
    """The all-gather of y [B, sl, O] along dim 1 on the ring. -> [B, n
    sl, O]."""
    b, sl, o = y.shape
    out = y.new_empty((b, n * sl, o))
    for j, cur in _gather_ring(y, g, n, compress, box):
        out[:, j * sl:(j + 1) * sl] = cur
    return out


def _ring_grad_w(x, dy, g, n, compress, box):
    """The weight gradient of the gather matmul: the x blocks travel the
    ring again (one block a rank held, not the gathered activation), one
    block's product a hop. x [B, sl, K], dy [B, n sl, O] -> [O, K]."""
    sl = x.shape[1]
    return sum(_wgrad(dy[:, j * sl:(j + 1) * sl], cur)
               for j, cur in _gather_ring(x, g, n, compress, box))


def _ring_row_sp_bwd(dy, x, w, g, n, chunks, compress, box):
    """The backward of the matmul reduce-scatter: the dy blocks gather
    around the ring and each hop runs both transpose products. dy [B, sl,
    O], x [B, S, K], w [O, K] -> (dx [B, S, K], dw [O, K])."""
    b, sl, _ = dy.shape
    wt = w.t()
    dx = dy.new_empty((b, sl * n, w.shape[1]),
                      dtype=torch.promote_types(dy.dtype, w.dtype))
    dw = 0
    for j, cur in _gather_ring(dy, g, n, compress, box):
        dx[:, j * sl:(j + 1) * sl] = _mm_chunks(cur, wt, chunks)
        dw = dw + _wgrad(cur, x[:, j * sl:(j + 1) * sl])
    return dx, dw


# -- the five kinds' bodies ---------------------------------------------------

def _fwd_column_sp(x, w, g, n, chunks, compress, box):
    return _ring_ag_matmul(x, w, g, n, chunks, compress, box)


def _bwd_column_sp(x, w, dy, g, n, chunks, compress, box):
    # dx = RS_seq(dy @ w); dw = the x blocks gathered again
    dx = _ring_matmul_rs(dy, w.t(), g, n, chunks, compress, box)
    return dx, _ring_grad_w(x, dy, g, n, compress, box)


def _fwd_row_sp(x, w, g, n, chunks, compress, box):
    return _ring_matmul_rs(x, w, g, n, chunks, compress, box)


def _bwd_row_sp(x, w, dy, g, n, chunks, compress, box):
    return _ring_row_sp_bwd(dy, x, w, g, n, chunks, compress, box)


def _fwd_column(x, w, g, n, chunks, compress, box):
    return _mm_chunks(x, w, chunks)


def _bwd_column(x, w, dy, g, n, chunks, compress, box):
    # dx = AR(dy @ w), Megatron's "g": the reduce-scatter ring with the
    # chunks of dy @ w, then the gather ring, over the flattened rows
    b, s, _ = x.shape
    dyv = dy.reshape(1, b * s, dy.shape[-1])
    rs = _ring_matmul_rs(dyv, w.t(), g, n, chunks, compress, box)
    dx = _ring_ag(rs, g, n, compress, box).reshape(x.shape)
    return dx, _wgrad(dy, x)


def _fwd_column_gather(x, w, g, n, chunks, compress, box):
    yl = _mm_chunks(x, w, chunks)                            # [B, S, O/n]
    return _ring_ag(yl.transpose(1, 2).contiguous(), g, n, compress,
                    box).transpose(1, 2)


def _bwd_column_gather(x, w, dy, g, n, chunks, compress, box):
    # this rank's features of dy are column's cotangent
    ol = w.shape[0]
    dyl = dy[..., g.rank * ol:(g.rank + 1) * ol]
    return _bwd_column(x, w, dyl, g, n, chunks, compress, box)


def _fwd_row(x, w, g, n, chunks, compress, box):
    b, s, _ = x.shape
    z = _ring_matmul_rs(x.reshape(1, b * s, x.shape[-1]), w, g, n, chunks,
                        compress, box)
    return _ring_ag(z, g, n, compress, box).reshape(b, s, w.shape[0])


def _bwd_row(x, w, dy, g, n, chunks, compress, box):
    # x came feature-sharded and y whole: both gradients are local
    return _mm_chunks(dy, w.t(), chunks), _wgrad(dy, x)


_FWD = {"column_sp": _fwd_column_sp, "row_sp": _fwd_row_sp,
        "column": _fwd_column, "column_gather": _fwd_column_gather,
        "row": _fwd_row}
_BWD = {"column_sp": _bwd_column_sp, "row_sp": _bwd_row_sp,
        "column": _bwd_column, "column_gather": _bwd_column_gather,
        "row": _bwd_row}


def _posted(kind, box):
    counters["posted_wire_bytes"][kind] += box["wire_bytes"]


class _CMOverlap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, kind, g, chunks, compress):
        box = {"wire_bytes": 0}
        x, w = x.contiguous(), w.contiguous()
        y = _FWD[kind](x, w, g, g.nranks, chunks, compress, box)
        _posted(kind, box)
        ctx.save_for_backward(x, w)
        ctx.cfg = (kind, g, chunks, compress)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        kind, g, chunks, compress = ctx.cfg
        box = {"wire_bytes": 0}
        dx, dw = _BWD[kind](x, w, dy.contiguous(), g, g.nranks, chunks,
                            compress, box)
        _posted(kind, box)
        return dx.to(x.dtype), dw.to(w.dtype), None, None, None, None


# -- the monolithic reference (the same layout on whole collectives) ----------

def _reference(x, w, kind, g):
    from ..utils.sequence_parallel_utils import AllGatherOp, ReduceScatterOp
    from .mp_layers import _CopyToMP, _GatherFromMP, _ReduceFromMP
    if kind == "column_sp":
        return F.linear(AllGatherOp.apply(x, g), w)
    if kind == "row_sp":
        return ReduceScatterOp.apply(F.linear(x, w), g)
    if kind == "column":
        return F.linear(_CopyToMP.apply(x, g), w)
    if kind == "column_gather":
        return _GatherFromMP.apply(F.linear(_CopyToMP.apply(x, g), w), g)
    return _ReduceFromMP.apply(F.linear(x, w), g)


def _axis_group(mesh, axis):
    """The group of ``axis`` on ``mesh``: fleet's hybrid topology (the
    default) or a ProcessMesh with that dimension."""
    if mesh is None:
        from ..fleet import live_hcg
        mesh = live_hcg()
        if mesh is None:
            return None
    if hasattr(mesh, "get_axis_group"):
        return mesh.get_axis_group(axis)
    if axis not in mesh.dim_names:
        return None
    return _mesh_group(mesh, axis)


_MESH_GROUPS = {}


def _mesh_group(mesh, axis):
    """This rank's Group along the ProcessMesh dimension ``axis`` (over
    the DeviceMesh's process group of that dimension)."""
    import numpy as np
    import torch.distributed as dist

    from ...collective import Group
    from ...env import get_rank
    key = (hash(mesh), axis, id(dist.group.WORLD))
    if key not in _MESH_GROUPS:
        d = mesh.dim_names.index(axis)
        where = tuple(int(i) for i in np.argwhere(mesh.mesh == get_rank())[0])
        sl = list(where)
        sl[d] = slice(None)
        ranks = mesh.mesh[tuple(sl)].tolist()
        pg = mesh.device_mesh().get_group(axis) if len(ranks) > 1 else None
        g = Group(ranks, pg, name=f"{axis}_group")
        _MESH_GROUPS[key] = g
    return _MESH_GROUPS[key]


def _divides(kind, b, s, n):
    """Whether the kind's ring blocks divide: row_sp splits the sequence,
    the flattened-row kinds this rank's (its dp slice's) b * s rows."""
    if kind == "row_sp":
        return s % n == 0
    return kind == "column_sp" or (b * s) % n == 0


def _check_shapes(kind, x, n, axis, batch_axis):
    if kind not in CM_KINDS:
        raise ValueError(f"kind must be one of {CM_KINDS}, got {kind!r}")
    b, s = int(x.shape[0]), int(x.shape[1])
    if _divides(kind, b, s, n):
        return
    if kind == "row_sp":
        raise ValueError(f"{kind} needs seq {s} divisible by {axis}={n}")
    raise ValueError(
        f"{kind} needs per-{batch_axis}-shard rows {b * s} divisible by "
        f"{axis}={n}")


def _resolve_chunks(chunks):
    return DEFAULT_CHUNKS if chunks in (None, "auto") else max(1, int(chunks))


def cm_matmul(x, w, *, mesh=None, axis="mp", kind, chunks=None,
              compress=None, impl="overlap", batch_axis="dp"):
    """The collective matmul of ``kind`` on this rank's shards: x (its dp
    slice, laid out as the module docstring gives for the kind) and w
    [out, in] (its mp shard). ``mesh`` is fleet's hybrid topology (the
    default) or a ProcessMesh, and ``axis`` the mp dimension by name.
    impl="overlap" runs the permute rings forward and backward;
    impl="reference" the monolithic collectives in the same layout."""
    g = _axis_group(mesh, axis)
    n = 1 if g is None else g.nranks
    _check_shapes(kind, x, n, axis, batch_axis)
    if compress is not None and not x.is_floating_point():
        raise ValueError(
            f"mp_activation_compress={compress!r} needs a floating "
            f"payload, got {str(x.dtype).replace('torch.', '')}")
    if n == 1:
        return F.linear(x, w)
    if impl == "reference":
        return _reference(x, w, kind, g)
    return _CMOverlap.apply(x, w, kind, g, _resolve_chunks(chunks), compress)


# -- wire accounting ----------------------------------------------------------

def overlap_wire_plan(kind, n, b, s, k, o, itemsize, compress=None):
    """What one forward and backward through a decomposed layer puts on
    one rank's ring hops: {legs, logical_bytes, wire_bytes, matmul_rings}.
    ``b`` is the rank's batch (its dp slice), ``s`` the whole sequence,
    ``k`` and ``o`` the layer's whole in and out features; the codec is
    priced a hop as grad_buckets.wire_bytes prices it (int8: codes and a
    float32 scale a 256 values)."""
    from ..grad_buckets import wire_bytes
    sl = s // n if s % n == 0 else s
    m = b * s
    if kind == "column_sp":
        rings = [(b * sl * k, 3)]           # fwd x, bwd acc, bwd x again
        matmul_rings = 3
    elif kind == "row_sp":
        rings = [(b * sl * o, 2)]           # fwd acc, bwd dy blocks
        matmul_rings = 2
    elif kind == "column":
        rings = [((m // n) * k, 2)]         # bwd RS + AG
        matmul_rings = 1
    elif kind == "column_gather":
        rings = [(m * (o // n), 1), ((m // n) * k, 2)]
        matmul_rings = 1
    else:                                   # row
        rings = [((m // n) * o, 2)]         # fwd RS + AG
        matmul_rings = 1
    hops = n - 1
    legs = sum(r for _, r in rings) * hops
    logical = sum(p * r for p, r in rings) * hops * itemsize
    wire = sum(wire_bytes(p * itemsize, compress, itemsize=itemsize) * r
               for p, r in rings) * hops
    return {"legs": legs, "logical_bytes": int(logical),
            "wire_bytes": int(wire), "matmul_rings": matmul_rings}


def _record(kind, n, b, s, k, o, itemsize, chunks, compress):
    plan = overlap_wire_plan(kind, n, b, s, k, o, itemsize, compress)
    counters["paddle_tpu_mp_overlap_chunks_total"][kind] += \
        chunks * n * plan["matmul_rings"]
    counters["paddle_tpu_mp_overlap_bytes_total"][kind] += \
        plan["logical_bytes"]
    counters["paddle_tpu_mp_overlap_compressed_bytes_total"][kind] += \
        plan["wire_bytes"]


def overlapped_linear(x, weight, group, kind):
    """The mp layers' dispatch: the decomposed product of ``kind`` when
    the knob is on and the call is eligible (an mp group of more than one
    rank, a 3-D activation, shapes that divide), else None and the layer
    runs its exact path, as the reference's layers do. ``weight`` is the
    layer's [out, in] shard on ``group``."""
    cfg = _MP_OVERLAP_CONFIG
    if not cfg["enabled"] or group is None or group.nranks <= 1:
        return None
    if x.dim() != 3:
        return None
    n = group.nranks
    b, s = int(x.shape[0]), int(x.shape[1])
    if not _divides(kind, b, s, n):
        return None
    compress = cfg["compress"] if x.is_floating_point() else None
    chunks = _resolve_chunks(cfg["chunks"])
    if kind in ("column_sp", "column", "column_gather"):
        o, k = int(weight.shape[0]) * n, int(weight.shape[1])
    else:
        o, k = int(weight.shape[0]), int(weight.shape[1]) * n
    out = _CMOverlap.apply(x, weight, kind, group, chunks, compress)
    _record(kind, n, b, s * n if kind == "column_sp" else s, k, o,
            x.element_size(), chunks, compress)
    return out
