"""The collective API on torch.distributed (counterpart of
paddle_tpu/distributed/collective.py).

The reference is single-controller: outside a trace a collective takes a
rank-major stacked array and returns one. Its per-process mode is the
contract kept here: one process per rank, each passes its own tensor and
gets its own result. Rank r's input is row r of the reference's stacked
input, and its output is row r of the reference's output.

Paddle's in-place contract holds: ``all_reduce``, ``reduce``,
``reduce_scatter``, ``broadcast``, ``scatter`` and ``recv`` write their
result into the tensor they were given and return it. With
``sync_op=False`` a call returns a task instead, and the result is in
place only after the caller's ``task.wait()``; nothing waits for the
caller.

Compressed wires (EQuARX, arxiv 2506.17615): ``all_reduce`` and
``reduce_scatter`` take ``compress="int8" | "bf16" | None`` and
``alltoall`` / ``alltoall_single`` take it for the activation exchange.
``None`` is the exact collective of the backend. The compressed bodies
are the reference's, staged as two stages of the wire:

- "int8": the block maxima of every rank's payload are MAX-reduced, so
  all ranks quantize each 256-value block with one shared scale
  (blockmax / 127, round half to even); the codes go through an int8
  ``all_to_all_single`` (the reduce-scatter's routing) and are summed in
  int32 at the receiver; one dequantization recovers the shard's sum.
  ``all_reduce`` then requantizes the reduced shard and all-gathers its
  int8 codes and float32 scales. |out - exact| <= (n * blockmax_in +
  blockmax_sum) / 254 per element; AVG divides the bound by n.
- "bf16": the payload is cast to bfloat16 for the wire, the receiver
  sums the n contributions in float32 and rounds once, and
  ``all_reduce`` all-gathers the bfloat16 shards: the reference's
  ``psum`` in bf16 as XLA computes it (float32 accumulation, one
  rounding).

Integer payloads and MAX/MIN/PROD reject compression.

Point to point: ``send``, ``recv``, ``isend``, ``irecv`` and
``batch_isend_irecv`` (and ``collective_permute`` on them) move a CUDA
tensor on a gloo group through a pinned host buffer, whose bytes and
calls ``p2p_host_staged`` counts: gloo's own send/recv read a CUDA
pointer as host memory. On NCCL, or for CPU tensors, nothing is staged.

DTensor's all-gathers (torch's functional ``all_gather_into_tensor``)
end a gloo rank with a segfault on CUDA tensors, where c10d's
``all_gather_into_tensor`` takes them (through host memory, as gloo's
collectives do). A rank that joins a gloo world on a card routes the
functional op's CUDA kernel to c10d's (``reroute_gloo_cuda_all_gather``,
counted by ``gloo_cuda_all_gathers``) until ``destroy_process_group``
gives torch's kernel back.
"""
from __future__ import annotations

import warnings

import torch
import torch.distributed as dist

from . import env as _env

# all_gather_into_tensor and reduce_scatter_tensor are the calls both the
# card's torch and later ones have; the later ones warn that they are
# deprecated
warnings.filterwarnings("ignore", category=FutureWarning,
                        message=r".*(all_gather_into_tensor|"
                                r"reduce_scatter_tensor).* is deprecated")

__all__ = [
    "ReduceOp", "Group", "new_group", "get_group", "destroy_process_group",
    "all_reduce", "all_gather", "all_gather_object", "reduce",
    "reduce_scatter", "broadcast", "scatter", "alltoall", "all_to_all",
    "alltoall_single", "send", "recv", "isend", "irecv", "batch_isend_irecv",
    "P2POp", "barrier", "wait", "stream", "collective_permute",
    "quantize_blockwise_int8", "dequantize_blockwise_int8", "encode_wire",
    "p2p_host_staged", "gloo_cuda_all_gathers", "reroute_gloo_cuda_all_gather",
    "restore_all_gather",
    "decode_wire", "wire_ppermute", "wire_all_to_all", "QUANT_BLOCK",
]


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT,
              ReduceOp.AVG: dist.ReduceOp.SUM}


class Group:
    """A set of global ranks and the torch ProcessGroup they communicate
    over. ``rank`` is this process's rank in the group (-1 if it is not a
    member). A one-rank group with no ProcessGroup (a trivial axis of the
    hybrid topology) runs every collective as a local copy."""

    _next_id = [0]

    def __init__(self, ranks, process_group=None, name=None,
                 explicit=False):
        self.ranks = [int(r) for r in ranks]
        self.process_group = process_group
        self.id = Group._next_id[0]
        Group._next_id[0] += 1
        self.name = name or f"group_{self.id}"
        # made by new_group(ranks=...): the reference's explicit-ranks
        # groups, which refuse the compressed wires
        self._explicit = bool(explicit)
        _GROUPS[self.id] = self

    @property
    def nranks(self):
        return len(self.ranks)

    world_size = nranks

    @property
    def rank(self):
        return self.get_group_rank(_env.get_rank())

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    def is_member(self):
        return self.rank >= 0

    @property
    def _local(self):
        return self.process_group is None and self.nranks == 1

    @property
    def _pg(self):
        return self.process_group

    def __repr__(self):
        return f"Group(ranks={self.ranks}, name={self.name!r})"


_GROUPS = {}
_WORLD = [None]


def _world_group():
    if not _env.is_initialized():
        raise RuntimeError("call paddle_tpu_torch.distributed."
                           "init_parallel_env() first")
    if _WORLD[0] is None:
        _WORLD[0] = Group(range(dist.get_world_size()), dist.group.WORLD,
                          name="world")
    return _WORLD[0]


def new_group(ranks=None, backend=None, timeout=None):
    """A group of ``ranks`` (global ranks; every rank of the world must
    make the same calls in the same order, members or not). ``None`` is
    the world."""
    if ranks is None:
        return _world_group()
    _world_group()
    ranks = sorted(int(r) for r in ranks)
    kw = {}
    if timeout is not None:
        import datetime
        kw["timeout"] = timeout if isinstance(timeout, datetime.timedelta) \
            else datetime.timedelta(seconds=float(timeout))
    pg = dist.new_group(ranks=ranks, backend=backend, **kw)
    return Group(ranks, pg, explicit=True)


def get_group(gid=0):
    if gid == 0 or gid not in _GROUPS:
        return _world_group()
    return _GROUPS[gid]


def destroy_process_group(group=None):
    if group is not None and group is not _WORLD[0]:
        if group.process_group not in (None, dist.group.WORLD):
            dist.destroy_process_group(group.process_group)
        _GROUPS.pop(group.id, None)
        return
    if _env.is_initialized():
        dist.destroy_process_group()
    _GROUPS.clear()
    _WORLD[0] = None
    restore_all_gather()
    _env._reset()


def _group_of(group):
    return group if group is not None else _world_group()


# ---------------------------------------------------------------------------
# tasks
# ---------------------------------------------------------------------------
class _Task:
    """What a collective with ``sync_op=False`` returns: ``wait()`` waits
    for the backend's work and then finishes the call (the AVG division,
    the copy into the caller's tensor); it returns the call's result."""

    def __init__(self, works=(), then=None, result=None):
        self._works = [w for w in works if w is not None]
        self._then = then
        self._result = result
        self._done = False

    def wait(self):
        if not self._done:
            for w in self._works:
                w.wait()
            if self._then is not None:
                self._then()
            self._done = True
        return self._result

    def is_completed(self):
        return self._done or all(w.is_completed() for w in self._works)


def _finish(works, then, result, sync_op):
    task = _Task(works if isinstance(works, (list, tuple)) else (works,),
                 then, result)
    if sync_op:
        return task.wait()
    return task


# ---------------------------------------------------------------------------
# the wire primitives every body runs on (a one-rank local group copies)
# ---------------------------------------------------------------------------
def _ar(t, op, g, async_op=False):
    """In-place all-reduce of ``t`` with a torch op."""
    if g._local:
        return None
    return dist.all_reduce(t, op=op, group=g._pg, async_op=async_op)


def _a2a(out, inp, g, async_op=False):
    """Equal-split all_to_all_single along dim 0 of flat buffers."""
    if g._local:
        out.copy_(inp)
        return None
    return dist.all_to_all_single(out, inp, group=g._pg, async_op=async_op)


def _ag(out, inp, g, async_op=False):
    """all_gather_into_tensor: ``out`` is n copies of ``inp``'s size."""
    if g._local:
        out.copy_(inp.reshape(out.shape))
        return None
    return dist.all_gather_into_tensor(out, inp.contiguous(), group=g._pg,
                                       async_op=async_op)


def _rs(out, inp, op, g, async_op=False):
    if g._local:
        out.copy_(inp.reshape(out.shape))
        return None
    return dist.reduce_scatter_tensor(out, inp.contiguous(), op=op,
                                      group=g._pg, async_op=async_op)


def _avg_div(red, n):
    """Dtype-preserving AVG: floor division for integers, as the
    reference's ``_avg_div``."""
    if red.is_floating_point():
        return red / torch.tensor(n, dtype=red.dtype, device=red.device)
    return torch.floor_divide(red, n)


# -- EQuARX-style block-quantized bodies (see module docstring) --------------
QUANT_BLOCK = 256


def quantize_blockwise_int8(flat, block=QUANT_BLOCK, shared_amax=None):
    """flat float32 [L], L % block == 0 -> (codes int8 [L], scales float32
    [L // block]). scale = blockmax / 127 (or the caller's shared block
    maxima: the cross-rank MAX-reduced EQuARX scale), computed as the
    reference's compiled bodies compute it: XLA folds the division by the
    constant 127 into a multiply by float32(1 / 127), which differs from
    the division in the last bit for about one block in twenty."""
    xb = flat.reshape(-1, block)
    amax = xb.abs().amax(dim=1) if shared_amax is None else shared_amax
    scale = torch.where(amax > 0, amax * (1.0 / 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(xb / scale[:, None]), -127.0, 127.0)
    return q.to(torch.int8).reshape(-1), scale


def dequantize_blockwise_int8(codes, scales, block=QUANT_BLOCK):
    return (codes.to(torch.float32).reshape(-1, block)
            * scales[:, None]).reshape(-1)


def _pad_flat(x, multiple):
    """ravel + zero-pad to a multiple; returns (flat float32, original
    length)."""
    flat = x.to(torch.float32).reshape(-1)
    L = flat.shape[0]
    pad = (-L) % multiple
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, L


def _q8_reduce_stage(rows, g, n):
    """The quantized reduce stage on per-destination rows: ``rows``
    float32 [n, P], row j this rank's contribution to rank j's shard, P a
    multiple of QUANT_BLOCK. Returns this rank's float32 reduced shard
    [P]. The scales are shared (MAX of the block maxima), so the int8
    codes add: the wire moves int8, the receiver sums the codes in int32
    and one dequantization gives the sum."""
    amax = rows.reshape(-1, QUANT_BLOCK).abs().amax(dim=1)
    _ar(amax, dist.ReduceOp.MAX, g)                 # shared EQuARX scale
    q, scale = quantize_blockwise_int8(rows.reshape(-1), shared_amax=amax)
    qmine = torch.empty_like(q)
    _a2a(qmine, q, g)                # row j of every peer lands here
    nb = scale.shape[0] // n
    smine = scale.reshape(n, nb)[g.rank]            # the group rank's rows
    acc = qmine.reshape(n, -1).to(torch.int32).sum(0, dtype=torch.int32)
    return dequantize_blockwise_int8(acc, smine)


def _q8_all_reduce(x, g, n):
    """Two-stage compressed all-reduce; returns float32, the caller
    casts."""
    flat, L = _pad_flat(x, n * QUANT_BLOCK)
    red = _q8_reduce_stage(flat.reshape(n, -1), g, n)
    q2, s2 = quantize_blockwise_int8(red)           # the gather stage
    gq = q2.new_empty(q2.numel() * n)
    gs = s2.new_empty(s2.numel() * n)
    _ag(gq, q2, g)
    _ag(gs, s2, g)
    return dequantize_blockwise_int8(gq, gs)[:L].reshape(x.shape)


def _bf16_reduce_stage(rows, g):
    """``rows`` [n, P] -> this rank's shard [P] of the sum, with bf16 on
    the wire, float32 accumulation and one rounding to bfloat16."""
    wire = rows.to(torch.bfloat16).contiguous().reshape(-1)
    recv = torch.empty_like(wire)
    _a2a(recv, wire, g)
    n = rows.shape[0]
    return recv.reshape(n, -1).to(torch.float32).sum(0).to(torch.bfloat16)


def _bf16_all_reduce(x, g, n):
    flat = x.reshape(-1)
    L = flat.shape[0]
    pad = (-L) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    red = _bf16_reduce_stage(flat.reshape(n, -1), g)
    out = red.new_empty(red.numel() * n)
    _ag(out, red, g)
    return out[:L].reshape(x.shape)


def _q8_all_to_all_wire(x, g, n, counters=None):
    """Block-quantized all_to_all for activation exchange: x [n, ...] with
    row d destined to rank d. Values are permuted, not summed, so the
    scales stay local per block and travel next to their codes (|err| <=
    blockmax / 254 per element)."""
    shape = x.shape
    rows = x.to(torch.float32).reshape(n, -1)
    L = rows.shape[1]
    pad = (-L) % QUANT_BLOCK
    if pad:
        rows = torch.cat([rows, rows.new_zeros(n, pad)], dim=1)
    q, s = quantize_blockwise_int8(rows.reshape(-1))
    qr, sr = torch.empty_like(q), torch.empty_like(s)
    _a2a(qr, q, g)
    _a2a(sr, s, g)
    _count_wire(counters, q, s)
    out = dequantize_blockwise_int8(qr, sr)
    return out.reshape(n, -1)[:, :L].reshape(shape).to(x.dtype)


def _count_wire(counters, *sent):
    """Add the bytes of the tensors handed to the exchange to
    ``counters["wire_bytes"]`` (when given)."""
    if counters is not None:
        counters["wire_bytes"] += sum(t.numel() * t.element_size()
                                      for t in sent)


def wire_all_to_all(x, group=None, compress=None, nranks=None,
                    counters=None):
    """Leading-axis all_to_all under the wire codec: bf16 halves the
    wire, int8 ships codes and per-256-value float32 scales, None is the
    exact exchange. ``counters`` (a dict) gets the bytes of the payload
    as encoded, the tensors the exchange sends, under "wire_bytes"."""
    g = _group_of(group)
    n = nranks or g.nranks
    if compress == "int8":
        return _q8_all_to_all_wire(x, g, n, counters)
    src = x.to(torch.bfloat16) if compress == "bf16" else x
    src = src.contiguous()
    out = torch.empty_like(src)
    _a2a(out.reshape(-1), src.reshape(-1), g)
    _count_wire(counters, src)
    return out.to(x.dtype)


def encode_wire(x, compress):
    """The payload's wire form under the activation codec: a tuple of
    tensors (bf16 cast; int8 codes + one float32 scale a block; None the
    identity)."""
    if compress == "bf16":
        return (x.to(torch.bfloat16),)
    if compress == "int8":
        flat, _ = _pad_flat(x, QUANT_BLOCK)
        return quantize_blockwise_int8(flat)
    return (x,)


def decode_wire(parts, compress, shape, dtype):
    """Inverse of encode_wire."""
    if compress == "bf16":
        return parts[0].to(dtype)
    if compress == "int8":
        n = 1
        for d in shape:
            n *= int(d)
        return dequantize_blockwise_int8(parts[0], parts[1])[:n] \
            .reshape(shape).to(dtype)
    return parts[0]


class _PostedPermute:
    """A permute in flight: ``wait()`` waits for its sends and receives
    and returns the parts this rank received (zeros where nobody sends to
    it). A received part may be read only after ``wait()``."""

    def __init__(self, tasks, outs):
        self._tasks = tasks
        self._outs = outs

    def wait(self):
        for task in self._tasks:
            task.wait()
        self._tasks = []
        return self._outs


def _post_permute(parts, perm, g, counters=None):
    """Post the move of each part from src to dst for every (src, dst)
    group-rank pair of ``perm`` and return without waiting. Every rank
    posts its sends and receives in the order of ``perm``, so all ranks
    of a ring post the same pairs in one order. ``counters`` (a dict)
    gets the bytes this rank sends, as encoded, under "wire_bytes"."""
    me = g.rank
    outs = [torch.zeros_like(p) for p in parts]
    if g._local:
        for s, d in perm:
            if s == d == 0:
                outs = [p.clone() for p in parts]
        return _PostedPermute([], outs)
    ops = []
    for s, d in perm:
        if s == me and d != me:
            ops += [(True, p, g.ranks[d], g) for p in parts]
            _count_wire(counters, *parts)
        if d == me and s != me:
            ops += [(False, o, g.ranks[s], g) for o in outs]
        if s == d == me:
            outs = [p.clone() for p in parts]
    return _PostedPermute(_post_p2p(ops) if ops else [], outs)


def _permute(parts, perm, g):
    """Move each part from src to dst for every (src, dst) group-rank
    pair of ``perm``; a rank nobody sends to gets zeros, as ppermute."""
    return _post_permute(parts, perm, g).wait()


def wire_ppermute(x, axis, perm, compress=None):
    """One collective-permute hop under the wire codec over the group
    ``axis`` (a Group; None is the world): pairs of group ranks (src,
    dst), the payload encoded once at the source."""
    g = _group_of(axis)
    parts = encode_wire(x, compress)
    moved = _permute(parts, [tuple(p) for p in perm], g)
    return decode_wire(tuple(moved), compress, x.shape, x.dtype)


# ---------------------------------------------------------------------------
# public API (paddle.distributed.*)
# ---------------------------------------------------------------------------
def _dtype_name(dt):
    return str(dt).replace("torch.", "")


def _check_compress(compress, op, data, g, api):
    """Honor-or-reject for the compressed paths: a silently exact fallback
    would hide that the wire is not compressed, and a silently lossy
    integer path would corrupt exact integer semantics."""
    if compress is None:
        return
    if compress not in ("int8", "bf16"):
        raise ValueError(
            f"{api}: compress must be 'int8', 'bf16' or None, "
            f"got {compress!r}")
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise ValueError(f"{api}: compress supports SUM/AVG only")
    if not data.is_floating_point():
        raise ValueError(
            f"{api}: compress={compress!r} needs a floating payload, "
            f"got {_dtype_name(data.dtype)} (integer reductions are exact "
            "by contract)")
    if g._explicit:
        raise NotImplementedError(
            f"{api}: compress over explicit-ranks groups; use mesh-axis "
            "groups")


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True,
               compress=None):
    """In place over ``group``. compress: None (exact), "bf16", or "int8"
    (the module docstring gives the error bound)."""
    g = _group_of(group)
    _check_compress(compress, op, tensor, g, "all_reduce")
    if not g.is_member():
        return tensor
    n = g.nranks
    if compress is not None:
        if compress == "int8":
            red = _q8_all_reduce(tensor, g, n)
        else:
            red = _bf16_all_reduce(tensor, g, n).to(tensor.dtype)
        if op == ReduceOp.AVG:
            red = _avg_div(red, n)
        red = red.to(tensor.dtype)
        return _finish((), lambda: tensor.copy_(red), tensor, sync_op)
    work = _ar(tensor, _TORCH_OPS[op], g, async_op=True)

    def then():
        if op == ReduceOp.AVG:
            tensor.copy_(_avg_div(tensor, n))
    return _finish(work, then, tensor, sync_op)


def all_gather(tensor_list, tensor, group=None, sync_op=True, axis=None):
    """Gather every rank's ``tensor``: into ``tensor_list`` (cleared, one
    tensor per rank) when it is a list, else returned stacked [n, ...]
    (or concatenated along ``axis``)."""
    g = _group_of(group)
    n = g.nranks
    src = tensor.contiguous()
    out = src.new_empty((n,) + tuple(src.shape))
    work = _ag(out.reshape(-1), src.reshape(-1), g, async_op=True)
    result = {}

    def then():
        parts = list(out.unbind(0))
        if isinstance(tensor_list, list):
            tensor_list.clear()
            tensor_list.extend(parts)
            result["r"] = tensor_list
        else:
            result["r"] = out if axis is None else torch.cat(parts, axis)
    task = _Task((work,), then)
    if sync_op:
        task.wait()
        return result["r"]
    if isinstance(tensor_list, list):
        task._result = tensor_list
    return task


def all_gather_object(object_list, obj, group=None):
    g = _group_of(group)
    gathered = [None] * g.nranks
    if g._local:
        gathered = [obj]
    else:
        dist.all_gather_object(gathered, obj, group=g._pg)
    object_list.clear()
    object_list.extend(gathered)
    return object_list


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce to global rank ``dst`` in place; other ranks keep their
    tensor."""
    g = _group_of(group)
    if not g.is_member():
        return tensor
    work = buf = None
    if g._local:
        buf = tensor.clone()
    else:
        buf = tensor.clone()
        work = dist.reduce(buf, dst, op=_TORCH_OPS[op], group=g._pg,
                           async_op=True)

    def then():
        if _env.get_rank() == dst:
            red = _avg_div(buf, g.nranks) if op == ReduceOp.AVG else buf
            tensor.copy_(red)
    return _finish(work, then, tensor, sync_op)


def reduce_scatter(tensor, tensor_list_or_input, op=ReduceOp.SUM,
                   group=None, sync_op=True, compress=None):
    """Rank r gets the reduction of every rank's r-th slice (dim 0 of the
    input, or the r-th tensor of a list) into ``tensor``. compress: None,
    "bf16" or "int8" (int8 ships codes and sums them in int32 at the
    receiver)."""
    g = _group_of(group)
    src = tensor_list_or_input
    if isinstance(src, (list, tuple)):
        src = torch.cat(list(src), dim=0)
    _check_compress(compress, op, src, g, "reduce_scatter")
    n = g.nranks
    if src.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 ({src.shape[0]}) is not a "
                         f"multiple of the group size {n}")
    m = src.shape[0] // n
    if compress is not None:
        rest = src[0].numel()
        if compress == "int8":
            rows = src.to(torch.float32).reshape(n, m * rest)
            pad = (-(m * rest)) % QUANT_BLOCK
            if pad:
                rows = torch.cat([rows, rows.new_zeros(n, pad)], dim=1)
            red = _q8_reduce_stage(rows, g, n)[:m * rest]
        else:
            red = _bf16_reduce_stage(src.reshape(n, m * rest), g)
        red = red.reshape((m,) + tuple(src.shape[1:])).to(src.dtype)
        if op == ReduceOp.AVG:
            red = _avg_div(red, n)
        return _finish((), lambda: tensor.copy_(red), tensor, sync_op)
    out = src.new_empty((m,) + tuple(src.shape[1:]))
    work = _rs(out, src, _TORCH_OPS[op], g, async_op=True)

    def then():
        tensor.copy_(_avg_div(out, n) if op == ReduceOp.AVG else out)
    return _finish(work, then, tensor, sync_op)


def broadcast(tensor, src=0, group=None, sync_op=True):
    """In place from global rank ``src``."""
    g = _group_of(group)
    if not g.is_member() or g._local:
        return _finish((), None, tensor, sync_op)
    work = dist.broadcast(tensor, src, group=g._pg, async_op=True)
    return _finish(work, None, tensor, sync_op)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank r of the group gets ``tensor_list[r]`` of global rank ``src``
    in place (only ``src`` needs the list)."""
    g = _group_of(group)
    if not g.is_member():
        return tensor
    me = _env.get_rank()
    if g._local:
        tensor.copy_(tensor_list[0])
        return _finish((), None, tensor, sync_op)
    parts = [t.contiguous() for t in tensor_list] if me == src else None
    work = dist.scatter(tensor, parts, src=src, group=g._pg, async_op=True)
    return _finish(work, None, tensor, sync_op)


def alltoall(in_tensor_list, out_tensor_list=None, group=None, sync_op=True,
             compress=None):
    """Rank r's i-th input goes to rank i, whose r-th output it becomes.
    compress: None, "bf16", or "int8" (codes + per-256-value scales,
    |err| <= blockmax / 254 per element)."""
    g = _group_of(group)
    if isinstance(in_tensor_list, (list, tuple)):
        x = torch.cat(list(in_tensor_list), dim=0)
        n = len(in_tensor_list)
    else:
        x = in_tensor_list
        n = g.nranks
    if compress is not None:
        _check_compress(compress, ReduceOp.SUM, x, g, "alltoall")
    out = wire_all_to_all(x, g, compress, g.nranks)
    if isinstance(out_tensor_list, list):
        out_tensor_list.clear()
        out_tensor_list.extend(out.chunk(n, dim=0))
        return _finish((), None, out_tensor_list, sync_op)
    return _finish((), None, out, sync_op)


all_to_all = alltoall


def alltoall_single(in_tensor, out_tensor=None, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True,
                    compress=None):
    """all_to_all over dim 0 of one tensor; equal splits unless split
    sizes are given (exact wire only)."""
    g = _group_of(group)
    if compress is not None:
        _check_compress(compress, ReduceOp.SUM, in_tensor, g,
                        "alltoall_single")
        if in_split_sizes is not None or out_split_sizes is not None:
            raise NotImplementedError(
                "alltoall_single: compress with split sizes; the "
                "compressed wire exchanges equal splits")
        out = wire_all_to_all(in_tensor, g, compress, g.nranks)
        if out_tensor is not None:
            return _finish((), lambda: out_tensor.copy_(out), out_tensor,
                           sync_op)
        return _finish((), None, out, sync_op)
    if out_tensor is None:
        rows = sum(out_split_sizes) if out_split_sizes is not None \
            else in_tensor.shape[0]
        out_tensor = in_tensor.new_empty((rows,) + tuple(in_tensor.shape[1:]))
    if g._local:
        out_tensor.copy_(in_tensor)
        return _finish((), None, out_tensor, sync_op)
    work = dist.all_to_all_single(
        out_tensor, in_tensor.contiguous(),
        output_split_sizes=out_split_sizes,
        input_split_sizes=in_split_sizes, group=g._pg, async_op=True)
    return _finish(work, None, out_tensor, sync_op)


def collective_permute(tensor, perm, group=None):
    """Each (src, dst) pair of group ranks moves ``tensor`` from src to
    dst; returns what this rank received (zeros if nothing)."""
    return _permute((tensor,), [tuple(p) for p in perm],
                    _group_of(group))[0]


# -- DTensor's all-gather on gloo and CUDA -------------------------------------
gloo_cuda_all_gathers = {"bytes": 0, "calls": 0}
_REROUTED = []


def _c10d_all_gather(inp, group_size, group_name):
    """torch's functional all_gather_into_tensor by c10d's call on the
    group it names: [group_size * d0, ...], rank-major."""
    from torch._C._distributed_c10d import _resolve_process_group
    pg = _resolve_process_group(group_name)
    out = inp.new_empty((inp.shape[0] * group_size,) + tuple(inp.shape[1:]))
    dist.all_gather_into_tensor(out, inp.contiguous(), group=pg)
    gloo_cuda_all_gathers["bytes"] += out.numel() * out.element_size()
    gloo_cuda_all_gathers["calls"] += 1
    return out


def _c10d_all_gather_coalesced(inputs, group_size, group_name):
    return [_c10d_all_gather(t, group_size, group_name) for t in inputs]


def reroute_gloo_cuda_all_gather():
    """Route the CUDA kernels of torch's functional all-gathers (which
    DTensor's redistributions call) to c10d's all_gather_into_tensor, in
    this process, until ``restore_all_gather`` (destroy_process_group
    calls it). For a rank of a gloo world on a card; c10d's call serves
    any backend, so a group of another world gathers right meanwhile."""
    if _REROUTED:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    with warnings.catch_warnings():
        # torch warns that a registered kernel is overridden
        warnings.simplefilter("ignore")
        lib.impl("all_gather_into_tensor", _c10d_all_gather, "CUDA")
        lib.impl("all_gather_into_tensor_coalesced",
                 _c10d_all_gather_coalesced, "CUDA")
    _REROUTED.append(lib)


def restore_all_gather():
    """Give the functional all-gathers torch's own CUDA kernels back."""
    while _REROUTED:
        _REROUTED.pop()._destroy()


# -- p2p ----------------------------------------------------------------------
# gloo's send and recv read a CUDA tensor's pointer as host memory and
# abort, where its collectives copy through the host themselves. On a gloo
# group the p2p calls therefore move a CUDA tensor through a pinned host
# buffer of their own: the send copies it there (waiting for the work that
# produced it) and sends the copy; the receive lands in one and copies it
# to the caller's tensor when the caller waits. Each staged transfer adds
# its bytes and one call to ``p2p_host_staged``. On NCCL (and for CPU
# tensors) a tensor goes as it is and the counter does not move. The
# backend is the one the world was joined on: nothing here picks gloo.
p2p_host_staged = {"bytes": 0, "calls": 0}


def _staged(t, g):
    """Whether ``t`` travels through host memory on ``g``."""
    return t.is_cuda and dist.get_backend(g._pg) == "gloo"


def _post_p2p(ops):
    """Post [(is_send, tensor, peer global rank, group)] as one batch;
    returns one _Task per op, in order. A staged receive's task copies
    the host buffer into the tensor on wait()."""
    posted, thens, keep = [], [], []
    for is_send, t, peer, g in ops:
        buf, then = t, None
        if _staged(t, g):
            p2p_host_staged["bytes"] += t.numel() * t.element_size()
            p2p_host_staged["calls"] += 1
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            if is_send:
                buf.copy_(t)              # waits for t's producers
            else:
                then = (lambda t=t, buf=buf: t.copy_(buf, non_blocking=True))
        elif is_send:
            buf = t.contiguous()
        fn = dist.isend if is_send else dist.irecv
        posted.append(dist.P2POp(fn, buf, peer, g._pg))
        thens.append(then)
        keep.append(buf)
    works = dist.batch_isend_irecv(posted)
    return [_Task((w,), then, result=buf)
            for w, then, buf in zip(works, thens, keep)]


class P2POp:
    def __init__(self, op, tensor, peer, group=None):
        self.op = op  # send / isend / recv / irecv
        self.tensor = tensor
        self.peer = peer
        self.group = group


def send(tensor, dst=0, group=None, sync_op=True):
    """Point-to-point send to global rank ``dst`` (through host memory for
    a CUDA tensor on a gloo group: see ``p2p_host_staged``)."""
    task = _post_p2p([(True, tensor, dst, _group_of(group))])[0]
    task._result = None
    if sync_op:
        task.wait()
        return _Task()
    return task


def recv(tensor, src=0, group=None, sync_op=True):
    """Point-to-point receive from global rank ``src`` into ``tensor``."""
    task = _post_p2p([(False, tensor, src, _group_of(group))])[0]
    task._result = tensor
    if sync_op:
        task.wait()
        return _Task(result=tensor)
    return task


def isend(tensor, dst=0, group=None):
    """Asynchronous send: the caller waits on the returned task."""
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor, src=0, group=None):
    """Asynchronous receive: the tensor holds the data after the
    returned task's wait()."""
    return recv(tensor, src, group, sync_op=False)


def batch_isend_irecv(p2p_op_list):
    """The pipeline's p2p entry: every send and receive of the batch is
    posted at once; returns one task per op (wait on each). CUDA tensors
    on a gloo group go through host memory, as ``send`` and ``recv``."""
    if not p2p_op_list:
        return []
    tasks = _post_p2p([(op.op in (send, isend), op.tensor, op.peer,
                        _group_of(op.group)) for op in p2p_op_list])
    for op, task in zip(p2p_op_list, tasks):
        task._result = None if op.op in (send, isend) else op.tensor
    return tasks


def barrier(group=None):
    g = _group_of(group)
    if g._local or not g.is_member():
        return
    kw = {}
    if dist.get_backend(g._pg) == "nccl":
        kw["device_ids"] = [torch.cuda.current_device()]
    dist.barrier(group=g._pg, **kw)


def wait(tensor, group=None, use_calc_stream=True):
    """Block until the work queued on ``tensor``'s device is done."""
    if tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()


class _StreamNS:
    """paddle.distributed.stream.*: the same calls; pass sync_op=False for
    a task."""

    all_reduce = staticmethod(all_reduce)
    all_gather = staticmethod(all_gather)
    reduce_scatter = staticmethod(reduce_scatter)
    broadcast = staticmethod(broadcast)
    alltoall = staticmethod(alltoall)
    alltoall_single = staticmethod(alltoall_single)
    scatter = staticmethod(scatter)
    reduce = staticmethod(reduce)
    send = staticmethod(send)
    recv = staticmethod(recv)


stream = _StreamNS()
