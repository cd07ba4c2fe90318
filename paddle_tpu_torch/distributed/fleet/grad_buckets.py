"""Gradient buckets: the bucketed, optionally compressed gradient sync of
data parallelism (counterpart of paddle_tpu/distributed/fleet/
grad_buckets.py).

Parameters are partitioned into ~``bucket_mb`` MiB buckets in reverse
registration order, the order in which backward finishes their gradients
(the reference's ``partition_buckets``). Here the sync runs on eager
hooks: each parameter gets a ``register_post_accumulate_grad_hook``, and
when the last gradient of a bucket has landed the bucket is flattened
into one vector and synced by one collective over the group, while
backward goes on with earlier layers:

- exact: one ``all_reduce`` of the bucket, launched asynchronously;
- ``compress="bf16"`` or ``"int8"``: the compressed all-reduce bodies of
  distributed/collective.py on the bucket's vector.

The gradients are averaged (AVG over the group, the data-parallel
contract). At the end of the backward (an autograd engine callback) any
bucket whose gradients have not all arrived (parameters that the loss did
not reach) is synced with the ones that did, every launched sync is
waited for, and the averaged values are written back into ``.grad``:
when ``backward()`` returns, the gradients are the group's mean. A
parameter used twice (GPT-2's tied embedding and head) accumulates both
uses before its hook fires once.

Under expert parallelism (``expert_group``) the expert parameters (those
marked ``expert``) sit in buckets of their own, summed over the expert
replicas (the ranks that hold the same experts) and divided by the size
of the whole group: each rank's loss is the mean over its own rows, and
the backward exchange has already brought every rank of the expert group
its experts' share.

A trivial group (one rank) syncs nothing, as the reference's
``_axis_active`` makes it: no hook is registered. ``bytes_per_step`` and
``wire_bytes_per_step`` are the reference's numbers, and ``counters``
holds the reference's four telemetry totals (bucket flushes, logical
bytes, wire bytes, seconds in flushes).
"""
from __future__ import annotations

import contextlib
import math
import time
import weakref

import torch

from ..collective import QUANT_BLOCK as _QBLOCK

__all__ = ["GradBucket", "GradBucketScheduler", "partition_buckets",
           "wire_bytes", "DEFAULT_BUCKET_MB"]

# matches the reference DistributedStrategy.fuse_grad_size_in_MB default
DEFAULT_BUCKET_MB = 32


def _dtype(d):
    """A torch dtype from a torch dtype or its name ("float32")."""
    return d if isinstance(d, torch.dtype) else getattr(torch, str(d))


def _itemsize(d):
    return torch.empty((), dtype=_dtype(d)).element_size()


def _numel(shape):
    return int(math.prod(shape))


def wire_bytes(nbytes_logical, compress, stages=1, itemsize=4):
    """Wire bytes the payload occupies per reduce stage: int8 = 1 byte a
    value + one float32 scale per 256-value block; bf16 = 2 bytes a value
    (no saving for bf16 gradients); None = the logical bytes. ``stages=2``
    prices a two-stage all-reduce."""
    values = nbytes_logical // max(int(itemsize), 1)
    if compress == "bf16":
        return min(nbytes_logical, 2 * values) * stages
    if compress == "int8":
        per_stage = values + 4 * ((values + _QBLOCK - 1) // _QBLOCK)
        return per_stage * stages
    return nbytes_logical * stages


class GradBucket:
    """One sync unit: an ordered list of (name, shape, dtype) and its byte
    totals; the scheduler sets the group it sums over and the divisor."""

    def __init__(self, index, entries):
        self.index = index
        self.group = None
        self.div = None
        self.names = [e[0] for e in entries]
        self.shapes = {e[0]: tuple(e[1]) for e in entries}
        self.dtypes = {e[0]: e[2] for e in entries}
        self.nbytes = sum(_numel(e[1]) * _itemsize(e[2]) for e in entries)

    def wire(self, compress):
        """Wire bytes of this bucket under ``compress``, each entry priced
        at its own dtype's width."""
        return sum(
            wire_bytes(_numel(self.shapes[n]) * _itemsize(self.dtypes[n]),
                       compress, itemsize=_itemsize(self.dtypes[n]))
            for n in self.names)

    def __repr__(self):
        return (f"GradBucket({self.index}, params={len(self.names)}, "
                f"{self.nbytes / 2**20:.2f} MiB)")


def partition_buckets(named_shapes, bucket_mb=DEFAULT_BUCKET_MB):
    """[(name, shape, dtype)] in forward registration order ->
    [GradBucket] in reverse-backward order: the last registered parameters
    land in bucket 0. A bucket closes when it reaches ~bucket_mb MiB; a
    single oversized parameter is a bucket of its own (never split)."""
    limit = float(bucket_mb) * 2**20
    buckets, cur, cur_bytes = [], [], 0.0
    for name, shape, dtype in reversed(list(named_shapes)):
        nb = _numel(shape) * _itemsize(dtype)
        if cur and cur_bytes + nb > limit:
            buckets.append(GradBucket(len(buckets), cur))
            cur, cur_bytes = [], 0.0
        cur.append((name, shape, dtype))
        cur_bytes += nb
    if cur:
        buckets.append(GradBucket(len(buckets), cur))
    return buckets


def _entry(name, t):
    return (name, tuple(t.shape), str(t.dtype).replace("torch.", ""))


def _default_group(axis):
    """The group an axis name syncs over: fleet's hybrid group for that
    axis when fleet is initialized, else the world; None when there is no
    world."""
    from .. import env
    if not env.is_initialized():
        return None
    from .fleet import fleet
    hcg = fleet.get_hybrid_communicate_group()
    if hcg is not None:
        return hcg.get_axis_group(axis)
    from ..collective import _world_group
    return _world_group()


class GradBucketScheduler:
    """The bucket partition and its sync.

    named_params: (name, shape, dtype) triples in forward registration
        order, or a dict / list of (name, tensor).
    bucket_mb: MiB a bucket. ("auto", the reference's autotune cache,
        is not ported and raises.)
    compress: None | "int8" | "bf16".
    axis: the hybrid axis the sync rides ("dp"); ``group`` (the port's
        trailing keyword) names the group directly.
    """

    def __init__(self, named_params, bucket_mb=DEFAULT_BUCKET_MB,
                 compress=None, axis="dp", mesh=None, group=None,
                 expert_group=None):
        if bucket_mb == "auto":
            raise NotImplementedError(
                "GradBucketScheduler(bucket_mb='auto'): the grad-bucket "
                "autotune cache is not ported to the PyTorch package yet; "
                "give a size in MiB")
        if mesh is not None:
            raise NotImplementedError(
                "GradBucketScheduler(mesh=...): the port syncs over a "
                "process group; pass group= (or none for the axis' group)")
        if compress not in (None, "int8", "bf16"):
            raise ValueError(f"compress must be None, 'int8' or 'bf16', got "
                             f"{compress!r}")
        if isinstance(named_params, dict):
            named_params = list(named_params.items())
        entries = [e if len(e) == 3 else _entry(*e) for e in named_params]
        # only floating leaves sync (integer buffers have no gradients)
        self.entries = [e for e in entries if _dtype(e[2]).is_floating_point]
        self.bucket_mb = float(bucket_mb)
        self.compress = compress
        self.axis = axis
        self.group = group if group is not None else _default_group(axis)
        self.expert_group = expert_group
        experts = set() if expert_group is None else {
            e[0] for e in named_params
            if len(e) == 2 and getattr(e[1], "expert", False)}
        dense = [e for e in self.entries if e[0] not in experts]
        self.buckets = partition_buckets(dense, self.bucket_mb)
        div = self.group.nranks if self.group is not None else 1
        for b in self.buckets:
            b.group, b.div = self.group, div
        for b in partition_buckets([e for e in self.entries
                                    if e[0] in experts], self.bucket_mb):
            b.index = len(self.buckets)
            b.group, b.div = expert_group, div
            self.buckets.append(b)
        self._bucket_of = {n: b for b in self.buckets for n in b.names}
        self.bytes_per_step = sum(b.nbytes for b in self.buckets)
        self.wire_bytes_per_step = sum(b.wire(compress) for b in self.buckets)
        self.counters = {"grad_sync_buckets_total": 0,
                         "grad_sync_bytes_total": 0,
                         "grad_sync_compressed_bytes_total": 0,
                         "grad_sync_seconds_total": 0.0}
        self.armed = True
        self._params = {}
        self._handles = []
        self._seen = {}
        self._pending = []
        self._queued = False

    def _axis_active(self):
        """A one-rank group means no collective: the scheduler is inert."""
        return self.group is not None and self.group.nranks > 1

    # -- hooks ---------------------------------------------------------------
    def attach(self, named_params):
        """Register the post-accumulate-grad hook on each bucketed
        parameter of ``named_params`` ((name, parameter) pairs); none on a
        trivial group."""
        self.detach()
        self._params = {n: p for n, p in named_params
                        if n in self._bucket_of and p.requires_grad}
        if not self._axis_active():
            return self
        # the hooks hold the scheduler weakly: a parameter's hook holding
        # it strongly would keep it, its model and its buffers alive after
        # the caller lets them go
        me = weakref.ref(self)

        def hook(p, name):
            sched = me()
            if sched is not None:
                sched._on_grad(name)
        for name, p in self._params.items():
            self._handles.append(p.register_post_accumulate_grad_hook(
                lambda p, name=name: hook(p, name)))
        return self

    def detach(self):
        for h in self._handles:
            h.remove()
        self._handles = []
        self._params = {}

    @contextlib.contextmanager
    def disarmed(self):
        """Hooks fire but sync nothing (DataParallel.no_sync, the
        microbatches of an accumulating step)."""
        armed, self.armed = self.armed, False
        try:
            yield
        finally:
            self.armed = armed

    def _on_grad(self, name):
        if not self.armed:
            return
        if not self._queued:
            torch.autograd.Variable._execution_engine.queue_callback(
                self._finalize)
            self._queued = True
        b = self._bucket_of[name]
        seen = self._seen.setdefault(b.index, set())
        seen.add(name)
        if seen == set(n for n in b.names if n in self._params):
            self._flush(b, [n for n in b.names if n in seen])

    def _finalize(self):
        """End of backward: sync the partial buckets, wait for every
        sync, write the means back."""
        for b in self.buckets:
            seen = self._seen.get(b.index)
            if seen:
                self._flush(b, [n for n in b.names if n in seen])
        self._drain()
        self._queued = False

    def _flush(self, b, names):
        self._seen.pop(b.index, None)
        grads = [self._params[n].grad for n in names]
        self._pending.append(self._launch(b, grads))

    def _drain(self):
        pending, self._pending = self._pending, []
        for finish in pending:
            finish()

    # -- the sync ------------------------------------------------------------
    def _launch(self, b, grads):
        """Start one bucket's sync; returns the callable that waits for it
        and writes the group's mean into ``grads``."""
        from ..collective import ReduceOp, _avg_div, all_reduce
        t0 = time.perf_counter()
        dts = {g.dtype for g in grads}
        flat_dt = dts.pop() if len(dts) == 1 else torch.float32
        flat = torch.cat([g.reshape(-1).to(flat_dt) for g in grads])
        n = b.div
        if self.compress is None:
            task = all_reduce(flat, group=b.group, sync_op=False)
        elif n == b.group.nranks:
            all_reduce(flat, op=ReduceOp.AVG, group=b.group,
                       compress=self.compress)
            task = None
        else:
            all_reduce(flat, op=ReduceOp.SUM, group=b.group,
                       compress=self.compress)
            flat = _avg_div(flat, n)
            task = None

        def finish():
            out = flat
            if task is not None:
                task.wait()
                out = _avg_div(flat, n)
            off = 0
            for g in grads:
                g.copy_(out[off:off + g.numel()].view_as(g))
                off += g.numel()
            self._note_flush(b, time.perf_counter() - t0)
        return finish

    def sync_grads(self, grads):
        """Sync a {name: gradient} dict in place outside autograd (the
        accumulated gradients of a multi-microbatch step, once); returns
        it. A trivial group leaves it as it is."""
        if not self._axis_active():
            return grads
        for b in self.buckets:
            names = [n for n in b.names if grads.get(n) is not None]
            if names:
                self._pending.append(self._launch(b, [grads[n]
                                                      for n in names]))
        self._drain()
        return grads

    def _note_flush(self, b, seconds):
        c = self.counters
        c["grad_sync_buckets_total"] += 1
        c["grad_sync_bytes_total"] += b.nbytes
        c["grad_sync_compressed_bytes_total"] += b.wire(self.compress)
        c["grad_sync_seconds_total"] += seconds
