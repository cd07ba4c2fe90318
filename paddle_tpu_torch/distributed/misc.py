"""The rest of paddle.distributed a training job uses (counterpart of
paddle_tpu/distributed/misc.py): ``spawn``, ``gather``, the object-list
collectives, ``ParallelMode``, ``ReduceType``, ``is_available``,
``get_backend``, auto-parallel's ``ShardingStage1/2/3`` markers and
``shard_scaler``. ``split`` and the parameter-server entries are not
ported and raise.
"""
from __future__ import annotations

import os
import socket
import time

import torch
import torch.distributed as dist

__all__ = ["gather", "scatter_object_list", "broadcast_object_list",
           "spawn", "ParallelMode", "ReduceType", "is_available",
           "get_backend", "split", "CountFilterEntry", "ShowClickEntry",
           "ProbabilityEntry", "ShardingStage1", "ShardingStage2",
           "ShardingStage3", "shard_scaler"]


class ParallelMode:
    """reference: distributed/parallel.py ParallelMode."""
    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3


class ReduceType:
    """reference: auto_parallel Partial reduce types."""
    kRedSum = 0
    kRedMax = 1
    kRedMin = 2
    kRedProd = 3
    kRedAvg = 4
    kRedAny = 5
    kRedAll = 6


class ShardingStage1:
    """Marker for shard_optimizer (reference:
    distributed/auto_parallel/api.py ShardingStage1). It has no
    ``__call__``, in the reference too, where shard_optimizer takes it and
    fails at the first step; the port's shard_optimizer raises
    NotImplementedError when it is passed."""

    def __init__(self, axis_name="dp", mesh=None):
        self.axis_name = axis_name
        self.mesh = mesh


class ShardingStage2(ShardingStage1):
    pass


class ShardingStage3(ShardingStage1):
    pass


def shard_scaler(scaler):
    """reference: auto_parallel/api.py shard_scaler. The port's GradScaler
    is not ported; the scaler is returned as it is, as the reference
    returns it."""
    return scaler


def is_available():
    """Whether this torch has torch.distributed."""
    return dist.is_available()


def get_backend(group=None):
    """The backend of ``group`` (default the world): "NCCL" or "GLOO"."""
    from .collective import _group_of
    g = _group_of(group)
    if g._local:
        return dist.get_backend().upper()
    return dist.get_backend(g._pg).upper()


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """Every rank's ``tensor`` in rank order. As in the reference, every
    rank (not only ``dst``) gets the gathered list."""
    from .collective import all_gather
    out = []
    all_gather(out, tensor, group=group)
    if gather_list is not None:
        gather_list.clear()
        gather_list.extend(out)
    return gather_list if gather_list is not None else out


def broadcast_object_list(object_list, src=0, group=None):
    """In place: every rank's ``object_list`` becomes global rank
    ``src``'s (the lists have one length on every rank)."""
    from .collective import _group_of
    g = _group_of(group)
    if not g._local:
        dist.broadcast_object_list(object_list, src=src, group=g._pg)
    return object_list


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    """Rank r of the group gets slice r of ``src``'s ``in_object_list``
    (len(in_object_list) // nranks objects each)."""
    from .collective import _group_of
    g = _group_of(group)
    box = [in_object_list]
    if not g._local:
        dist.broadcast_object_list(box, src=src, group=g._pg)
    objs = box[0]
    if objs is None:
        raise ValueError("in_object_list required on src")
    per = max(len(objs) // g.nranks, 1)
    r = g.rank
    out_object_list.clear()
    out_object_list.extend(objs[r * per:(r + 1) * per])
    return out_object_list


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_entry(func, args, env):
    os.environ.update(env)
    func(*args)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Start ``nprocs`` processes (start method ``spawn``), each running
    ``func(*args)`` with the env contract of its rank (env.py). Options:
    ``master`` (the rendezvous, "host:port" or "file://path"; default
    127.0.0.1 and a free port), ``gpus`` (one card id a rank, as a list or
    "0,0"; default rank % cards), ``timeout`` (seconds the join waits
    before it ends every rank and raises; default none). ``nprocs=-1``
    is one rank a card. With ``join`` the call raises if a rank fails,
    after ending the others; it returns the processes."""
    if nprocs == -1:
        nprocs = torch.cuda.device_count()
        if nprocs == 0:
            raise ValueError("spawn(nprocs=-1) starts one rank a card, and "
                             "no card is visible; give nprocs")
    master = options.get("master") or f"127.0.0.1:{_free_port()}"
    gpus = options.get("gpus")
    if isinstance(gpus, str):
        gpus = [int(g) for g in gpus.split(",")]
    if gpus is None:
        ncard = max(torch.cuda.device_count(), 1)
        gpus = [r % ncard for r in range(nprocs)]
    if len(gpus) != nprocs:
        raise ValueError(f"gpus names {len(gpus)} cards for {nprocs} ranks")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = []
    for rank in range(nprocs):
        env = {"PADDLE_TRAINER_ID": str(rank),
               "PADDLE_TRAINERS_NUM": str(nprocs),
               "PADDLE_MASTER": master,
               "FLAGS_selected_gpus": str(gpus[rank])}
        p = ctx.Process(target=_spawn_entry, args=(func, args, env),
                        daemon=daemon)
        p.start()
        procs.append(p)
    if join:
        join_all(procs, options.get("timeout"))
    return procs


def join_all(procs, timeout=None):
    """Join ``procs``; if one fails or the time runs out, end the rest and
    raise RuntimeError naming the exit codes."""
    deadline = None if timeout is None else time.monotonic() + timeout
    while any(p.is_alive() for p in procs):
        if any(p.exitcode not in (None, 0) for p in procs):
            break
        if deadline is not None and time.monotonic() > deadline:
            break
        time.sleep(0.05)
    late = [p for p in procs if p.is_alive()]
    for p in late:
        p.terminate()
    for p in procs:
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if late or any(c != 0 for c in codes):
        raise RuntimeError(
            f"spawned ranks failed: exit codes {codes}"
            + (f" ({len(late)} still running after {timeout} s, ended)"
               if late and deadline is not None
               and time.monotonic() > deadline else ""))


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    raise NotImplementedError(
        "paddle.distributed.split is not ported to the PyTorch package "
        "yet; build ColumnParallelLinear / RowParallelLinear / "
        "VocabParallelEmbedding from fleet.meta_parallel directly")


class _PSEntry:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__}: the parameter-server entries are not "
            f"ported to the PyTorch package")


class ProbabilityEntry(_PSEntry):
    pass


class CountFilterEntry(_PSEntry):
    pass


class ShowClickEntry(_PSEntry):
    pass
