"""init_parallel_env and DataParallel (counterpart of
paddle_tpu/distributed/parallel.py).

``DataParallel`` keeps a replica of the model on each rank of its group:
at wrap time every parameter and buffer is broadcast from the group's
first rank, so replicas that were built apart start equal, and during
backward the bucket scheduler of fleet/grad_buckets.py averages the
gradients over the group, one bucket at a time as backward finishes it
(torch's DistributedDataParallel is not used: the buckets, the codecs and
the counters are the reference's). ``no_sync()`` defers the sync: the
gradients accumulate locally and the next synced backward averages the
sum. With ``expert_group`` (fleet's expert replicas, under expert
parallelism) the parameters marked ``expert`` are broadcast and summed
over that group instead, and divided by the size of ``group`` (the data
world): grad_buckets.py says why.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from .collective import _group_of, broadcast
from .env import ParallelEnv, init_distributed_runtime

__all__ = ["init_parallel_env", "DataParallel", "ParallelEnv"]


def init_parallel_env(backend=None, device=None):
    """Join this rank into the world (env.py: the rendezvous and the
    backend rule) and return its ParallelEnv."""
    return init_distributed_runtime(backend=backend, device=device)


def sync_params_buffers(layers, group, only=None, expert_group=None):
    """Broadcast ``layers``' parameters and buffers from ``group``'s first
    rank (``only`` filters the parameters: a predicate on a parameter).
    With ``expert_group``, the parameters marked ``expert`` are broadcast
    over that group instead."""
    if expert_group is not None:
        sync_params_buffers(layers, expert_group,
                            lambda p: getattr(p, "expert", False))
        keep = only or (lambda p: True)
        only = (lambda p: keep(p) and not getattr(p, "expert", False))
        _broadcast_buffers(layers, group)
    if group is None or group.nranks == 1:
        return
    src = group.ranks[0]
    with torch.no_grad():
        for p in layers.parameters():
            if only is None or only(p):
                broadcast(p.data, src=src, group=group)
    if only is None:
        _broadcast_buffers(layers, group)


def _broadcast_buffers(layers, group):
    if group is None or group.nranks == 1:
        return
    with torch.no_grad():
        for b in layers.buffers():
            broadcast(b, src=group.ranks[0], group=group)


class _SyncedLayers(nn.Module):
    """A wrapped model whose gradients a GradBucketScheduler syncs over a
    group (DataParallel; TensorParallel over its dp group)."""

    def __init__(self, layers, group, bucket_mb, expert_group=None):
        super().__init__()
        from .fleet.grad_buckets import GradBucketScheduler
        self._layers = layers
        self.group = group
        self.expert_group = expert_group
        self._grad_sync = None
        self._install_grad_sync(GradBucketScheduler(
            list(layers.named_parameters()), bucket_mb=bucket_mb,
            group=group, expert_group=expert_group))

    def _install_grad_sync(self, sched):
        """Sync through ``sched`` from now on (TrainStep hands over the
        scheduler its grad_sync or fleet's strategy asks for)."""
        if self._grad_sync is not None and self._grad_sync is not sched:
            self._grad_sync.detach()
        self._grad_sync = sched
        sched.attach(list(self._layers.named_parameters()))

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    @contextlib.contextmanager
    def no_sync(self):
        with self._grad_sync.disarmed():
            yield

    def scale_loss(self, loss):
        return loss

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    load_state_dict = set_state_dict

    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def named_parameters(self, prefix="", include_sublayers=True):
        return self._layers.named_parameters(prefix, include_sublayers)


class DataParallel(_SyncedLayers):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None, expert_group=None):
        g = _group_of(group)
        sync_params_buffers(layers, g, expert_group=expert_group)
        super().__init__(layers, g, comm_buffer_size, expert_group)
        self.find_unused_parameters = find_unused_parameters
