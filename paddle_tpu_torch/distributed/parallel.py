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
sum.
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


def sync_params_buffers(layers, group, only=None):
    """Broadcast ``layers``' parameters and buffers from ``group``'s first
    rank (``only`` filters the parameters: a predicate on a parameter)."""
    if group is None or group.nranks == 1:
        return
    src = group.ranks[0]
    with torch.no_grad():
        for p in layers.parameters():
            if only is None or only(p):
                broadcast(p.data, src=src, group=group)
        if only is None:
            for b in layers.buffers():
                broadcast(b, src=src, group=group)


class _SyncedLayers(nn.Module):
    """A wrapped model whose gradients a GradBucketScheduler syncs over a
    group (DataParallel; TensorParallel over its dp group)."""

    def __init__(self, layers, group, bucket_mb):
        super().__init__()
        from .fleet.grad_buckets import GradBucketScheduler
        self._layers = layers
        self.group = group
        self._grad_sync = None
        self._install_grad_sync(GradBucketScheduler(
            list(layers.named_parameters()), bucket_mb=bucket_mb,
            group=group))

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
                 group=None):
        g = _group_of(group)
        sync_params_buffers(layers, g)
        super().__init__(layers, g, comm_buffer_size)
        self.find_unused_parameters = find_unused_parameters
