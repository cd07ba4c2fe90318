"""The distributed environment (counterpart of paddle_tpu/distributed/env.py).

One process per rank. A launcher (``distributed.spawn`` or any other)
sets the reference's contract in each rank's environment:
``PADDLE_TRAINER_ID`` (the rank), ``PADDLE_TRAINERS_NUM`` (the world
size), ``PADDLE_MASTER`` (``host:port`` of the rank-0 store, or
``file://<path>`` for a FileStore on a shared disk) and
``FLAGS_selected_gpus`` (the card of the rank). ``PADDLE_COMM_TIMEOUT``
bounds the rendezvous and every collective, in seconds (default 600), so
a rank that never arrives fails the others instead of hanging them.

``init_distributed_runtime`` joins the world on ``torch.distributed``:
NCCL when the rank's device is a card, gloo on ``device="cpu"`` or when
the caller asks for ``backend="gloo"``. Nothing is chosen behind the
caller's back: a card with no NCCL raises.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..framework.device import resolve_device

__all__ = ["ParallelEnv", "get_rank", "get_world_size", "is_initialized",
           "init_distributed_runtime", "world_device_type"]

# the rank's TCPStore (its server lives in rank 0's process)
_STORE = [None]
# the device type the rank joined the world on ("cuda" or "cpu")
_DEVICE_TYPE = [None]


class ParallelEnv:
    """Reads the launcher's env contract (PADDLE_TRAINER_ID & co)."""

    def __init__(self):
        self._rank = int(os.getenv("PADDLE_TRAINER_ID", "0"))
        self._world_size = int(os.getenv("PADDLE_TRAINERS_NUM", "1"))
        self._device_id = int(os.getenv("FLAGS_selected_gpus", "0"))
        self._current_endpoint = os.getenv("PADDLE_CURRENT_ENDPOINT", "")
        self._trainer_endpoints = os.getenv(
            "PADDLE_TRAINER_ENDPOINTS", "").split(",")
        self._coordinator = os.getenv("PADDLE_MASTER",
                                      os.getenv("MASTER_ADDR", ""))

    @property
    def rank(self):
        return self._rank

    @property
    def world_size(self):
        return self._world_size

    @property
    def device_id(self):
        return self._device_id

    @property
    def current_endpoint(self):
        return self._current_endpoint

    @property
    def trainer_endpoints(self):
        return self._trainer_endpoints

    nranks = world_size
    local_rank = rank


def comm_timeout():
    return datetime.timedelta(
        seconds=float(os.getenv("PADDLE_COMM_TIMEOUT", "600")))


def _rendezvous(env):
    """The store every rank meets at: a FileStore for ``file://<path>``,
    else a TCPStore that rank 0 hosts (127.0.0.1 and a free port when a
    world of one names no master)."""
    addr = env._coordinator
    if addr.startswith("file://"):
        return dist.FileStore(addr[len("file://"):], env.world_size)
    from .store import TCPStore
    if not addr:
        if env.world_size > 1:
            raise ValueError(
                f"a world of {env.world_size} ranks needs PADDLE_MASTER "
                f"(host:port or file://path) in each rank's environment")
        host, port = "127.0.0.1", 0
    else:
        host, port = addr.rsplit(":", 1)
    store = TCPStore(host, int(port), is_master=env.rank == 0,
                     world_size=env.world_size,
                     timeout=comm_timeout().total_seconds())
    _STORE[0] = store
    return store.store


def init_distributed_runtime(backend=None, device=None):
    """Join this rank into the world (the TCPStore + ProcessGroup set-up
    of the reference). ``device`` is the rank's device type (default the
    card ``FLAGS_selected_gpus`` names); ``backend`` is "nccl" or "gloo"
    (default: nccl on a card, gloo on the CPU). Idempotent."""
    env = ParallelEnv()
    if dist.is_initialized():
        return env
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", env.device_id)
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("backend='nccl' needs a CUDA device")
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("this torch has no NCCL; ask for backend='gloo' "
                           "explicitly to run the collectives over gloo")
    store = _rendezvous(env)
    kw = {}
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(backend, store=store, rank=env.rank,
                            world_size=env.world_size,
                            timeout=comm_timeout(), **kw)
    _DEVICE_TYPE[0] = dev.type
    if backend == "gloo" and dev.type == "cuda":
        from .collective import reroute_gloo_cuda_all_gather
        reroute_gloo_cuda_all_gather()
    return env


def world_device_type():
    """The device type this rank's tensors lie on: the one it joined the
    world with, or "cuda" for a world joined elsewhere on NCCL. A gloo
    world joined elsewhere (torch.distributed.init_process_group) raises:
    its ranks may hold their tensors on the card or the host."""
    if _DEVICE_TYPE[0] is not None:
        return _DEVICE_TYPE[0]
    if dist.get_backend() == "nccl":
        return "cuda"
    raise RuntimeError(
        "this gloo world was not joined through the port, so the device "
        "its ranks' tensors lie on is unknown: join it with "
        "distributed.init_parallel_env(backend='gloo', device=...)")


def is_initialized():
    return dist.is_available() and dist.is_initialized()


def get_rank(group=None):
    if group is not None:
        return group.rank
    return dist.get_rank() if is_initialized() else ParallelEnv().rank


def get_world_size(group=None):
    if group is not None:
        return group.nranks
    return dist.get_world_size() if is_initialized() \
        else ParallelEnv().world_size


def _reset():
    """Drop the rank's store (destroy_process_group)."""
    _STORE[0] = None
    _DEVICE_TYPE[0] = None
