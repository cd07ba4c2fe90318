"""paddle.distributed on torch.distributed (counterpart of
paddle_tpu/distributed/).

One process per rank (``spawn`` or any launcher that sets env.py's
contract). ``init_parallel_env`` joins the world on NCCL for a card or
gloo for the CPU (or when asked); collective.py has the collective API
with its int8 / bf16 wire codecs (and p2p that stages CUDA tensors
through host memory on gloo), parallel.py ``DataParallel``, ``passes``
the pipeline schedulers, and ``fleet`` the hybrid topology, the gradient
buckets, the tensor-parallel layers and the pipeline (its executor,
PipelineLayer and PipelineParallel, the ZeRO sharding stages) and
``sharding`` ``group_sharded_parallel``, and ``auto_parallel`` the
semi-auto API (ProcessMesh, placements, shard_tensor / reshard /
shard_layer / shard_optimizer / shard_dataloader, to_static and
DistModel) on torch.distributed.tensor; the MoE layer's expert-parallel
exchange is in incubate. Sep, checkpointing and the launcher are not
ported.
"""
from .env import (  # noqa: F401
    ParallelEnv, get_rank, get_world_size, is_initialized,
)
from .collective import (  # noqa: F401
    ReduceOp, Group, new_group, get_group, destroy_process_group,
    all_reduce, all_gather, all_gather_object, reduce, reduce_scatter,
    broadcast, scatter, alltoall, all_to_all, alltoall_single,
    send, recv, isend, irecv, batch_isend_irecv, P2POp, barrier, wait, stream,
    collective_permute,
)
from .misc import (  # noqa: F401
    gather, scatter_object_list, broadcast_object_list, spawn, ParallelMode,
    ReduceType, is_available, get_backend, split, CountFilterEntry,
    ShowClickEntry, ProbabilityEntry, ShardingStage1, ShardingStage2,
    ShardingStage3, shard_scaler,
)
from .parallel import init_parallel_env, DataParallel  # noqa: F401
from .store import TCPStore  # noqa: F401
from . import auto_parallel, communication, fleet, passes, sharding  # noqa: F401,E501
from .auto_parallel import (  # noqa: F401
    ProcessMesh, Shard, Replicate, Partial, Placement, shard_tensor, reshard,
    dtensor_from_fn, unshard_dtensor, shard_layer, shard_optimizer,
    shard_dataloader, to_static, DistModel, Strategy, DistAttr,
)

__all__ = [
    "ParallelEnv", "get_rank", "get_world_size", "is_initialized",
    "ReduceOp", "Group", "new_group", "get_group", "destroy_process_group",
    "all_reduce", "all_gather", "all_gather_object", "reduce",
    "reduce_scatter", "broadcast", "scatter", "alltoall", "all_to_all",
    "alltoall_single", "send", "recv", "isend", "irecv", "batch_isend_irecv",
    "P2POp", "barrier", "wait", "stream", "collective_permute", "gather",
    "scatter_object_list", "broadcast_object_list", "spawn", "ParallelMode",
    "ReduceType", "is_available", "get_backend", "split", "CountFilterEntry",
    "ShowClickEntry", "ProbabilityEntry", "init_parallel_env",
    "DataParallel", "TCPStore", "communication", "fleet", "passes",
    "sharding", "auto_parallel", "ProcessMesh", "Shard", "Replicate",
    "Partial", "Placement", "shard_tensor", "reshard", "dtensor_from_fn",
    "unshard_dtensor", "shard_layer", "shard_optimizer", "shard_dataloader",
    "to_static", "DistModel", "Strategy", "DistAttr", "shard_scaler",
    "ShardingStage1", "ShardingStage2", "ShardingStage3",
]
