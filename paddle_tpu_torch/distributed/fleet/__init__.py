"""paddle.distributed.fleet (counterpart of
paddle_tpu/distributed/fleet/): the strategy, the hybrid topology, the
facade and its module-level entry points, the gradient buckets and the
tensor-parallel layers."""
from .distributed_strategy import DistributedStrategy  # noqa: F401
from .topology import CommunicateTopology, HybridCommunicateGroup  # noqa: F401
from .fleet import Fleet, HybridParallelOptimizer  # noqa: F401
from .fleet import fleet as _fleet_instance
from .grad_buckets import GradBucketScheduler, partition_buckets  # noqa: F401
from . import meta_parallel  # noqa: F401
from . import utils  # noqa: F401

init = _fleet_instance.init
apply_plan = _fleet_instance.apply_plan
distributed_model = _fleet_instance.distributed_model
distributed_optimizer = _fleet_instance.distributed_optimizer
get_hybrid_communicate_group = _fleet_instance.get_hybrid_communicate_group
worker_index = _fleet_instance.worker_index
is_first_worker = _fleet_instance.is_first_worker
barrier_worker = _fleet_instance.barrier_worker


def worker_num():
    from ..env import get_world_size
    return get_world_size()


__all__ = ["DistributedStrategy", "CommunicateTopology",
           "HybridCommunicateGroup", "Fleet", "HybridParallelOptimizer",
           "init", "apply_plan", "distributed_model",
           "distributed_optimizer", "get_hybrid_communicate_group",
           "worker_index", "worker_num", "is_first_worker", "barrier_worker",
           "meta_parallel", "utils", "GradBucketScheduler",
           "partition_buckets"]
