"""Semi-automatic SPMD parallelism (auto-parallel) on
torch.distributed.tensor (counterpart of
paddle_tpu/distributed/auto_parallel/).

A distributed tensor is a DTensor over the DeviceMesh a ProcessMesh
names; Paddle's placements map one to one onto torch's, and torch's
per-op sharding propagation plays the part GSPMD plays in the JAX
package. The port's models, loss, optimizers, gradient clip and TrainStep
meet DTensors through framework/dtensor.py, and ``flash_attention`` runs
its kernels on each rank's heads (nn/functional/flash_attention.py).
"""
from .placement import Shard, Replicate, Partial, Placement  # noqa: F401
from .process_mesh import ProcessMesh, get_current_mesh  # noqa: F401
from .api import (  # noqa: F401
    shard_tensor, reshard, dtensor_from_fn, shard_layer, shard_optimizer,
    shard_dataloader, to_static, DistModel, DistAttr, Strategy,
    unshard_dtensor, paddle_placements,
)

__all__ = ["Shard", "Replicate", "Partial", "Placement", "ProcessMesh",
           "get_current_mesh", "shard_tensor", "reshard", "dtensor_from_fn",
           "shard_layer", "shard_optimizer", "shard_dataloader", "to_static",
           "DistModel", "DistAttr", "Strategy", "unshard_dtensor",
           "paddle_placements"]
