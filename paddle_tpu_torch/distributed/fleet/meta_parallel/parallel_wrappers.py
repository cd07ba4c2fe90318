"""TensorParallel (counterpart of
paddle_tpu/distributed/fleet/meta_parallel/parallel_wrappers.py:73).

At wrap time the parameters that are not sharded over mp are broadcast
over the mp group (each rank keeps its own shard of the sharded ones),
and every parameter and buffer over the dp group; the gradients are then
averaged over the dp group by the bucket scheduler, as DataParallel's.
"""
from __future__ import annotations

from ...parallel import _SyncedLayers
from ..utils.hybrid_parallel_util import (broadcast_dp_parameters,
                                          broadcast_mp_parameters)

__all__ = ["TensorParallel"]


class TensorParallel(_SyncedLayers):
    def __init__(self, layers, hcg, strategy=None):
        broadcast_mp_parameters(layers, hcg)
        broadcast_dp_parameters(layers, hcg)
        bucket_mb = strategy.fuse_grad_size_in_MB if strategy is not None \
            else 32
        super().__init__(layers, hcg.get_data_parallel_group(), bucket_mb)
        self._hcg = hcg
        self._strategy = strategy
