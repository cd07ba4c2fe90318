"""fleet.meta_parallel (counterpart of
paddle_tpu/distributed/fleet/meta_parallel/): the tensor-parallel layers,
the collective matmul, the RNG state tracker, the pipeline's layers and executor, the ZeRO
sharding stages, and the TensorParallel, ShardingParallel and
PipelineParallel wrappers."""
from .mp_layers import (  # noqa: F401
    VocabParallelEmbedding, ColumnParallelLinear, RowParallelLinear,
    ParallelCrossEntropy,
)
from .collective_matmul import (  # noqa: F401
    cm_matmul, overlapped_linear, configure_mp_overlap, mp_overlap_config,
    mp_overlap_ctx, overlap_wire_plan, DEFAULT_CHUNKS, CM_KINDS,
)
from .pp_layers import (  # noqa: F401
    LayerDesc, SharedLayerDesc, SegmentLayers, PipelineLayer,
)
from .pipeline_spmd import (  # noqa: F401
    run_schedule, spmd_pipeline, spmd_pipeline_interleaved,
)
from .random_ctrl import (  # noqa: F401
    RNGStatesTracker, get_rng_state_tracker, model_parallel_random_seed,
)
from .parallel_wrappers import (  # noqa: F401
    TensorParallel, ShardingParallel, PipelineParallel,
)
from .sharding_optimizer import (  # noqa: F401
    DygraphShardingOptimizer, GroupShardedOptimizerStage2,
    GroupShardedStage2, GroupShardedStage3,
)

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "cm_matmul",
           "overlapped_linear", "configure_mp_overlap", "mp_overlap_config",
           "mp_overlap_ctx", "overlap_wire_plan", "DEFAULT_CHUNKS",
           "CM_KINDS", "LayerDesc",
           "SharedLayerDesc", "SegmentLayers", "PipelineLayer",
           "run_schedule", "spmd_pipeline", "spmd_pipeline_interleaved",
           "RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed", "TensorParallel",
           "ShardingParallel", "PipelineParallel",
           "DygraphShardingOptimizer", "GroupShardedOptimizerStage2",
           "GroupShardedStage2", "GroupShardedStage3"]
