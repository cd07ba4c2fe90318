"""fleet.meta_parallel (counterpart of
paddle_tpu/distributed/fleet/meta_parallel/): the tensor-parallel layers,
the RNG state tracker and the TensorParallel wrapper."""
from .mp_layers import (  # noqa: F401
    VocabParallelEmbedding, ColumnParallelLinear, RowParallelLinear,
    ParallelCrossEntropy,
)
from .random_ctrl import (  # noqa: F401
    RNGStatesTracker, get_rng_state_tracker, model_parallel_random_seed,
)
from .parallel_wrappers import TensorParallel  # noqa: F401

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "RNGStatesTracker",
           "get_rng_state_tracker", "model_parallel_random_seed",
           "TensorParallel"]
