from .hybrid_parallel_util import (  # noqa: F401
    fused_allreduce_gradients, broadcast_dp_parameters,
    broadcast_mp_parameters, broadcast_sharding_parameters,
    broadcast_sep_parameters,
)
from .sequence_parallel_utils import (  # noqa: F401
    ScatterOp, GatherOp, AllGatherOp, ReduceScatterOp,
    ColumnSequenceParallelLinear, RowSequenceParallelLinear,
    mark_as_sequence_parallel_parameter,
    register_sequence_parallel_allreduce_hooks,
)
