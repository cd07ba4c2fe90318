from .hybrid_parallel_util import (  # noqa: F401
    fused_allreduce_gradients, broadcast_dp_parameters,
    broadcast_mp_parameters, broadcast_sharding_parameters,
    broadcast_sep_parameters,
)
