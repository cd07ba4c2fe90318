"""Hybrid-parallel gradient and parameter helpers (counterpart of
paddle_tpu/distributed/fleet/utils/hybrid_parallel_util.py).

``fused_allreduce_gradients`` averages the gradients of
``parameter_list`` over the dp group, bucketed and flattened as the
gradient sync is; the ``broadcast_*_parameters`` helpers broadcast the
model's parameters (and, for dp, buffers) from the first rank of one axis'
group. Over mp only the parameters that are not sharded
(``mp_sharded`` False; Paddle's ``is_distributed``, a name torch's
tensors already take) are broadcast: each rank's shard is its own.
Sharding and sep are degree 1 in this port (a later slice), so their
broadcasts are over one rank and change nothing.
"""
from __future__ import annotations

from ...parallel import sync_params_buffers

__all__ = ["fused_allreduce_gradients", "broadcast_dp_parameters",
           "broadcast_mp_parameters", "broadcast_sharding_parameters",
           "broadcast_sep_parameters"]


def fused_allreduce_gradients(parameter_list, hcg):
    from ..grad_buckets import GradBucketScheduler
    params = [(str(i), p) for i, p in enumerate(parameter_list)
              if p.grad is not None]
    sched = GradBucketScheduler(params,
                                group=hcg.get_data_parallel_group())
    sched.sync_grads({n: p.grad for n, p in params})


def broadcast_dp_parameters(model, hcg):
    sync_params_buffers(model, hcg.get_data_parallel_group())


def broadcast_mp_parameters(model, hcg):
    sync_params_buffers(model, hcg.get_model_parallel_group(),
                        only=lambda p: not getattr(p, "mp_sharded", False))


def broadcast_sharding_parameters(model, hcg):
    sync_params_buffers(model, hcg.get_sharding_parallel_group())


def broadcast_sep_parameters(model, hcg):
    sync_params_buffers(model, hcg.get_sep_parallel_group())
