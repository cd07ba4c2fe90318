"""The fleet facade (counterpart of paddle_tpu/distributed/fleet/fleet.py).

``init`` joins the world (init_parallel_env), validates the strategy,
infers a ``-1`` degree from the world size, builds the hybrid
topology's process groups and sets the process-wide knobs: the
collective matmul's (``mp_overlap``, ``mp_activation_compress``,
``mp_overlap_chunks``), the mp layers' ``matmul_quant`` and the MoE
dispatch's wire codec (``dispatch_compress``); ``distributed_model``
wraps the model in PipelineParallel (pp > 1), TensorParallel (mp > 1),
ShardingParallel (sharding > 1) or DataParallel, in the reference's order
of precedence (under expert parallelism DataParallel averages over the
data world and sums the experts' gradients over their replicas);
``distributed_optimizer`` wraps the optimizer in DygraphShardingOptimizer
at sharding > 1 and carries the strategy's gradient-sync knobs to
TrainStep.
"""
from __future__ import annotations

import math

from .distributed_strategy import DistributedStrategy
from .topology import CommunicateTopology, HybridCommunicateGroup

__all__ = ["Fleet", "fleet", "HybridParallelOptimizer"]


class HybridParallelOptimizer:
    """Wraps the inner optimizer (reference: fleet/meta_optimizers/
    dygraph_optimizer/hybrid_parallel_optimizer.py). The gradients it
    steps on are already synced by the model wrapper's hooks."""

    def __init__(self, optimizer, hcg, strategy):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    def step(self, *a, **k):
        return self._inner_opt.step(*a, **k)

    def clear_grad(self, *a, **k):
        return self._inner_opt.clear_grad(*a, **k)

    def minimize(self, loss, *a, **k):
        loss.backward()
        self.step()
        return None, None


_NAME_OF = {"dp": "data", "pp": "pipe", "sharding": "sharding", "sep": "sep",
            "mp": "model", "ep": "expert"}


class Fleet:
    def __init__(self):
        self._is_initialized = False
        self._hcg = None
        self._user_defined_strategy = None

    def init(self, role_maker=None, is_collective=True, strategy=None,
             log_level="INFO", *, backend=None, device=None):
        """Join the world (``backend`` / ``device`` as init_parallel_env)
        and build the hybrid topology of ``strategy``."""
        from ..env import get_world_size
        from ..parallel import init_parallel_env
        if role_maker is not None or not is_collective:
            raise NotImplementedError(
                "fleet.init with a role maker or is_collective=False (the "
                "parameter-server mode) is not ported")
        init_parallel_env(backend=backend, device=device)
        s = strategy or DistributedStrategy()
        s.validate()
        hc = s.hybrid_configs
        order = list(hc.get("order", ["dp", "pp", "sharding", "sep", "mp"]))
        if "ep" not in order:
            if "sharding" in order:
                order.insert(order.index("sharding") + 1, "ep")
            elif "mp" in order:
                order.insert(order.index("mp"), "ep")
            else:
                order.append("ep")
        degrees = {"dp": hc["dp_degree"], "pp": hc["pp_degree"],
                   "sharding": hc["sharding_degree"],
                   "sep": hc.get("sep_degree", 1), "mp": hc["mp_degree"],
                   "ep": hc.get("ep_degree", 1)}
        world = get_world_size()
        known = math.prod(d for d in degrees.values() if d > 0)
        for k, v in degrees.items():
            if v == -1:
                degrees[k] = world // known
        if math.prod(degrees.values()) != world:
            raise ValueError(
                f"hybrid degrees {degrees} must multiply to the world size "
                f"{world}")
        topo = CommunicateTopology(
            hybrid_group_names=[_NAME_OF[a] for a in order],
            dims=[int(degrees[a]) for a in order])
        self._hcg = HybridCommunicateGroup(topo)
        self._user_defined_strategy = s
        # the process-wide knobs: the collective matmul's and the
        # quantized products' (read by the mp layers at each call) and the
        # dispatch codec (MoELayers built from now on inherit it). init is
        # authoritative: a re-init with a knob off turns it off
        from ...incubate.distributed.models.moe.moe_layer import (
            configure_moe_dispatch)
        from ...kernels.quant_matmul import configure_matmul_quant
        from .meta_parallel.collective_matmul import configure_mp_overlap
        configure_mp_overlap(
            enabled=bool(getattr(s, "mp_overlap", False)),
            compress=getattr(s, "mp_activation_compress", None) or "none",
            chunks=getattr(s, "mp_overlap_chunks", None) or "auto")
        configure_moe_dispatch(
            compress=getattr(s, "dispatch_compress", None) or "none")
        configure_matmul_quant(
            dtype=getattr(s, "matmul_quant", None) or "none")
        self._is_initialized = True
        return self

    def apply_plan(self, plan, strategy=None, **init_kw):
        raise NotImplementedError(
            "fleet.apply_plan: auto-parallel plans are not ported to the "
            "PyTorch package yet")

    def get_hybrid_communicate_group(self):
        return self._hcg

    @property
    def worker_num(self):
        from ..env import get_world_size
        return get_world_size()

    def worker_index(self):
        from ..env import get_rank
        return get_rank()

    def is_first_worker(self):
        return self.worker_index() == 0

    def barrier_worker(self):
        from ..collective import barrier
        barrier()

    def distributed_model(self, model):
        """PipelineParallel at pp > 1, TensorParallel at mp > 1,
        ShardingParallel at sharding > 1, else DataParallel over the dp
        group, or under expert parallelism over the data world with the
        experts' gradients summed over their replicas (reference
        fleet/model.py's dispatch)."""
        from ..parallel import DataParallel
        from .meta_parallel import (PipelineParallel, ShardingParallel,
                                    TensorParallel)
        if not self._is_initialized:
            raise RuntimeError("call fleet.init first")
        hcg, s = self._hcg, self._user_defined_strategy
        if hcg.get_pipe_parallel_world_size() > 1:
            return PipelineParallel(model, hcg, s)
        if hcg.get_model_parallel_world_size() > 1:
            return TensorParallel(model, hcg, s)
        if hcg.get_sharding_parallel_world_size() > 1:
            return ShardingParallel(model, hcg, s)
        if hcg.get_expert_parallel_world_size() > 1:
            return DataParallel(model,
                                comm_buffer_size=s.fuse_grad_size_in_MB,
                                group=hcg.get_data_world_group(),
                                expert_group=hcg.get_expert_replica_group())
        return DataParallel(model, comm_buffer_size=s.fuse_grad_size_in_MB,
                            group=hcg.get_data_parallel_group())

    def distributed_optimizer(self, optimizer, strategy=None):
        if not self._is_initialized:
            raise RuntimeError("call fleet.init first")
        s = strategy or self._user_defined_strategy
        if getattr(s, "gradient_merge", False):
            raise NotImplementedError(
                "DistributedStrategy.gradient_merge is not ported to the "
                "PyTorch package yet")
        if (self._hcg.get_model_parallel_world_size() > 1
                or self._hcg.get_pipe_parallel_world_size() > 1) and \
                getattr(optimizer, "_grad_clip", None) is not None:
            raise NotImplementedError(
                "gradient clipping under tensor or pipeline parallelism "
                "(the global norm over mp shards and pp stages) is not "
                "ported to the PyTorch package yet")
        gs_cfg = None
        if getattr(s, "grad_compress", None) or \
                getattr(s, "grad_bucket_mb", None):
            gs_cfg = {"compress": getattr(s, "grad_compress", None),
                      "bucket_mb": getattr(s, "grad_bucket_mb", None),
                      "axis": "dp"}
        if self._hcg.get_sharding_parallel_world_size() > 1:
            from .meta_parallel import DygraphShardingOptimizer
            optimizer = DygraphShardingOptimizer(optimizer, self._hcg)
        wrapped = HybridParallelOptimizer(optimizer, self._hcg, s)
        if gs_cfg is not None:
            # TrainStep reads it while it unwraps the optimizer
            wrapped._grad_sync_config = gs_cfg
        return wrapped


fleet = Fleet()


def live_hcg():
    """fleet's hybrid topology while this process is in a world, else
    None."""
    from ..env import is_initialized
    return fleet.get_hybrid_communicate_group() if is_initialized() \
        else None
