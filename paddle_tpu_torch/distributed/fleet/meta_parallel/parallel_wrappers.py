"""TensorParallel, ShardingParallel and PipelineParallel (counterpart of
paddle_tpu/distributed/fleet/meta_parallel/parallel_wrappers.py:51-147).

ShardingParallel broadcasts the parameters at wrap time (dense ones over
the data world, experts over their replicas) and adds no gradient hook:
the sharding optimizer fleet's ``distributed_optimizer`` wraps reduces
the gradients in its step.

At wrap time the parameters that are not sharded over mp are broadcast
over the mp group (each rank keeps its own shard of the sharded ones),
and every parameter and buffer over the dp group; the gradients are then
averaged over the dp group by the bucket scheduler, as DataParallel's.

PipelineParallel drives a pipeline rank's training. Over a PipelineLayer
it runs the 1F1B schedule (interleaved with virtual stages) on
``accumulate_steps`` microbatches of the batch (pipeline_spmd.py), with
the reference's ``loss / n`` averaging, and returns the batch's loss on
every pp rank. Over a model with an internal pipeline
(``_internal_pipeline``: Llama and GPT with ``pipeline_parallel=True``)
``accumulate_steps`` becomes the stack's microbatch count
(``_mb_override``, never written into the user's config) and the whole
batch goes to the model's own schedule once. ``train_batch`` then sums
the shared (tied) weights' gradients over the stages holding them,
averages every gradient over the dp group (once, after the last
backward), and steps the optimizer on this rank's parameters.
"""
from __future__ import annotations

import torch

from ...parallel import _SyncedLayers
from .sharding_optimizer import _Wrapper
from ..utils.hybrid_parallel_util import (broadcast_dp_parameters,
                                          broadcast_mp_parameters)

__all__ = ["TensorParallel", "ShardingParallel", "PipelineParallel"]


class TensorParallel(_SyncedLayers):
    def __init__(self, layers, hcg, strategy=None):
        broadcast_mp_parameters(layers, hcg)
        broadcast_dp_parameters(layers, hcg)
        bucket_mb = strategy.fuse_grad_size_in_MB if strategy is not None \
            else 32
        super().__init__(layers, hcg.get_data_parallel_group(), bucket_mb)
        self._hcg = hcg
        self._strategy = strategy


class ShardingParallel(_Wrapper):
    def __init__(self, layers, hcg, strategy=None):
        from ...parallel import sync_params_buffers
        ep = hcg.get_expert_parallel_world_size() > 1
        sync_params_buffers(
            layers, hcg.get_data_world_group(),
            expert_group=hcg.get_expert_replica_group() if ep else None)
        super().__init__(layers)
        self._hcg = hcg
        self._strategy = strategy


class PipelineParallel(TensorParallel):
    def __init__(self, layers, hcg, strategy=None):
        super().__init__(layers, hcg, strategy)
        cfg = (strategy.hybrid_configs["pp_configs"]
               if strategy is not None else None)
        self.accumulate_steps = getattr(cfg, "accumulate_steps", 1) or 1
        self.micro_batch_size = getattr(cfg, "micro_batch_size", 1) or 1
        self.total_loss = None
        self.last_pipeline_stats = None
        # accumulate_steps IS the microbatch count of the internal
        # pipeline (the reference's pp_configs semantics), set on the
        # stack instance only
        if getattr(layers, "_internal_pipeline", False) and \
                self.accumulate_steps > 1:
            for sub in layers.modules():
                if hasattr(sub, "_mb_override"):
                    sub._mb_override = self.accumulate_steps

    @property
    def _internal(self):
        return getattr(self._layers, "_internal_pipeline", False)

    def _device(self):
        p = next(self._layers.parameters(), None)
        return torch.device("cpu") if p is None else p.device

    def _run(self, data, forward_only=False):
        """The batch through this rank's schedule; returns the batch's
        loss (the mean of the microbatch losses) on every pp rank."""
        from .pipeline_spmd import (broadcast_from_last, run_schedule,
                                    schedule_instructions)
        inputs, labels = data
        layers = self._layers
        group = self._hcg.get_pipe_parallel_group()
        S, s, V = group.nranks, group.rank, layers._num_virtual
        n = self.accumulate_steps
        dev = self._device()
        res = run_schedule(
            layers.run_chunk, schedule_instructions(S, n, V, s),
            list(inputs.chunk(n)) if s == 0 else None,
            list(labels.chunk(n)) if s == S - 1 else None,
            layers._loss_fn, group=group, num_chunks=V,
            loss_weights=[1.0 / n] * n, device=dev,
            forward_only=forward_only)
        self.last_pipeline_stats = res["stats"]
        loss = torch.stack(res["losses"]).sum().float() \
            if s == S - 1 else None
        return broadcast_from_last(loss, group, (), torch.float32, dev)

    def forward_backward_pipeline(self, data, scaler=None):
        if scaler is not None:
            raise NotImplementedError("PipelineParallel with a loss scaler "
                                      "is not ported to the PyTorch package")
        with self._grad_sync.disarmed():
            if self._internal:
                inputs, labels = data
                loss = self._layers.forward_backward(
                    [inputs], [labels], self._layers._loss_fn)
                self.last_pipeline_stats = self._layers.last_pipeline_stats
            else:
                loss = self._run(data)
        self.total_loss = loss
        return loss

    def _sync_gradients(self):
        self._layers.allreduce_shared_weight_gradients()
        self._grad_sync.sync_grads({n: p.grad for n, p in
                                    self._layers.named_parameters()})

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        loss = self.forward_backward_pipeline(data, scaler)
        self._sync_gradients()
        optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    def eval_batch(self, data, compute_loss=True):
        inputs, labels = data
        with torch.no_grad():
            if self._internal:
                out = self._layers(inputs)
                if compute_loss and getattr(self._layers, "_loss_fn", None):
                    return self._layers._loss_fn(out, labels)
                return out
            if not compute_loss:
                raise NotImplementedError(
                    "eval_batch(compute_loss=False) over a PipelineLayer: "
                    "the outputs stay on the last stage")
            return self._run(data, forward_only=True)
