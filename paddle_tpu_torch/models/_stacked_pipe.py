"""The pipeline-parallel decoder stack, per rank (counterpart of
paddle_tpu/models/_stacked_pipe.py).

The JAX package stores a pipelined model's block weights stacked with a
leading [num_layers] axis whose 'pp' sharding is the stage placement.
Here each pp rank builds and holds only its own stage, as Paddle's
pp_layers.py:257 does: its decoder layers, kept by their natural index
(``decoder_stack.layers.<l>``), and the model keeps its embeddings on
stage 0 and its final norm and head on the last stage. With
``virtual_pp_degree`` V > 1, stage s holds V chunks in the reference's
device-major assignment: chunk c is virtual stage c S + s and holds
layers (c S + s) lps ... + lps, lps = L / (S V) (``storage_order`` lists
that order). The schedule runs in fleet/meta_parallel/pipeline_spmd.py;
``PipelinedLM`` is the part the causal LMs share: the microbatch split,
the loss weighting, the tied-weight gradient sum and the forward whose
logits every rank gets.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

__all__ = ["StackedDecoderBase", "PipelinedLM", "stage_layers",
           "pipeline_topology"]


def stage_layers(num_layers, S, V, stage):
    """The natural layer indices of each chunk of ``stage``: chunk c is
    virtual stage c S + stage."""
    lps = num_layers // (S * V)
    return [[(c * S + stage) * lps + i for i in range(lps)]
            for c in range(V)]


def pipeline_topology():
    """Fleet's hybrid group when it has a pp axis, else the ValueError the
    reference raises for a pipelined model without a pp mesh."""
    from ..distributed.fleet.fleet import fleet
    hcg = fleet.get_hybrid_communicate_group()
    if hcg is None or hcg.get_pipe_parallel_group() is None:
        raise ValueError(
            "pipeline_parallel models need a pp topology BEFORE model "
            "construction (each rank builds only its stage) — call "
            "fleet.init(strategy with pp_degree) first")
    return hcg


class StackedDecoderBase(nn.Module):
    """This rank's decoder layers. Subclasses define:

    - _WEIGHT_SPECS: {key: (shape_fn(config) -> the reference's per-layer
      shape, mp dim of that shape or None)}: the stacked weights of the
      JAX package, whose names the converters and placement_factors use;
    - _LAYER_ATTRS: {key: attr path into one decoder layer};
    - _TRANSPOSED: the keys whose reference layout ([in, out]) is the
      transpose of the port's Linear weight.
    """

    _WEIGHT_SPECS: dict = {}
    _LAYER_ATTRS: dict = {}
    _TRANSPOSED: tuple = ()

    def __init__(self, config, make_layer, build_all=False):
        """``make_layer(l)`` builds natural layer l; ``build_all`` builds
        every layer in order and keeps this stage's (a family whose
        layers draw their weights at construction keeps its draws in
        step with the one-rank model)."""
        super().__init__()
        self.config = config
        hcg = pipeline_topology()
        self._hcg = hcg
        L = config.num_hidden_layers
        self._pp = hcg.get_pipe_parallel_world_size()
        self._stage = hcg.get_stage_id()
        self._vpp = int(getattr(config, "virtual_pp_degree", 1) or 1)
        self._mb_override = None     # set by fleet's PipelineParallel
        if L % (self._pp * self._vpp) != 0:
            raise ValueError(
                f"pp degree {self._pp} x virtual_pp_degree {self._vpp} "
                f"must divide num_hidden_layers {L}")
        self.chunks = stage_layers(L, self._pp, self._vpp, self._stage)
        mine = {l for chunk in self.chunks for l in chunk}
        layers = {}
        for l in (range(L) if build_all else sorted(mine)):
            layer = make_layer(l)
            if l in mine:
                layers[str(l)] = layer
        self.layers = nn.ModuleDict(layers)

    @property
    def pp_group(self):
        return self._hcg.get_pipe_parallel_group()

    # -- schedule policy ---------------------------------------------------
    def num_microbatches(self, batch_size):
        """The reference's rule: the PipelineParallel override, else
        ``pp_microbatches``, else the largest divisor of the batch <= 2 pp
        (enough microbatches to fill the 1F1B steady state)."""
        m = self._mb_override or getattr(self.config, "pp_microbatches",
                                         None)
        if m is not None:
            if batch_size % m != 0:
                raise ValueError(
                    f"pp microbatch count {m} must divide batch size "
                    f"{batch_size}")
            return m
        m = min(2 * self._pp, batch_size)
        while batch_size % m != 0:
            m -= 1
        return m

    def storage_order(self):
        """The reference's storage position -> natural layer index (all
        stages): 1F1B keeps natural order; VPP is device-major, position
        s (V lps) + c lps + i holding natural layer (c S + s) lps + i."""
        L = self.config.num_hidden_layers
        S, V = self._pp, self._vpp
        if V == 1:
            return list(range(L))
        return [l for s in range(S) for chunk in stage_layers(L, S, V, s)
                for l in chunk]

    # -- the stage's compute -----------------------------------------------
    def forward(self, chunk, x, *args):
        """Chunk ``chunk``'s layers on x. Under ``recompute`` in training
        each layer (granularity "layer") or the whole chunk ("stage") is
        checkpointed: the backward reruns its forward."""
        recompute = bool(self.config.recompute) and self.training
        granularity = getattr(self.config, "recompute_granularity", "layer")
        layers = [self.layers[str(l)] for l in self.chunks[chunk]]

        def run(h, *a):
            for layer in layers:
                if recompute and granularity == "layer":
                    h = checkpoint(layer, h, *a, use_reentrant=False)
                else:
                    h = layer(h, *a)
            return h

        if recompute and granularity == "stage":
            return checkpoint(run, x, *args, use_reentrant=False)
        return run(x, *args)

    # -- interop with per-layer storage ------------------------------------
    @torch.no_grad()
    def load_layerwise(self, layers):
        """Copy this stage's layers from a list of all L per-layer blocks
        of the same family (e.g. a one-rank model's), whole tensors or
        this rank's tensor-parallel shards."""
        from ..convert import tp_shard
        for l, mine in self.layers.items():
            src = dict(layers[int(l)].named_parameters())
            for name, p in mine.named_parameters():
                full = src[name].detach().to(p.device, p.dtype)
                if full.shape != p.shape:
                    rank, n = p.tp_rank_size
                    full = tp_shard(name, full, rank, n)
                p.copy_(full)
        return self

    def _local_param(self, key, l):
        obj = self.layers[str(l)]
        for attr in self._LAYER_ATTRS[key]:
            obj = getattr(obj, attr)
        return obj

    def placement_factors(self):
        """{key: the stacked weight's elements over this rank's}: pp for
        every stacked weight, times mp on the tensor-parallel ones (the
        reference reports global / per-device bytes)."""
        L = self.config.num_hidden_layers
        out = {}
        for key, (shape_fn, _) in self._WEIGHT_SPECS.items():
            full = L * math.prod(shape_fn(self.config))
            local = sum(self._local_param(key, l).numel()
                        for chunk in self.chunks for l in chunk)
            out[key] = full / local
        return out


class PipelinedLM:
    """What a pipelined causal LM's rank runs: the subclass gives
    ``_pp_stack()`` (its StackedDecoderBase), ``_pp_stage(chunk, x)`` (the
    chunk's forward, with the embeddings on virtual stage 0 and the norm
    and head on the last) and ``_pp_tied()`` (the tied weight on the
    first and last stage, or None)."""

    # time each receive's wait after the device drains (the schedule's
    # idle time per rank, in last_pipeline_stats["recv_wait_s"])
    pipeline_timed = False

    @property
    def _internal_pipeline(self):
        """The stacked decoder microbatches and pipelines internally:
        fleet's PipelineParallel must not split the batch a second time."""
        return self._pp_stack() is not None

    def forward_backward(self, inputs, labels, loss_fn, timed=None):
        """One batch through this rank's schedule: ``inputs`` = (ids,),
        ``labels`` = (labels,), as TrainStep passes them; the
        microbatches' forwards and backwards, the gradients accumulated
        in this stage's parameters. Returns the batch's loss (float32) on
        every rank of the pp group.

        The loss is the batch's, as the reference computes it over the
        reassembled batch: microbatch m's loss is weighted by its share
        of the labels that are not -100 (the mean of cross_entropy), or by
        1 / M for a loss whose mean counts every position (a loss_fn
        with ``pipeline_mean_over_positions`` set, such as
        LlamaPretrainingCriterion under tensor parallelism)."""
        from ..distributed.fleet.meta_parallel.pipeline_spmd import (
            broadcast_from_last, run_schedule, schedule_instructions)
        (ids,), (labels,) = inputs, labels
        st = self._pp_stack()
        S, s, V = st._pp, st._stage, st._vpp
        M = st.num_microbatches(int(ids.shape[0]))
        last = s == S - 1
        mb_labels = list(labels.chunk(M))
        weights = None
        if last and not getattr(loss_fn, "pipeline_mean_over_positions",
                                False):
            counts = [(lab != -100).sum().float() for lab in mb_labels]
            total = torch.stack(counts).sum().clamp(min=1.0)
            weights = [c / total for c in counts]
        res = run_schedule(
            self._pp_stage, schedule_instructions(S, M, V, s),
            list(ids.chunk(M)) if s == 0 else None, mb_labels,
            (lambda y, lab: loss_fn(y, lab).float()) if last else None,
            group=st.pp_group, num_chunks=V, loss_weights=weights,
            device=self.device,
            timed=self.pipeline_timed if timed is None else timed)
        self.last_pipeline_stats = dict(res["stats"], microbatches=M)
        loss = torch.stack(res["losses"]).sum() if last else None
        return broadcast_from_last(loss, st.pp_group, (), torch.float32,
                                   self.device)

    def _pipeline_forward(self, input_ids):
        """The last stage's output over the whole batch, on every rank of
        the pp group. One stage: one call, under the caller's grad mode.
        More: the microbatches' forwards through the schedule, without
        autograd (training runs through forward_backward)."""
        from ..distributed.fleet.meta_parallel.pipeline_spmd import (
            broadcast_from_last, run_schedule, schedule_instructions)
        st = self._pp_stack()
        S, s, V = st._pp, st._stage, st._vpp
        if S == 1 and V == 1:
            return self._pp_stage(0, input_ids)
        M = st.num_microbatches(int(input_ids.shape[0]))
        res = run_schedule(
            self._pp_stage, schedule_instructions(S, M, V, s),
            list(input_ids.chunk(M)) if s == 0 else None,
            group=st.pp_group, num_chunks=V, forward_only=True,
            keep_outputs=True, device=self.device)
        out = torch.cat(res["outputs"]) if s == S - 1 else None
        return broadcast_from_last(out, st.pp_group, device=self.device)

    @torch.no_grad()
    def set_state_dict(self, state_dict):
        """Load this rank's entries of a whole model's state dict in
        natural layer order, under the pipelined names
        (``decoder_stack.layers.<l>``) or the one-rank model's
        (``llama.layers.<l>``, ``gpt.h.<l>``), whole tensors or this
        rank's tensor-parallel shards: one checkpoint loads into any pp
        and vpp layout. Returns (missing, unexpected) of this rank's."""
        from ..convert import tp_shard
        st = self._pp_stack()
        root = "gpt" if hasattr(self, "gpt") else "llama"
        plain = f"{root}.h." if root == "gpt" else f"{root}.layers."
        own = dict(self.state_dict())
        loaded = set()
        for name, t in state_dict.items():
            if st is not None and name.startswith(plain):
                name = f"{root}.decoder_stack.layers." + name[len(plain):]
            if name not in own:
                continue
            dst = own[name]
            t = torch.as_tensor(t).to(dst.device, dst.dtype)
            if t.shape != dst.shape:
                param = dict(self.named_parameters())[name]
                rank, n = param.tp_rank_size
                t = tp_shard(name, t, rank, n)
            dst.copy_(t)
            loaded.add(name)
        return sorted(set(own) - loaded), []

    def allreduce_shared_weight_gradients(self):
        """Sum the tied weight's gradient over the first and last stage
        (each holds the weight; the embedding's and the head's gradients
        land on different ranks)."""
        p = self._pp_tied()
        S = self._pp_stack()._pp
        if p is None or S == 1:
            return
        from ..distributed.collective import all_reduce
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        all_reduce(p.grad, group=self._shared_group)

    def _make_shared_group(self, tied):
        """The group of the first and last stage of this rank's pipe,
        which hold the tied weight."""
        from ..distributed.fleet.meta_parallel.pp_layers import stage_group
        hcg = self._pp_stack()._hcg
        S = hcg.get_pipe_parallel_world_size()
        self._shared_group = stage_group(hcg, [0, S - 1]) \
            if tied and S > 1 else None
