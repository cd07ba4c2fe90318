"""Pipeline layer partitioning, per rank (counterpart of
paddle_tpu/distributed/fleet/meta_parallel/pp_layers.py).

Reference: python/paddle/distributed/fleet/meta_parallel/parallel_layers/
pp_layers.py:56 (LayerDesc), :76 (SharedLayerDesc), :207/:257
(PipelineLayer with uniform / param-weighted segmentation and shared
layers). The JAX package builds every segment in one program; here a rank
builds only the layers of its stage's segments, as Paddle does:

- ``SegmentLayers`` cuts the descriptor list into S V parts (uniformly,
  by parameter count, or by a layer-name pattern); with V virtual stages
  a rank (stage s) holds parts c S + s, its chunks;
- a ``SharedLayerDesc`` (a tied embedding) is built on each rank whose
  segments use it; its weights are broadcast from the first of those
  ranks at construction, and ``allreduce_shared_weight_gradients`` sums
  their gradients over them;
- ``get_stage_from_index`` keeps its meaning; ``parameters_of_stage``
  lists this rank's parameters under its stage (another stage's are not
  here).

fleet's PipelineParallel runs the schedule over a PipelineLayer.
"""
from __future__ import annotations

import re

import torch
from torch import nn

__all__ = ["LayerDesc", "SharedLayerDesc", "SegmentLayers", "PipelineLayer",
           "stage_group"]


class LayerDesc:
    def __init__(self, layer_func, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs
        if not (isinstance(layer_func, type)
                and issubclass(layer_func, nn.Module)):
            raise TypeError("LayerDesc expects an nn.Module subclass")

    def build_layer(self):
        return self.layer_func(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_func.__name__})"


class SharedLayerDesc(LayerDesc):
    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class SegmentLayers:
    """The reference's segmentation: uniform, by parameter count, or
    ``layer:<pattern>`` (each descriptor matching the pattern weighs 1).
    ``do_segment()`` returns (part boundaries, None): weighing by
    parameter count builds each layer once to count it, and drops it (a
    rank builds its own layers afterwards; the reference hands the built
    list back for its single program)."""

    def __init__(self, layers_desc, num_parts, method="uniform"):
        self.descs = layers_desc
        self.num_parts = num_parts
        self.method = method

    def do_segment(self):
        n = len(self.descs)
        if self.method == "uniform":
            return self.uniform(n, self.num_parts), None
        if self.method.startswith("layer:"):
            name = self.method.split(":", 1)[1]
            return self._by_weights(
                [1 if re.search(name, str(d)) else 0
                 for d in self.descs]), None
        weights, shared = [], {}
        for d in self.descs:
            try:
                if isinstance(d, SharedLayerDesc):
                    if d.layer_name not in shared:
                        shared[d.layer_name] = d.build_layer()
                    layer = shared[d.layer_name]
                elif isinstance(d, LayerDesc):
                    layer = d.build_layer()
                else:
                    layer = d
                w = sum(p.numel() for p in layer.parameters()) or 1
            except Exception:
                w = 1
            weights.append(w)
        return self._by_weights(weights), None

    @staticmethod
    def uniform(num_items, num_parts):
        result = [0] * (num_parts + 1)
        part = num_items // num_parts
        extra = num_items % num_parts
        for i in range(1, num_parts + 1):
            result[i] = result[i - 1] + part + (1 if i <= extra else 0)
        return result

    def _by_weights(self, weights):
        total = sum(weights)
        target = total / self.num_parts
        bounds = [0]
        acc = 0
        for i, w in enumerate(weights):
            acc += w
            if acc >= target * len(bounds) and len(bounds) < self.num_parts:
                bounds.append(i + 1)
        while len(bounds) < self.num_parts:
            bounds.append(len(weights))
        bounds.append(len(weights))
        return bounds[:self.num_parts + 1]


def _hcg():
    from ..fleet import fleet
    return fleet.get_hybrid_communicate_group()


def stage_group(hcg, stages):
    """This rank's group of the ranks holding ``stages`` of its pipe: the
    pp group when they are all of them, else a group every rank makes for
    every pipe, in order (torch's rule); None on a rank outside them."""
    if sorted(stages) == list(range(hcg.get_pipe_parallel_world_size())):
        return hcg.get_pipe_parallel_group()
    from ...collective import new_group
    me, mine = hcg.get_global_rank(), None
    for ranks in hcg.topology.get_comm_list("pipe"):
        members = [ranks[s] for s in stages]
        g = new_group(members)
        if me in members:
            mine = g
    return mine


class PipelineLayer(nn.Module):
    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0,
                 recompute_ctx=None, num_virtual_pipeline_stages=None):
        super().__init__()
        if recompute_interval or recompute_ctx is not None:
            raise NotImplementedError(
                "PipelineLayer(recompute_interval=...) is not ported to "
                "the PyTorch package yet")
        self._layers_desc = list(layers)
        hcg = _hcg()
        if topology is None and hcg is not None:
            topology = hcg.topology
        if num_stages is None:
            num_stages = topology.get_dim("pipe") if topology is not None \
                else 1
        self._num_stages = int(num_stages)
        if hcg is not None and \
                hcg.get_pipe_parallel_world_size() != self._num_stages:
            raise ValueError(
                f"num_stages {self._num_stages} differs from fleet's pp "
                f"degree {hcg.get_pipe_parallel_world_size()}")
        if hcg is None and self._num_stages > 1:
            raise ValueError("a PipelineLayer of several stages needs "
                             "fleet.init with pp_degree first")
        self._hcg = hcg
        self._stage = hcg.get_stage_id() if hcg is not None else 0
        self._loss_fn = loss_fn
        self._num_virtual = int(num_virtual_pipeline_stages or 1)
        S, V = self._num_stages, self._num_virtual
        self.segment_parts, _ = SegmentLayers(self._layers_desc, S * V,
                                              seg_method).do_segment()
        self._stage_of = []
        for k in range(S * V):
            self._stage_of += [k % S] * (self.segment_parts[k + 1]
                                         - self.segment_parts[k])
        # this rank's chunks: part c S + s for each chunk c
        self._chunk_items = [list(range(self.segment_parts[c * S + self._stage],
                                        self.segment_parts[c * S
                                                           + self._stage + 1]))
                             for c in range(V)]
        self._shared = {}
        built, fwds = {}, {}
        for idx in [i for chunk in self._chunk_items for i in chunk]:
            desc = self._layers_desc[idx]
            fwd = None
            if isinstance(desc, SharedLayerDesc):
                if desc.layer_name not in self._shared:
                    self._shared[desc.layer_name] = desc.build_layer()
                layer = self._shared[desc.layer_name]
                fwd = desc.forward_func
            elif isinstance(desc, LayerDesc):
                layer = desc.build_layer()
            else:
                layer = desc
            built[str(idx)] = layer
            fwds[idx] = fwd
        self.run_function = nn.ModuleDict(
            {k: v for k, v in built.items() if isinstance(v, nn.Module)})
        self._callables = built
        self._forward_funcs = fwds
        self._shared_groups = self._sync_shared()

    # -- shared layers -------------------------------------------------------
    def _shared_stages(self, key):
        return sorted({self._stage_of[i] for i, d in
                       enumerate(self._layers_desc)
                       if isinstance(d, SharedLayerDesc)
                       and d.layer_name == key})

    def _sync_shared(self):
        """{key: group of the ranks of this pipe holding it}; the weights
        are broadcast from the group's first rank."""
        keys = []
        for d in self._layers_desc:
            if isinstance(d, SharedLayerDesc) and d.layer_name not in keys:
                keys.append(d.layer_name)
        groups = {}
        if self._hcg is None or self._num_stages == 1:
            return groups
        from ...collective import broadcast
        for key in keys:
            stages = self._shared_stages(key)
            if len(stages) < 2:
                continue
            g = stage_group(self._hcg, stages)
            if g is not None:
                groups[key] = g
                with torch.no_grad():
                    for p in self._shared[key].parameters():
                        broadcast(p.data, src=g.ranks[0], group=g)
        return groups

    def allreduce_shared_weight_gradients(self):
        """Sum each shared layer's gradients over the ranks holding it."""
        from ...collective import all_reduce
        for key, g in self._shared_groups.items():
            for p in self._shared[key].parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                all_reduce(p.grad, group=g)

    # -- the reference's queries -----------------------------------------------
    def get_stage_from_index(self, layer_idx):
        return self._stage_of[layer_idx]

    def get_num_stages(self):
        return self._num_stages

    @property
    def parameters_of_stage(self):
        out = [[] for _ in range(self._num_stages)]
        out[self._stage] = list(self.parameters())
        return out

    # -- compute -------------------------------------------------------------
    def run_chunk(self, chunk, x):
        """This rank's chunk ``chunk`` (its part chunk S + stage) on x."""
        for idx in self._chunk_items[chunk]:
            layer, fwd = self._callables[str(idx)], self._forward_funcs[idx]
            if fwd is not None:
                x = fwd(layer, x)
            elif isinstance(x, tuple):
                x = layer(*x)
            else:
                x = layer(x)
        return x

    def forward(self, input, chunk_id=None):
        """This rank's layers on ``input``: chunk ``chunk_id``, or its
        only chunk (the whole model at one stage)."""
        if chunk_id is None:
            if self._num_virtual > 1:
                raise ValueError("a PipelineLayer with virtual stages runs "
                                 "one chunk a call: pass chunk_id")
            chunk_id = 0
        return self.run_chunk(chunk_id, input)
