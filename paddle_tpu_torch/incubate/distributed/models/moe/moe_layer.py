"""MoELayer on one device (counterpart of paddle_tpu/incubate/distributed/
models/moe/moe_layer.py).

gate -> dispatch -> experts -> combine, forward(x [B, S, H]) -> [B, S, H]
with the gate's auxiliary loss on ``gate.loss``. Two dispatch modes:

- ``"capacity"`` (the GShard formulation): each route gets a slot in a
  static buffer of C = max(8, ceil(cf * N * k / E)) rows per expert,
  ranked by one-hot cumsums; the experts run as batched products over
  [E, C, H] and routes past C drop.
- ``"grouped"`` (dropless): routes are placed by expert into tile-aligned
  groups (kernels/grouped_matmul.grouped_metadata), up -> act -> down run
  through the grouped-matmul CUDA kernels over exactly the routed rows,
  and the combine weighs each route's row by its gate value (float32
  sum, cast back to the activation dtype). ``expert_quant`` "int8" or
  "fp8" swaps both products for the quantized grouped kernel (quantized
  forward, full-precision gradients). The routing never leaves the card.

Every routing index is int32. A moe_group or mp_group (the expert-parallel
exchange), dispatch_compress and expert sharding are not ported and
raise; the routing telemetry is not ported.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .....framework.device import resolve_device, seed
from .....kernels.grouped_matmul import (_onehot_ranks, default_block_m,
                                         grouped_matmul, grouped_metadata)
from .....kernels.quant_matmul import (get_matmul_quant,
                                       quantized_grouped_linear)
from .dispatch import _ACTS
from .gate import GShardGate, NaiveGate, SwitchGate

__all__ = ["MoELayer", "ExpertMLP"]


def _route(topk_idx, num_expert, capacity):
    """(pos [N, k] int32, valid [N, k] float32): each route's rank among
    the routes to its expert in token-major order, and whether it fits
    the capacity."""
    n, k = topk_idx.shape
    _, pos = _onehot_ranks(topk_idx.reshape(n * k), num_expert)
    valid = (pos < capacity).float()
    return pos.clamp(0, capacity - 1).reshape(n, k), valid.reshape(n, k)


def _moe_scatter(x, topk_idx, pos, valid, num_expert, capacity):
    """x [N, H] -> expert buffers [E, C, H]: each capacity slot takes the
    route index that lands there (a scatter-max of int32 route ids, with
    dropped routes sent to one trash slot past the end), then the rows are
    gathered; an empty slot is 0."""
    n, h = x.shape
    k = topk_idx.shape[1]
    dev = x.device
    routes = torch.arange(n * k, dtype=torch.int32, device=dev)
    e = topk_idx.reshape(-1).to(torch.int32)
    c = pos.reshape(-1).to(torch.int32)
    ok = valid.reshape(-1) > 0
    trash = num_expert * capacity
    slot = torch.where(ok, e * capacity + c, torch.full_like(e, trash))
    slot_route = torch.full((trash + 1,), -1, dtype=torch.int32, device=dev)
    slot_route = slot_route.scatter_reduce(
        0, slot.long(), torch.where(ok, routes, torch.full_like(routes, -1)),
        reduce="amax")[:trash]
    filled = slot_route >= 0
    tok = slot_route.clamp(0, n * k - 1) // k
    rows = torch.where(filled[:, None], x.index_select(0, tok.long()),
                       torch.zeros((), dtype=x.dtype, device=dev))
    return rows.reshape(num_expert, capacity, h)


def _moe_gather(expert_out, topk_val, topk_idx, pos, valid, out_dtype):
    """Combine: each token sums its routes' expert rows weighed by gate
    value x valid, in float32, cast to the activation dtype."""
    n, k = topk_idx.shape
    picked = expert_out[topk_idx.reshape(-1).long(), pos.reshape(-1).long()]
    w = (topk_val.float() * valid).reshape(n * k, 1)
    out = (picked.float() * w).reshape(n, k, -1).sum(1)
    return out.to(out_dtype)


def _grouped_ffn(flat, topk_val, topk_idx, w1, b1, w2, b2, num_expert, bm,
                 act, qdtype=None):
    """The dropless expert FFN: routes placed by expert into the
    tile-aligned buffer, up -> act -> down through the grouped kernels
    (or the quantized one), each route's row picked back and weighed by
    its gate value (float32 sum, activation dtype out)."""
    n, h = flat.shape
    k = topk_idx.shape[1]
    md = grouped_metadata(topk_idx.reshape(-1), num_expert, bm)
    tok = md["row_src"].clamp(min=0) // k
    # index_select, not x[idx]: its gradient is an index_add, where
    # indexing's is a sort-based scatter that costs milliseconds a layer
    buf = torch.where(md["row_valid"][:, None],
                      flat.index_select(0, tok.long()),
                      torch.zeros((), dtype=flat.dtype, device=flat.device))
    if qdtype:
        def gmm(x, w, b):
            return quantized_grouped_linear(
                x, w, b, group_offsets=md["offsets"],
                group_counts=md["counts"], qdtype=qdtype, bm=bm)
    else:
        def gmm(x, w, b):
            return grouped_matmul(x, w, b, group_offsets=md["offsets"],
                                  group_counts=md["counts"], bm=bm)
    hmid = _ACTS[act](gmm(buf, w1, b1))
    y = gmm(hmid, w2, b2)
    picked = y.index_select(0, md["dest"].long()).reshape(n, k, -1)
    out = (picked.float() * topk_val.float()[..., None]).sum(1)
    return out.to(flat.dtype)


class ExpertMLP(nn.Module):
    """Stacked FFN experts in the JAX package's layout: w1 [E, H, F],
    b1 [E, 1, F] -> act -> w2 [E, F, H], b2 [E, 1, H]; each drawn from
    U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""

    def __init__(self, num_expert, d_model, d_hidden, activation="gelu",
                 ep_axes=None, device=None, dtype=None, generator=None):
        super().__init__()
        if ep_axes:
            raise NotImplementedError("sharding the experts over a mesh "
                                      "axis is not ported to the PyTorch "
                                      "package yet")
        if activation not in _ACTS:
            raise ValueError(f"activation must be one of {sorted(_ACTS)}, "
                             f"got {activation!r}")
        dev = resolve_device(device)
        gen = seed(0, dev) if generator is None else generator
        self.num_expert = num_expert
        self.act_name = activation

        def param(shape, fan_in):
            bound = 1.0 / math.sqrt(fan_in)
            t = torch.empty(shape, device=dev, dtype=dtype)
            return nn.Parameter(t.uniform_(-bound, bound, generator=gen))

        self.w1 = param((num_expert, d_model, d_hidden), d_model)
        self.b1 = param((num_expert, 1, d_hidden), d_model)
        self.w2 = param((num_expert, d_hidden, d_model), d_hidden)
        self.b2 = param((num_expert, 1, d_model), d_hidden)

    def forward(self, x):
        # x: [E, C, H]
        h = _ACTS[self.act_name](torch.matmul(x, self.w1) + self.b1)
        return torch.matmul(h, self.w2) + self.b2


class _ExpertList(nn.Module):
    """A list of per-expert modules, each mapping [C, H] -> [C, H],
    applied to its slice of the capacity buffer."""

    def __init__(self, experts):
        super().__init__()
        self.experts = nn.ModuleList(list(experts))

    def forward(self, x):
        return torch.stack([exp(x[i]) for i, exp in enumerate(self.experts)])


_GATES = {"naive": NaiveGate, "switch": SwitchGate, "gshard": GShardGate}


class MoELayer(nn.Module):
    """gate + dispatch + experts + combine, built on ``device`` (default
    ``cuda``; raises without a card unless ``device="cpu"``), parameters
    drawn from ``generator`` (seed 0 when None)."""

    def __init__(self, d_model, experts=None, gate=None, moe_group=None,
                 mp_group=None, capacity_factor=1.25, num_expert=None,
                 d_hidden=None, top_k=2, dispatch_mode="capacity",
                 group_block="auto", dispatch_compress=None,
                 expert_quant="auto", device=None, dtype=None,
                 generator=None):
        super().__init__()
        if dispatch_mode not in ("capacity", "grouped"):
            raise ValueError(f"dispatch_mode must be 'capacity' or "
                             f"'grouped', got {dispatch_mode!r}")
        if dispatch_compress not in (None, "int8", "bf16"):
            raise ValueError(f"dispatch_compress must be None, 'int8' or "
                             f"'bf16', got {dispatch_compress!r}")
        for name, val in (("moe_group", moe_group), ("mp_group", mp_group),
                          ("dispatch_compress", dispatch_compress)):
            if val is not None:
                raise NotImplementedError(
                    f"MoELayer({name}=...) needs the expert-parallel "
                    f"exchange, which is not ported to the PyTorch package "
                    f"yet")
        if expert_quant == "auto":
            expert_quant = get_matmul_quant()
        if expert_quant not in (None, "int8", "fp8"):
            raise ValueError(f"expert_quant must be 'auto', None, 'int8' or "
                             f"'fp8', got {expert_quant!r}")
        if not (group_block == "auto" or isinstance(group_block, int)
                or (isinstance(group_block, (tuple, list))
                    and len(group_block) == 2
                    and all(isinstance(v, int) for v in group_block))):
            raise ValueError("group_block must be 'auto', an int bm, or a "
                             f"(bm, bn) pair, got {group_block!r}")
        dev = resolve_device(device)
        gen = seed(0, dev) if generator is None else generator
        self.dispatch_mode = dispatch_mode
        self.group_block = group_block
        self.dispatch_compress = dispatch_compress
        self.expert_quant = expert_quant
        self.d_model = d_model
        expert_list = experts if isinstance(experts, (list, tuple)) else None
        if isinstance(gate, str) or gate is None:
            name = gate or "gshard"
            if num_expert is None:
                num_expert = len(expert_list) if expert_list else 8
            gate = _GATES[name](d_model, num_expert,
                                topk=1 if name == "switch" else 2,
                                device=dev, dtype=dtype, generator=gen)
        self.gate = gate
        self.top_k = getattr(gate, "top_k", top_k)
        if experts is None:
            experts = ExpertMLP(gate.tot_expert, d_model,
                                d_hidden or 4 * d_model, device=dev,
                                dtype=dtype, generator=gen)
        elif expert_list is not None:
            if len(expert_list) != gate.tot_expert:
                raise ValueError(f"{len(expert_list)} experts != "
                                 f"{gate.tot_expert} gates")
            experts = _ExpertList(expert_list)
        self.experts = experts
        self.num_expert = gate.tot_expert
        self.capacity_factor = capacity_factor

    def _capacity(self, n_tokens):
        cap = int(math.ceil(self.capacity_factor * n_tokens * self.top_k
                            / self.num_expert))
        return max(8, cap)

    def _block_m(self):
        """The group alignment bm: group_block's bm, or default_block_m()
        for "auto". The kernels' column tile is fixed, so a pair's bn is
        not used."""
        gb = self.group_block
        if isinstance(gb, (tuple, list)):
            return int(gb[0])
        if isinstance(gb, int):
            return gb
        return default_block_m()

    def forward(self, x):
        b, s, h = x.shape
        flat = x.reshape(b * s, h)
        topk_val, topk_idx = self.gate(flat)
        if self.dispatch_mode == "grouped":
            exp = self.experts
            if not isinstance(exp, ExpertMLP):
                raise ValueError(
                    "dispatch_mode='grouped' runs stacked ExpertMLP experts "
                    "through the grouped kernel; list-of-module experts "
                    "need dispatch_mode='capacity'")
            out = _grouped_ffn(flat, topk_val, topk_idx, exp.w1, exp.b1,
                               exp.w2, exp.b2, self.num_expert,
                               self._block_m(), exp.act_name,
                               self.expert_quant)
            return out.reshape(b, s, h)
        cap = self._capacity(b * s)
        pos, valid = _route(topk_idx, self.num_expert, cap)
        expert_in = _moe_scatter(flat, topk_idx, pos, valid,
                                 self.num_expert, cap)
        expert_out = self.experts(expert_in)
        out = _moe_gather(expert_out, topk_val, topk_idx, pos, valid,
                          x.dtype)
        return out.reshape(b, s, h)
