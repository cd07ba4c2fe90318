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

Every routing index is int32.

Expert parallelism: with an expert group (``moe_group``, or fleet's
``ep`` axis when its degree is above 1) the gate scores every expert,
each rank's ExpertMLP holds its ``E / ep`` of them (drawn as one process
draws all E, so a run at any ep degree starts from the same weights) and
each rank runs its own rows:

- ``"grouped"``: dispatch.moe_ep_forward, the all-to-all exchange to the
  experts' owners and home, under ``dispatch_compress`` (None, "bf16",
  "int8"; the process default is set by fleet.init from the strategy, or
  by ``configure_moe_dispatch``), with the layer's group alignment ``bm``
  and its ``expert_quant``;
- ``"capacity"``: the JAX package's capacity is one over the whole batch,
  max(8, ceil(cf * N * k / E)), and its routes rank in global token-major
  order, so which routes drop depends on every rank's tokens. The ranks
  all-gather the int32 [N_local, k] routes over the data world (the
  ranks with rows of their own; their group-rank order is the batch's
  order), rank every route globally, scatter their own into an [E, C, H]
  buffer, reduce-scatter it along E over the expert group (each slot has
  one writer, so the sum is exact), run their experts and all-gather the
  outputs back; each then picks its routes. The JAX package ignores
  ``dispatch_compress`` on this path; the port refuses it here.

Built under fleet with a data world of several ranks (dp, sharding,
ep), the gate averages its aux loss over that world in training with
gradients enabled and draws its random numbers for the whole batch
(gate.py), so a rank split computes what one process does; an eval or
no_grad forward without expert parallelism calls no collective.

Expert parameters carry ``expert = True`` (and ``no_sync``): their
gradients are summed over the expert replicas, not the data world
(fleet's wrappers and the sharding optimizer read the mark). mp_group,
a list of expert modules under expert parallelism and the routing
telemetry are not ported.
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
from .dispatch import (_ACTS, all_gather_rows, moe_ep_forward,
                       reduce_scatter_rows)
from .gate import GShardGate, NaiveGate, SwitchGate

__all__ = ["MoELayer", "ExpertMLP", "configure_moe_dispatch"]


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


def _fleet_hcg():
    from .....distributed.fleet.fleet import live_hcg
    return live_hcg()


def _group_of_axes(axes):
    """The expert group ``axes`` names: a Group, or a hybrid axis name
    ("ep", "sharding", ...) or a one-name tuple of fleet's topology; None
    for none or a one-rank group."""
    from .....distributed.collective import Group
    if axes is None:
        return None
    if isinstance(axes, Group):
        return axes if axes.nranks > 1 else None
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    if not names:
        return None
    if len(names) != 1:
        raise NotImplementedError(f"experts over several axes {names} are "
                                  f"not ported to the PyTorch package yet")
    hcg = _fleet_hcg()
    if hcg is None:
        raise ValueError(f"ep_axes={names} names an axis of fleet's hybrid "
                         f"topology: call fleet.init first, or pass a "
                         f"Group")
    g = hcg.get_axis_group(names[0])
    if g is None:
        raise ValueError(f"fleet's topology has no axis {names[0]!r}")
    return g if g.nranks > 1 else None


def _ep_axes(moe_group=None):
    """The expert group: an explicit ``moe_group`` (a Group), else fleet's
    ep axis when its degree is above 1, else None (every expert here).
    The JAX package falls back to its 'sharding' mesh axis as well; the
    port holds experts apart over the ep axis or moe_group only."""
    from .....distributed.collective import Group
    if moe_group is not None:
        if not isinstance(moe_group, Group):
            raise TypeError(f"moe_group must be a paddle_tpu_torch."
                            f"distributed Group, got "
                            f"{type(moe_group).__name__}")
        return _group_of_axes(moe_group)
    hcg = _fleet_hcg()
    if hcg is not None and hcg.get_expert_parallel_world_size() > 1:
        return hcg.get_expert_parallel_group()
    return None


def _data_group(ep_group):
    """The ranks whose rows the layer's batch is: fleet's data world when
    ``ep_group`` is fleet's ep group (or None and the data world has more
    than one rank), else the expert group itself; None for one rank."""
    hcg = _fleet_hcg()
    if hcg is not None:
        mine = hcg.get_expert_parallel_group()
        world = hcg.get_data_world_group()
        if ep_group is None or (mine is not None and
                                list(mine.ranks) == list(ep_group.ranks)):
            return world if world.nranks > 1 else None
    return ep_group


class ExpertMLP(nn.Module):
    """Stacked FFN experts in the JAX package's layout: w1 [E, H, F],
    b1 [E, 1, F] -> act -> w2 [E, F, H], b2 [E, 1, H]; each drawn from
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)). Under ``ep_axes`` (a Group, or an
    axis of fleet's topology such as ("ep",)) group rank r keeps experts
    r * E / ep ... (r + 1) * E / ep - 1 of the E drawn, and marks them
    ``expert``."""

    def __init__(self, num_expert, d_model, d_hidden, activation="gelu",
                 ep_axes=None, device=None, dtype=None, generator=None):
        super().__init__()
        ep = _group_of_axes(ep_axes)
        if ep is not None and num_expert % ep.nranks:
            raise ValueError(f"{num_expert} experts do not split over an "
                             f"expert group of {ep.nranks}")
        if activation not in _ACTS:
            raise ValueError(f"activation must be one of {sorted(_ACTS)}, "
                             f"got {activation!r}")
        dev = resolve_device(device)
        gen = seed(0, dev) if generator is None else generator
        self.num_expert = num_expert
        self.act_name = activation
        self.ep_group = ep
        el = num_expert // ep.nranks if ep is not None else num_expert
        lo = ep.rank * el if ep is not None else 0
        self.num_local_expert, self.expert_offset = el, lo

        def param(shape, fan_in):
            bound = 1.0 / math.sqrt(fan_in)
            t = torch.empty(shape, device=dev, dtype=dtype)
            t.uniform_(-bound, bound, generator=gen)
            if ep is None:
                return nn.Parameter(t)
            p = nn.Parameter(t[lo:lo + el].clone())
            p.expert = p.no_sync = True
            return p

        self.w1 = param((num_expert, d_model, d_hidden), d_model)
        self.b1 = param((num_expert, 1, d_hidden), d_model)
        self.w2 = param((num_expert, d_hidden, d_model), d_hidden)
        self.b2 = param((num_expert, 1, d_model), d_hidden)

    def forward(self, x):
        # x: [E_local, C, H]
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

# the process default of MoELayer's dispatch_compress: fleet.init sets it
# from DistributedStrategy.dispatch_compress every time (a re-init with
# the knob off turns it off)
_DISPATCH_DEFAULTS = {"compress": None}


def configure_moe_dispatch(compress="none"):
    """Set the default ``dispatch_compress`` of the MoELayers built from
    now on without one: "none" maps to None (the exact wire), None keeps
    the current value."""
    if compress is not None:
        if compress not in ("none", "int8", "bf16"):
            raise ValueError(f"dispatch_compress must be None, 'int8' or "
                             f"'bf16', got {compress!r}")
        _DISPATCH_DEFAULTS["compress"] = \
            None if compress == "none" else compress


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
        if dispatch_compress is None:
            dispatch_compress = _DISPATCH_DEFAULTS["compress"]
        if dispatch_compress not in (None, "int8", "bf16"):
            raise ValueError(f"dispatch_compress must be None, 'int8' or "
                             f"'bf16', got {dispatch_compress!r}")
        if mp_group is not None:
            raise NotImplementedError(
                "MoELayer(mp_group=...) is not ported to the PyTorch "
                "package (the JAX package accepts it and ignores it)")
        ep = _ep_axes(moe_group)
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
        self._ep = ep
        self._data = _data_group(ep)
        if self._data is not None and gate.group is None:
            # the aux loss and the random draws of the whole batch
            gate.group = self._data
        if experts is None:
            experts = ExpertMLP(gate.tot_expert, d_model,
                                d_hidden or 4 * d_model, ep_axes=ep,
                                device=dev, dtype=dtype, generator=gen)
        elif expert_list is not None:
            if ep is not None:
                raise NotImplementedError(
                    "a list of expert modules under expert parallelism is "
                    "not ported to the PyTorch package yet (ExpertMLP is)")
            if len(expert_list) != gate.tot_expert:
                raise ValueError(f"{len(expert_list)} experts != "
                                 f"{gate.tot_expert} gates")
            experts = _ExpertList(expert_list)
        elif ep is not None and getattr(experts, "ep_group", None) is None:
            raise ValueError("under expert parallelism the experts must be "
                             "an ExpertMLP built with ep_axes")
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
            if self._ep is not None:
                out = moe_ep_forward(
                    flat, topk_val, topk_idx, exp.w1, exp.b1, exp.w2,
                    exp.b2, group=self._ep, num_expert=self.num_expert,
                    bm=self._block_m(), act=exp.act_name,
                    compress=self.dispatch_compress,
                    qdtype=self.expert_quant)
            else:
                out = _grouped_ffn(flat, topk_val, topk_idx, exp.w1, exp.b1,
                                   exp.w2, exp.b2, self.num_expert,
                                   self._block_m(), exp.act_name,
                                   self.expert_quant)
            return out.reshape(b, s, h)
        if self._ep is not None:
            return self._capacity_ep(flat, topk_val, topk_idx,
                                     x.dtype).reshape(b, s, h)
        cap = self._capacity(b * s)
        pos, valid = _route(topk_idx, self.num_expert, cap)
        expert_in = _moe_scatter(flat, topk_idx, pos, valid,
                                 self.num_expert, cap)
        expert_out = self.experts(expert_in)
        out = _moe_gather(expert_out, topk_val, topk_idx, pos, valid,
                          x.dtype)
        return out.reshape(b, s, h)

    def _capacity_ep(self, flat, topk_val, topk_idx, out_dtype):
        """The capacity path under expert parallelism (module docstring):
        the JAX package's global capacity and drops."""
        from .....distributed.collective import _ag
        if self.dispatch_compress is not None:
            raise NotImplementedError(
                f"dispatch_compress={self.dispatch_compress!r} on the "
                f"capacity path is not ported (the JAX package ignores it "
                f"there); use dispatch_mode='grouped'")
        data, ep = self._data, self._ep
        n = flat.shape[0]
        idx = topk_idx.to(torch.int32).contiguous()
        every = idx.new_empty((data.nranks * n, idx.shape[1]))
        _ag(every.reshape(-1), idx.reshape(-1), data)
        cap = self._capacity(data.nranks * n)
        pos, valid = _route(every, self.num_expert, cap)
        mine = slice(data.rank * n, (data.rank + 1) * n)
        pos, valid = pos[mine], valid[mine]
        expert_in = _moe_scatter(flat, idx, pos, valid, self.num_expert, cap)
        local_out = self.experts(reduce_scatter_rows(expert_in, ep))
        expert_out = all_gather_rows(local_out, ep)
        return _moe_gather(expert_out, topk_val, idx, pos, valid, out_dtype)
