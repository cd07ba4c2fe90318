"""The rank side of the port's ZeRO and expert-parallel tests
(tests/test_torch_sharding.py, tests/test_torch_moe_ep.py).

Run through ``torch_dist_cases.start_world(..., module="torch_zero_cases")``:
each ``case_*`` runs in every rank of one gloo world on the CPU and returns
numpy arrays for the parent, which computes the JAX side. Like
torch_dist_cases.py this module imports neither JAX nor the JAX package.
Rank r of the data world takes row block r of the parent's batch.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from torch_dist_cases import _np, _t


def _fleet(n, device="cpu", **degrees):
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    hc = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1}
    hc.update({k: v for k, v in degrees.items() if k.endswith("_degree")})
    s.hybrid_configs = hc
    for k, v in degrees.items():
        if not k.endswith("_degree"):
            setattr(s, k, v)
    fleet.init(is_collective=True, strategy=s, device=device)
    return fleet, fleet.get_hybrid_communicate_group()


def _error(call):
    try:
        call()
    except (ValueError, NotImplementedError, TypeError) as e:
        return type(e).__name__, str(e)
    return None


# -- the expert-parallel MoE layer --------------------------------------------
def _moe_layer(inp, spec, group):
    from paddle_tpu_torch.incubate.distributed.models.moe import (
        GShardGate, MoELayer)
    h, e, f = inp["H"], inp["E"], inp["F"]
    gate = GShardGate(h, e, random_routing=spec.get("random", False),
                      device="cpu")
    layer = MoELayer(d_model=h, num_expert=e, d_hidden=f, gate=gate,
                     moe_group=group, dispatch_mode=spec["mode"],
                     capacity_factor=spec.get("cf", 1.25),
                     group_block=inp["bm"],
                     dispatch_compress=spec.get("compress"),
                     expert_quant=spec.get("quant"), device="cpu")
    exp = layer.experts
    lo, el = exp.expert_offset, exp.num_local_expert
    with torch.no_grad():
        gate.gate.weight.copy_(_t(inp["gate_w"]).t())
        gate.gate.bias.copy_(_t(inp["gate_b"]))
        for name in ("w1", "b1", "w2", "b2"):
            getattr(exp, name).copy_(_t(inp[name][lo:lo + el]))
    return layer


def case_moe_ep(rank, n, inp):
    """MoELayer(moe_group=fleet's ep group) at ep n: each configuration's
    forward on this rank's rows, loss mean(out^2) + coef * aux, and its
    gradients; ClipGradForMOEByGlobalNorm on the world's mean gradients;
    the ep all-to-all's counters; the options that still raise."""
    from paddle_tpu_torch.incubate.distributed.models.moe import (
        ClipGradForMOEByGlobalNorm, GShardGate, MoELayer)
    from paddle_tpu_torch.incubate.distributed.models.moe.dispatch import (
        dispatch_wire_bytes, ep_all_to_all)
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    import paddle_tpu_torch.distributed as dist
    fleet, hcg = _fleet(n, ep_degree=n)
    ep = hcg.get_expert_parallel_group()
    out = {"groups": (hcg.get_data_world_group().ranks,
                      hcg.get_expert_replica_group().ranks)}
    nloc = inp["x"].shape[0] // n
    from paddle_tpu_torch.incubate.distributed.models.moe import moe_layer
    route = moe_layer._route
    seen = []

    def spy(idx, e, cap):              # the capacity path's global routing
        pos, valid = route(idx, e, cap)
        seen.append(_np(valid))
        return pos, valid
    moe_layer._route = spy
    for name, spec in inp["configs"].items():
        layer = _moe_layer(inp, spec, ep)
        x = _t(inp["x"][rank * nloc:(rank + 1) * nloc]).requires_grad_()
        c0 = dict(ep_all_to_all.counters)
        seen.clear()
        y = layer(x)
        aux = layer.gate.get_loss()
        loss = (y ** 2).mean() + inp["aux_coef"] * aux
        loss.backward()
        c1 = dict(ep_all_to_all.counters)
        rec = {"out": _np(y), "aux": float(aux.detach()),
               "x_grad": _np(x.grad), "bm": layer._block_m(),
               "valid": seen[0] if seen else None,
               "expert_offset": layer.experts.expert_offset,
               "a2a_calls": c1["calls"] - c0["calls"],
               "a2a_bytes": c1["wire_bytes"] - c0["wire_bytes"],
               "priced_bytes": 2 * dispatch_wire_bytes(
                   n, nloc * x.shape[1] * 2, inp["H"], 4,
                   spec.get("compress")),
               "expert_marked": [bool(getattr(p, "expert", False))
                                 for p in layer.experts.parameters()]}
        for k, p in layer.named_parameters():
            rec["grad:" + k] = _np(p.grad)
        if name == inp["clip_config"]:
            # the data world's mean gradients, then the MoE clip
            pairs = []
            for k, p in layer.named_parameters():
                g = p.grad.clone()
                if getattr(p, "expert", False):
                    g /= n
                else:
                    dist.all_reduce(g)
                    g /= n
                pairs.append((p, g))
            clip = ClipGradForMOEByGlobalNorm(
                inp["clip_norm"],
                is_expert_param_func=lambda p: getattr(p, "expert", False),
                moe_group=ep)
            rec["clipped"] = {k: _np(g) for (k, _), (_, g) in zip(
                layer.named_parameters(), clip(pairs))}
        out[name] = rec
    moe_layer._route = route
    h, e, f = inp["H"], inp["E"], inp["F"]
    x = _t(inp["x"][:nloc])
    cap = _moe_layer(inp, {"mode": "capacity", "compress": "int8"}, ep)
    out["errors"] = {
        "mp_group": _error(lambda: MoELayer(
            d_model=h, num_expert=e, d_hidden=f, mp_group=ep,
            device="cpu")),
        "moe_group_type": _error(lambda: MoELayer(
            d_model=h, num_expert=e, d_hidden=f, moe_group=object(),
            device="cpu")),
        "expert_list": _error(lambda: MoELayer(
            d_model=h, experts=[nn.Linear(h, h) for _ in range(e)],
            gate="naive", moe_group=ep, device="cpu")),
        "capacity_compress": _error(lambda: cap(x)),
        "clip_without_func": _error(lambda: ClipGradForMOEByGlobalNorm(
            1.0, moe_group=ep)),
        "plain_clip_over_experts": _error(lambda: ClipGradByGlobalNorm(
            1.0)([(p, torch.ones_like(p))
                  for p in cap.experts.parameters()])),
        "odd_experts": _error(lambda: MoELayer(
            d_model=h, num_expert=e + 1, d_hidden=f, moe_group=ep,
            device="cpu")),
    }
    # the gate's world_size multiplies the experts it scores
    out["world_size_gate"] = GShardGate(h, e // n, world_size=n,
                                        device="cpu").tot_expert
    dist.barrier()
    return out


# -- ZeRO stages on a small residual MLP -----------------------------------------
class Block(nn.Module):
    def __init__(self, h, f):
        super().__init__()
        self.ln = nn.LayerNorm(h)
        self.fc1 = nn.Linear(h, f)
        self.fc2 = nn.Linear(f, h)

    def forward(self, x):
        return x + self.fc2(F.gelu(self.fc1(self.ln(x))))


class Net(nn.Module):
    """inp Linear -> blocks (a ModuleList) -> head Linear; the JAX side
    builds the same layers from paddle_tpu.nn."""

    def __init__(self, dims):
        super().__init__()
        d_in, h, f, d_out, nb = dims
        self.inp = nn.Linear(d_in, h)
        self.blocks = nn.ModuleList([Block(h, f) for _ in range(nb)])
        self.head = nn.Linear(h, d_out)

    def forward(self, x):
        x = self.inp(x)
        for b in self.blocks:
            x = b(x)
        return self.head(x)


class Partial(nn.Module):
    """Two Linear maps 4 -> 3 summed; the second only where ``use_b``
    (a parameter some ranks leave unreached)."""

    def __init__(self, use_b):
        super().__init__()
        self.a = nn.Linear(4, 3)
        self.b = nn.Linear(4, 3)
        self.use_b = use_b

    def forward(self, x):
        y = self.a(x)
        return y + self.b(x) if self.use_b else y


def _is_linear(name):
    return name.endswith("weight") and ("fc" in name or "inp" in name
                                        or "head" in name)


def _load(model, sd):
    with torch.no_grad():
        for k, p in model.named_parameters():
            a = _t(sd[k])
            p.copy_(a.t() if _is_linear(k) else a)


def _mse(out, y):
    return ((out - y) ** 2).mean()


def _sharded_run(model, opt, step_kind, x, y, steps, view=None):
    from paddle_tpu_torch import TrainStep
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding_optimizer \
        import zero_state_bytes
    step = TrainStep(model, _mse, opt)
    losses = [float(step((x,), (y,))) for _ in range(steps)]
    return losses, zero_state_bytes(opt, view if view is not None
                                    else model)


def _gathered(model, wrapper=None):
    """The whole parameters in the JAX layout (Linear weights [in, out])."""
    sd = wrapper.state_dict() if wrapper is not None else model.state_dict()
    return {k: _np(v).T if _is_linear(k) else _np(v) for k, v in sd.items()}


def case_sharding(rank, n, inp):
    """Three AdamW steps of the MLP under group_sharded_parallel at each
    level over the world, and under fleet (sharding 2 x dp 2: ShardingParallel
    and DygraphShardingOptimizer); the tiny GPT-MoE at ep 2 x sharding 2
    through GroupShardedOptimizerStage2; the options that still raise."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import SGD, AdamW
    from paddle_tpu_torch.distributed.sharding import (
        group_sharded_parallel, save_group_sharded_model)
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.framework.io import load
    out = {}
    nloc = inp["x"].shape[0] // n
    x = _t(inp["x"][rank * nloc:(rank + 1) * nloc])
    y = _t(inp["y"][rank * nloc:(rank + 1) * nloc])
    steps, lr = inp["steps"], inp["lr"]
    for level in ("os", "os_g", "p_g_os", "os_g_clip", "p_g_os_clip",
                  "os_g_buckets"):
        model = Net(inp["dims"])
        _load(model, inp["sd"])
        if level.endswith("_clip"):      # SGD: the clip shows in the step
            opt = SGD(learning_rate=inp["clip_lr"],
                      parameters=model.parameters(),
                      grad_clip=ClipGradByGlobalNorm(inp["clip_norm"]))
        else:
            opt = AdamW(learning_rate=lr, parameters=model.parameters())
        small = {"buffer_max_size": inp["bucket"]} \
            if level.endswith("_buckets") else {}
        wrapped, sopt, _ = group_sharded_parallel(
            model, opt, level.replace("_clip", "").replace("_buckets", ""),
            **small)
        losses, nbytes = _sharded_run(wrapped, sopt, level, x, y, steps,
                                      view=model)
        rec = {"losses": losses, "bytes": nbytes,
               "wrapper": type(wrapped).__name__,
               "params": _gathered(model, wrapped),
               "opt_state": {k: _np(v) for k, v in sopt.state_dict().items()
                             if isinstance(v, torch.Tensor)}}
        if level == "p_g_os":
            from paddle_tpu_torch.convert import zero_params_to_jax
            rec["jax_params"] = zero_params_to_jax(wrapped, _is_linear)
            save_group_sharded_model(wrapped, inp["save_dir"], sopt)
            dist.barrier()
            rec["saved"] = {k: _np(v) for k, v in load(
                inp["save_dir"] + "/model.pdmodel").items()}
            rec["all_params"] = [_np(p) for p in
                                 wrapped.get_all_parameters()]
        if level.startswith("os_g"):
            rec["buckets"] = len(wrapped._buckets.buckets)
        out[level] = rec
    out["unreached"] = _stage2_unreached(rank, n, inp["unreached"])
    # through fleet: sharding 2 x dp 2
    fleet, hcg = _fleet(n, sharding_degree=2, dp_degree=n // 2)
    model = Net(inp["dims"])
    _load(model, inp["sd"])
    wrapped = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(
        AdamW(learning_rate=lr, parameters=model.parameters()))
    losses, nbytes = _sharded_run(wrapped, opt, "fleet", x, y, steps,
                                  view=model)
    out["fleet"] = {"losses": losses, "bytes": nbytes,
                    "wrapper": type(wrapped).__name__,
                    "opt": type(opt._inner_opt).__name__,
                    "params": _gathered(model)}
    out["gpt_moe"] = _gpt_moe_ep_sharding(rank, n, inp["gpt_moe"])
    out["errors"] = _sharding_errors(n, inp)
    dist.barrier()
    return out


def _stage2_unreached(rank, n, inp):
    """GroupShardedStage2 over a model whose second map only rank 0 uses,
    in buckets of 15 values (b's parameters one bucket, a's the next):
    SGD steps of the mean of the ranks' losses."""
    from paddle_tpu_torch import SGD
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    model = Partial(rank == 0)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(_t(inp["sd"][k]))
    opt = SGD(learning_rate=inp["lr"], parameters=model.parameters())
    wrapped, sopt, _ = group_sharded_parallel(model, opt, "os_g",
                                              buffer_max_size=15)
    nloc = inp["x"].shape[0] // n
    rows = slice(rank * nloc, (rank + 1) * nloc)
    losses, _ = _sharded_run(wrapped, sopt, "os_g", _t(inp["x"][rows]),
                             _t(inp["y"][rows]), inp["steps"], view=model)
    return {"losses": losses, "buckets": len(wrapped._buckets.buckets),
            "params": {k: _np(p) for k, p in model.named_parameters()}}


def _gpt_moe_ep_sharding(rank, n, inp):
    """Configuration 4's composition at ep 2 x sharding 2: fleet.init,
    MoEGPT (its MoELayers take fleet's ep group), the stage-2 optimizer over
    AdamW, TrainStep."""
    from paddle_tpu_torch import AdamW, TrainStep
    from paddle_tpu_torch.convert import (moe_ep_params_from_jax,
                                          moe_ep_params_to_jax)
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        GroupShardedOptimizerStage2)
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding_optimizer \
        import zero_state_bytes
    from paddle_tpu_torch.models.gpt_moe import MoEGPT, gpt_moe_tiny, \
        moe_loss
    fleet, hcg = _fleet(n, ep_degree=2, sharding_degree=n // 2)
    cfg = gpt_moe_tiny(**inp["cfg"])
    model = MoEGPT(cfg, device="cpu")
    ep_rank = hcg.get_expert_parallel_rank()
    model.load_state_dict(moe_ep_params_from_jax(inp["sd"], cfg, ep_rank,
                                                 2))
    opt = GroupShardedOptimizerStage2(
        optim=AdamW(learning_rate=inp["lr"], parameters=model.parameters()))
    step = TrainStep(model, moe_loss, opt)
    nloc = inp["ids"].shape[0] // n
    rows = slice(hcg.get_data_world_group().rank * nloc,
                 (hcg.get_data_world_group().rank + 1) * nloc)
    ids, labels = _t(inp["ids"][rows]), _t(inp["labels"][rows])
    losses = [float(step((ids,), (labels,))) for _ in range(inp["steps"])]
    return {"losses": losses, "ep_rank": ep_rank,
            "jax_params": moe_ep_params_to_jax(model),
            "bytes": zero_state_bytes(opt, model)}


def _sharding_errors(n, inp):
    from paddle_tpu_torch import AdamW
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        DygraphShardingOptimizer, GroupShardedOptimizerStage2,
        GroupShardedStage3)
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.nn.clip import ClipGradByNorm

    def model_opt(**kw):
        m = Net(inp["dims"])
        return m, AdamW(learning_rate=1e-3, parameters=m.parameters(), **kw)

    def stage2_clip():
        from paddle_tpu_torch import TrainStep
        m, o = model_opt(grad_clip=ClipGradByNorm(1.0))
        w, so, _ = group_sharded_parallel(m, o, "os_g")
        TrainStep(w, _mse, so)((_t(inp["x"][:2]),), (_t(inp["y"][:2]),))

    def strategy(**kw):
        _fleet(n, **kw)

    return {
        "offload": _error(lambda: DygraphShardingOptimizer(
            model_opt()[1], offload=True)),
        "stage3_offload": _error(lambda: GroupShardedStage3(
            *model_opt(), offload=True)),
        "subset": _error(lambda: GroupShardedOptimizerStage2(
            params=list(model_opt()[0].parameters())[:2],
            optim=model_opt()[1])),
        "level": _error(lambda: group_sharded_parallel(
            *model_opt(), level="p_g")),
        "grad_compress": _error(lambda: strategy(
            sharding_degree=2, dp_degree=n // 2, grad_compress="int8")),
        "sharding_mp": _error(lambda: strategy(
            sharding_degree=2, mp_degree=n // 2)),
        "ep_pp": _error(lambda: strategy(ep_degree=2, pp_degree=n // 2)),
        "sep": _error(lambda: strategy(sep_degree=n)),
        "stage2_clip_by_norm": _error(stage2_clip),
    }


CASES = {"moe_ep": case_moe_ep, "sharding": case_sharding}
