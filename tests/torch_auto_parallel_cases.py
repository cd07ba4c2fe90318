"""The rank side of the port's auto-parallel tests
(tests/test_torch_auto_parallel.py, tests/test_torch_semi_auto_llama.py).

Run through ``torch_dist_cases.start_world(..., module=
"torch_auto_parallel_cases")``: each ``case_*`` runs in every rank of one
gloo world of 4 ranks on the CPU and returns numpy arrays and plain values
for the parent, which computes the JAX side. The mesh is [[0, 1], [2, 3]]:
rank r sits at mesh coordinate (r // 2, r % 2). Every rank is handed the
whole of each input (the global value) and keeps its shard. Like
torch_dist_cases.py this module imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from torch_dist_cases import _np, _t

MESH = [[0, 1], [2, 3]]


def _error(call):
    try:
        call()
    except (ValueError, NotImplementedError, TypeError) as e:
        return type(e).__name__
    return None


def _load(model, sd, linear=("weight",)):
    """A torch module's parameters from a JAX state dict (numpy, paddle's
    layout: Linear weights transposed)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            a = sd[name]
            is_lin = isinstance(_owner(model, name), torch.nn.Linear) and \
                name.endswith(linear)
            p.copy_(_t(a.T if is_lin else a))
    return model


def _owner(model, name):
    return model.get_submodule(name.rsplit(".", 1)[0]) if "." in name \
        else model


def _mlp(widths, sd):
    """Linear layers with ReLU between them (one bare Linear for two
    widths), loaded from the JAX model's state dict."""
    from paddle_tpu_torch import nn as pnn
    if len(widths) == 2:
        return _load(torch.nn.Linear(*widths), sd)
    layers = []
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        if i:
            layers.append(pnn.ReLU())
        layers.append(torch.nn.Linear(a, b))
    return _load(pnn.Sequential(*layers), sd)


# -- the API cases (tests/test_torch_auto_parallel.py) ------------------------
def case_api(rank, n, inp):
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.distributed.auto_parallel import paddle_placements
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import SGD, AdamW
    mesh = dist.ProcessMesh(np.array(MESH), dim_names=["x", "y"])
    out = {"coord": (rank // 2, rank % 2)}

    d = dist.shard_tensor(_t(inp["a"]), mesh, [dist.Shard(0), dist.Shard(1)])
    out["placements"] = {"is_shard0": d.placements[0].is_shard(0),
                         "mesh_is": d.process_mesh is mesh,
                         "local": _np(d.to_local()),
                         "full": _np(d.full_tensor())}

    def plc(spec):
        return [dist.Shard(spec) if spec is not None else dist.Replicate()]
    out["reshard"] = {}
    for src, dst in inp["pairs"]:
        s = dist.shard_tensor(_t(inp["b"]), mesh, plc(src))
        r = dist.reshard(s, mesh, plc(dst))
        out["reshard"][(src, dst)] = {"full": _np(r.full_tensor()),
                                      "local": _np(r.to_local()),
                                      "placements": str(r.placements)}

    x = dist.shard_tensor(_t(inp["mx"]), mesh, [dist.Shard(0)])
    w = dist.shard_tensor(_t(inp["mw"]), mesh,
                          [dist.Replicate(), dist.Shard(1)])
    w.requires_grad_(True)
    y = torch.matmul(x, w)
    (y ** 2).mean().backward()
    out["matmul"] = {"y": _np(y.full_tensor()),
                     "grad": _np(w.grad.full_tensor()),
                     "grad_local_shape": tuple(w.grad.to_local().shape),
                     "w_local_shape": tuple(w.to_local().shape)}

    m = _mlp((8, 16, 8), inp["layer_sd"])

    def shard_fn(name, sub, pm):
        for p in getattr(sub, "_parameters", {}).values():
            if p is not None and p.ndim == 2:
                dist.shard_tensor(p, pm, [dist.Replicate(), dist.Shard(1)])

    dist.shard_layer(m, mesh, shard_fn)
    opt = dist.shard_optimizer(AdamW(0.01, parameters=m.parameters()))
    lx = dist.shard_tensor(_t(inp["lx"]), mesh, [dist.Shard(0)])
    ly = _t(inp["ly"])
    losses = []
    for _ in range(inp["layer_steps"]):
        loss = pnn.functional.mse_loss(m(lx), ly)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    accs = list(opt._inner._accumulators.items())
    by_id = {id(p): p for p in m.parameters()}
    out["shard_layer"] = {
        "losses": losses,
        "n_accs": len(accs),
        "accs_follow": all(tuple(v.placements) == tuple(by_id[pid].placements)
                           for (_, pid), v in accs),
        "weight_placements": [str(paddle_placements(m[0].weight)),
                              str(m[0].weight.placements)]}

    out["optimizers"] = _optimizers_over_dtensors(mesh, inp, shard_fn, lx,
                                                  ly)
    # a TrainStep built before shard_layer steps the DTensor parameters
    m = _mlp((8, 16, 8), inp["layer_sd"])
    step = TrainStep(m, pnn.functional.mse_loss,
                     SGD(0.1, parameters=m.parameters(), weight_decay=0.01))
    dist.shard_layer(m, mesh, shard_fn)
    out["train_step"] = {
        "losses": [float(step((lx,), (ly,)))
                   for _ in range(inp["opt_steps"])],
        "params": _whole_params(m),
        "holds": [a is b for a, b in zip(step._params, m.parameters())]}

    m = _mlp((8, 8, 8), inp["static_sd"])
    dm, _ = dist.to_static(m, None, pnn.MSELoss(),
                           SGD(0.05, parameters=m.parameters()))
    sx, sy = _t(inp["sx"]), _t(inp["sy"])
    train = [float(dm(sx, sy)) for _ in range(inp["static_calls"])]
    dm.eval()
    out["to_static"] = {"train": train, "eval": float(dm(sx, sy))}

    data = [(_t(a), _t(b)) for a, b in inp["loader"]]
    batches = list(dist.shard_dataloader(data, mesh, shard_dims="x"))
    xb, yb = batches[0]
    out["dataloader"] = {"n": len(batches),
                         "is_shard0": xb.placements[0].is_shard(0),
                         "local": _np(xb.to_local()),
                         "y_local": _np(yb.to_local())}

    out["partial"] = [
        _error(lambda: dist.shard_tensor(_t(inp["a"]), mesh,
                                         [dist.Partial()])),
        _error(lambda: dist.reshard(d, mesh, [dist.Partial()]))]

    m = _mlp((4, 4), inp["predict_sd"])
    dm, _ = dist.to_static(m)
    dm.eval()
    px = _t(inp["px"])
    out["predict"] = {"dm": _np(dm(px)), "direct": _np(m(px))}

    m = _mlp((8, 8), inp["opt_sd"])
    calls = []

    def acc_fn(accname, param, acc):
        calls.append(accname)
        return acc

    opt = dist.shard_optimizer(AdamW(0.01, parameters=m.parameters()),
                               acc_fn)
    (m(_t(inp["ox"])) ** 2).mean().backward()
    opt.step()
    out["shard_opt_fn"] = {
        "calls": sorted(set(calls)),
        "stage_markers": [
            _error(lambda s=s: dist.shard_optimizer(
                AdamW(0.01, parameters=m.parameters()), s(mesh=mesh)))
            for s in (dist.ShardingStage1, dist.ShardingStage2,
                      dist.ShardingStage3)]}

    u = dist.unshard_dtensor(d)
    out["unshard"] = {"mesh": u.process_mesh,
                      "is_dense": type(u) is torch.Tensor,
                      "values": _np(u)}

    # the rerouted functional all-gather's body (a gloo rank on a card
    # routes DTensor's all-gathers to it) over the mesh's "x" groups
    from paddle_tpu_torch.distributed import collective
    group = mesh.device_mesh().get_group(0)
    out["c10d_gather"] = _np(collective._c10d_all_gather(
        torch.full((1, 3), float(rank)), 2, group.group_name))

    out["layout"] = _megatron_layout(mesh, inp["llama"])
    out["too_big"] = _error(lambda: dist.ProcessMesh(
        np.arange(8).reshape(2, 4), ["a", "b"]).device_mesh())
    return out


def _whole_params(model):
    """{name: whole parameter} in the JAX package's layout (2-D Linear
    weights transposed back); gathering a DTensor is a collective."""
    out = {}
    for name, p in model.named_parameters():
        a = _np(p.full_tensor() if hasattr(p, "full_tensor") else p)
        out[name] = a.T if a.ndim == 2 else a
    return out


def _optimizers_over_dtensors(mesh, inp, shard_fn, lx, ly):
    """SGD, Momentum and AdamW with ClipGradByGlobalNorm (below the
    gradients' norm: every step clips) over the sharded MLP, each built
    before shard_layer, and the same steps on the dense MLP: (dense,
    sharded) losses and whole parameters after the steps."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.optimizer import SGD, AdamW, Momentum
    makers = {
        "sgd": lambda ps: SGD(0.1, parameters=ps, weight_decay=0.01),
        "momentum": lambda ps: Momentum(0.1, 0.9, parameters=ps,
                                        use_nesterov=True,
                                        weight_decay=0.01),
        "adamw_clip": lambda ps: AdamW(
            0.01, parameters=ps,
            grad_clip=pnn.ClipGradByGlobalNorm(inp["clip_norm"]))}
    res = {}
    for name, make in makers.items():
        runs = []
        for sharded in (False, True):
            m = _mlp((8, 16, 8), inp["layer_sd"])
            opt = make(list(m.parameters()))
            x = _t(inp["lx"])
            if sharded:
                dist.shard_layer(m, mesh, shard_fn)
                x = lx
            losses = []
            for _ in range(inp["opt_steps"]):
                loss = pnn.functional.mse_loss(m(x), ly)
                loss.backward()
                opt.step()
                opt.clear_grad()
                losses.append(float(loss))
            runs.append((losses, _whole_params(m)))
        res[name] = runs
    return res


def _megatron_layout(mesh, kw):
    """Each rank's local q_proj / o_proj weight shapes and the Paddle
    placements it reads back, after the reference's megatron shard_fn."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.auto_parallel import paddle_placements
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    pm = dist.ProcessMesh(np.array(MESH), dim_names=["dp", "mp"])
    model = LlamaForCausalLM(LlamaConfig(**kw), device="cpu")
    dist.shard_layer(model, pm, megatron_shard_fn())
    attn = model.llama.layers[0].self_attn
    return {"q_local": tuple(attn.q_proj.weight.to_local().shape),
            "o_local": tuple(attn.o_proj.weight.to_local().shape),
            "q_paddle": str(paddle_placements(attn.q_proj.weight)),
            "o_paddle": str(paddle_placements(attn.o_proj.weight)),
            "q_torch": str(attn.q_proj.weight.placements)}


def megatron_shard_fn():
    """The reference's megatron shard_fn (tests/test_semi_auto_llama.py),
    verbatim but for the import: Paddle's layout."""
    from paddle_tpu_torch.distributed.auto_parallel import (Replicate,
                                                            Shard,
                                                            shard_tensor)
    col = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
    row = ("o_proj", "down_proj")

    def fn(name, sublayer, pm):
        for pname, p in sublayer._parameters.items():
            if p is None:
                continue
            leaf = name.rsplit(".", 1)[-1]
            if p.ndim == 2 and leaf in col:
                shard_tensor(p, pm, [Replicate(), Shard(1)])
            elif p.ndim == 2 and leaf in row:
                shard_tensor(p, pm, [Replicate(), Shard(0)])
            else:
                shard_tensor(p, pm, [Replicate(), Replicate()])

    return fn


# -- the semi-auto Llama (tests/test_torch_semi_auto_llama.py) -----------------
def _llama(inp, kv, sd):
    from paddle_tpu_torch.convert import params_from_jax
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    cfg = LlamaConfig(**dict(inp["cfg"], num_key_value_heads=kv))
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(sd, cfg))
    # built before shard_layer, as the reference builds it
    opt = AdamW(learning_rate=inp["lr"], parameters=model.parameters())
    return model, opt


def _ce(logits, labels):
    from paddle_tpu_torch.nn.functional.loss import cross_entropy
    v = logits.shape[-1]
    return cross_entropy(logits.reshape(-1, v).float(), labels.reshape(-1))


def _train(model, opt, batches):
    losses = []
    for x in batches:
        loss = _ce(model(x), x)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses


def _grad_layout(model, data_axis_partial):
    """(name, what differs) for each split parameter whose gradient is not
    its shard: local shape, or placements (a Partial over the data axis
    allowed when ``data_axis_partial``)."""
    bad = []
    for name, p in model.named_parameters():
        if not any(pl.is_shard() for pl in p.placements):
            continue
        g = p.grad
        if tuple(g.to_local().shape) != tuple(p.to_local().shape):
            bad.append((name, "local shape"))
        want = list(p.placements)
        got = list(g.placements)
        if data_axis_partial and got[0].is_partial():
            got[0] = want[0]
        if got != want:
            bad.append((name, str(g.placements)))
    return bad


def _accum_master_grad(inp, kv, sd, mesh, batches):
    """TrainStep(accum_steps=2, master_grad=True) over the bf16 model
    (weights ``sd``: the JAX package's bf16 ones), dense and sharded: the
    losses, the whole parameters after the steps (rank 0), and for each
    step the gradients the optimizer was handed (dtype, and whether a
    DTensor one is laid out as its parameter)."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.convert import semi_auto_params_to_jax
    from paddle_tpu_torch.jit import TrainStep
    bf16 = dict(inp, cfg=dict(inp["cfg"], dtype="bfloat16"))
    res = {}
    for sharded in (False, True):
        model, opt = _llama(bf16, kv, sd)
        if sharded:
            dist.shard_layer(model, mesh, shard_fn=megatron_shard_fn())
        handed = []
        inner = opt.step

        def spy(grads=None, inner=inner, model=model, handed=handed):
            by_id = {id(p): p for p in model.parameters()}
            handed.append(sorted(
                (str(g.dtype), not hasattr(g, "placements")
                 or tuple(g.placements) == tuple(by_id[k].placements))
                for k, g in grads.items()))
            return inner(grads=grads)

        opt.step = spy
        step = TrainStep(model, _ce, opt, accum_steps=2, master_grad=True)
        losses = [float(step((x,), (x,))) for x in batches]
        params = semi_auto_params_to_jax(model)     # a collective
        res["sharded" if sharded else "dense"] = {
            "losses": losses, "handed": handed,
            "params": params if dist.get_rank() == 0 else None,
            "param_dtypes": sorted({str(p.dtype)
                                    for p in model.parameters()})}
    return res


def case_semi_auto_llama(rank, n, inp):
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.convert import semi_auto_params_to_jax
    from paddle_tpu_torch.nn.functional.flash_attention import flash_attention
    mesh = dist.ProcessMesh(np.array(MESH), dim_names=["dp", "mp"])
    batches = [_t(a).long() for a in inp["ids"]]
    out = {}
    for kv, sd in inp["sd"].items():
        model, opt = _llama(inp, kv, sd)
        out[f"dense_{kv}"] = _train(model, opt, batches)
        model, opt = _llama(inp, kv, sd)
        dist.shard_layer(model, mesh, shard_fn=megatron_shard_fn())
        out[f"opt_holds_{kv}"] = [
            a is b for a, b in zip(opt._parameter_list, model.parameters())]
        before = dict(flash_attention.route_launches)
        out[f"semi_{kv}"] = _train(model, opt, batches)
        out[f"flash_calls_{kv}"] = {
            k: v - before[k] for k, v in flash_attention.route_launches.items()}
        params = semi_auto_params_to_jax(model)     # a collective
        out[f"params_{kv}"] = params if rank == 0 else None
        if kv == inp["cfg"]["num_key_value_heads"]:
            out["local_q_rows"] = \
                model.llama.layers[0].self_attn.q_proj.weight.to_local().shape
            _ce(model(batches[0]), batches[0]).backward()
            out["grad_layout"] = _grad_layout(model, False)
            opt.clear_grad()

    kv = inp["cfg"]["num_key_value_heads"]
    sd = inp["sd"][kv]
    model, opt = _llama(inp, kv, sd)
    dist.shard_layer(model, mesh, shard_fn=megatron_shard_fn())
    loader = dist.shard_dataloader([(b,) for b in batches], mesh,
                                   shard_dims="dp")
    losses = []
    for (x,) in loader:
        loss = _ce(model(x), x)
        loss.backward()
        if not losses:
            out["dp_local_rows"] = x.to_local().shape[0]
            out["dp_grad_layout"] = _grad_layout(model, True)
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    out["dp_sharded"] = losses

    model, opt = _llama(inp, kv, sd)
    dist.shard_layer(model, mesh, shard_fn=megatron_shard_fn())
    strategy = dist.Strategy({"gradient_merge": {"enable": True,
                                                 "k_steps": 2}})
    loader = dist.shard_dataloader([(b, b) for b in batches], mesh,
                                   shard_dims="dp")
    dm, loader = dist.to_static(model, loader, _ce, opt, strategy)
    # each rank's 2 rows cut into the 2 microbatches
    out["dist_model"] = [float(dm(x, y)) for x, y in loader]
    out["dist_model_accum"] = dm._step.accum_steps

    out["master_grad"] = _accum_master_grad(inp, kv, inp["sd_bf16"], mesh,
                                            batches)

    w = _t(inp["w"])
    s = dist.shard_tensor(w, mesh, [dist.Shard(0), dist.Shard(1)])
    r = dist.reshard(s, mesh, [dist.Replicate(), dist.Shard(0)])
    back = dist.reshard(r, mesh, [dist.Replicate(), dist.Replicate()])
    out["roundtrip"] = _np(back.to_local())
    return out


CASES = {"api": case_api, "semi_auto_llama": case_semi_auto_llama}
