"""The rank side of the port's distributed tests (tests/test_torch_*.py).

A test starts a world with ``start_world`` (``distributed.spawn``, start
method ``spawn``, rendezvous through a FileStore under the test's tmp
directory, gloo on the CPU, one thread a rank) and collects each rank's
result with ``finish_world``: every join and every collective has a time
limit, and a rank that fails fails the test with its traceback. This
module imports neither JAX nor the JAX package, so a spawned rank, which
unpickles its function from here, never loads them; the parent test
computes the JAX side and compares.

Each ``case_*`` function runs in every rank of one world and returns a
dict of numpy arrays (or plain values) for the parent. Inputs come from
the parent as numpy arrays stacked rank-major: rank r takes row r, as
rank r of the reference's stacked (single-controller) call does.
"""
from __future__ import annotations

import importlib
import os
import pickle
import traceback

import numpy as np
import torch

TIMEOUT_S = 120          # a world's join; each collective gets 60 s


def start_world(n, case, payload, tmpdir, module=None):
    """Spawn ``n`` ranks running ``case`` (of this module's CASES, or of
    the CASES of the rank-side ``module`` named) on ``payload``; returns a
    handle for finish_world."""
    from paddle_tpu_torch.distributed import spawn
    tmpdir = str(tmpdir)
    store = os.path.join(tmpdir, f"store_{case}_{n}")
    # the payload goes through a file: arguments pickled into a spawned
    # process cost seconds a megabyte
    path = os.path.join(tmpdir, f"{case}_{n}_payload.pkl")
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    procs = spawn(_rank_main, args=(case, path, tmpdir, module), nprocs=n,
                  join=False, master=f"file://{store}", gpus=[0] * n)
    return n, case, tmpdir, procs


def finish_world(handle):
    """Join a world started by start_world; returns its ranks' results
    in rank order, or raises with the failing ranks' tracebacks."""
    from paddle_tpu_torch.distributed.misc import join_all
    n, case, tmpdir, procs = handle
    try:
        join_all(procs, TIMEOUT_S)
    except RuntimeError as e:
        errs = []
        for r in range(n):
            path = os.path.join(tmpdir, f"{case}_{n}_err{r}.txt")
            if os.path.exists(path):
                errs.append(f"rank {r}:\n" + open(path).read())
        raise RuntimeError(f"{case} at world {n}: {e}\n" + "\n".join(errs))
    out = []
    for r in range(n):
        with open(os.path.join(tmpdir, f"{case}_{n}_r{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def run_world(n, case, payload, tmpdir, module=None):
    return finish_world(start_world(n, case, payload, tmpdir, module))


def _rank_main(case, payload_path, tmpdir, module=None):
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    n = int(os.environ["PADDLE_TRAINERS_NUM"])
    os.environ["PADDLE_COMM_TIMEOUT"] = "60"
    torch.set_num_threads(1)
    try:
        with open(payload_path, "rb") as f:
            payload = pickle.load(f)
        import paddle_tpu_torch.distributed as dist
        dist.init_parallel_env(device="cpu")
        cases = CASES if module is None else \
            importlib.import_module(module).CASES
        out = cases[case](rank, n, payload)
        with open(os.path.join(tmpdir, f"{case}_{n}_r{rank}.pkl"),
                  "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmpdir, f"{case}_{n}_err{rank}.txt"),
                  "w") as f:
            f.write(traceback.format_exc())
        raise


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy().copy()
    return t


def _t(a):
    """A tensor of its own (the payload's arrays are shared by cases)."""
    return torch.from_numpy(np.array(a, copy=True))


# -- collectives --------------------------------------------------------------
def case_collectives(rank, n, inp):
    """Every collective of the API on this rank's rows of ``inp``."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import ReduceOp
    from paddle_tpu_torch.distributed.communication import stream
    out = {}
    ops = {"sum": ReduceOp.SUM, "max": ReduceOp.MAX, "min": ReduceOp.MIN,
           "prod": ReduceOp.PROD, "avg": ReduceOp.AVG}
    for key, x in inp["all_reduce"].items():
        name, opname = key.rsplit(":", 1)
        t = _t(x[rank]).clone()
        ret = dist.all_reduce(t, op=ops[opname])
        assert ret is t                       # in place, returned
        out[f"all_reduce:{key}"] = _np(t)
    for key, x in inp["compressed"].items():
        api, comp, opname, _ = key.split(":", 3)
        t = _t(x[rank]).clone()
        if api == "all_reduce":
            dist.all_reduce(t, op=ops[opname], compress=comp)
            out[f"compressed:{key}"] = _np(t)
        elif api == "reduce_scatter":
            o = t.new_empty((t.shape[0] // n,) + tuple(t.shape[1:]))
            dist.reduce_scatter(o, t, op=ops[opname], compress=comp)
            out[f"compressed:{key}"] = _np(o)
        else:
            out[f"compressed:{key}"] = _np(dist.alltoall(t, compress=comp))
    x = _t(inp["gather"][rank])
    parts = []
    assert dist.all_gather(parts, x) is parts
    out["all_gather:list"] = np.stack([_np(p) for p in parts])
    out["all_gather:axis1"] = _np(dist.all_gather(None, x, axis=1))
    objs = []
    dist.all_gather_object(objs, {"rank": rank, "sq": rank * rank})
    out["all_gather_object"] = objs
    out["gather"] = np.stack([_np(p) for p in dist.gather(x, dst=0)])
    t = x.clone()
    dist.reduce(t, dst=1, op=ReduceOp.SUM)
    out["reduce:dst1"] = _np(t)
    for key, xs in inp["reduce_scatter"].items():
        src = _t(xs[rank])
        o = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
        opname = key.rsplit(":", 1)[1]
        dist.reduce_scatter(o, src, op=ops[opname])
        out[f"reduce_scatter:{key}"] = _np(o)
        olist = src.new_empty(o.shape)
        dist.reduce_scatter(olist, list(src.chunk(n, 0)), op=ops[opname])
        out[f"reduce_scatter_list:{key}"] = _np(olist)
    t = x.clone()
    dist.broadcast(t, src=n - 1)
    out["broadcast:src_last"] = _np(t)
    t = torch.zeros_like(x)
    dist.scatter(t, [_t(r) for r in inp["scatter"]] if rank == 0 else None,
                 src=0)
    out["scatter:src0"] = _np(t)
    rows = _t(inp["alltoall"][rank])
    lst = []
    dist.alltoall(list(rows.chunk(n, 0)), lst)
    out["alltoall:list"] = np.concatenate([_np(p) for p in lst])
    out["alltoall_single"] = _np(dist.alltoall_single(rows))
    # a ring: rank r sends to r + 1 and receives from r - 1
    recv = torch.zeros_like(x)
    task = dist.isend(x.clone(), (rank + 1) % n)
    dist.recv(recv, (rank - 1) % n)
    task.wait()
    out["ring:send_recv"] = _np(recv)
    back = torch.zeros_like(x)
    fwd = torch.zeros_like(x)
    tasks = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x.clone(), (rank + 1) % n),
        dist.P2POp(dist.isend, 2 * x, (rank - 1) % n),
        dist.P2POp(dist.irecv, fwd, (rank - 1) % n),
        dist.P2POp(dist.irecv, back, (rank + 1) % n)])
    for tk in tasks:
        tk.wait()
    out["ring:batch_fwd"] = _np(fwd)
    out["ring:batch_back"] = _np(back)
    recv = torch.zeros_like(x)
    task = dist.irecv(recv, (rank - 1) % n)
    dist.send(3 * x, (rank + 1) % n)
    task.wait()
    out["ring:irecv"] = _np(recv)
    from paddle_tpu_torch.distributed.collective import p2p_host_staged
    out["p2p_host_staged"] = dict(p2p_host_staged)
    # one hop of a ring under each wire codec (the collective-matmul hop)
    from paddle_tpu_torch.distributed.collective import wire_ppermute
    ring = [(i, (i + 1) % n) for i in range(n)]
    xr = _t(inp["wire"][rank])
    for comp in (None, "bf16", "int8"):
        out[f"wire_ppermute:{comp}"] = _np(wire_ppermute(xr, None, ring,
                                                         comp))
    out["get_group"] = dist.get_group(0).ranks
    # subgroups: the even ranks, and the last rank alone
    evens = dist.new_group(list(range(0, n, 2)))
    last = dist.new_group([n - 1])
    t = x.clone()
    dist.all_reduce(t, group=evens)
    out["subgroup:evens"] = _np(t)
    out["subgroup:evens_rank"] = evens.rank
    t = x.clone()
    dist.all_reduce(t, group=last)
    out["subgroup:last"] = _np(t)
    # sync_op=False: a task, the result in place after wait()
    t = x.clone()
    task = dist.all_reduce(t, op=ReduceOp.AVG, sync_op=False)
    task.wait()
    out["async:avg"] = _np(t)
    t = x.clone()
    stream.all_reduce(t, sync_op=False).wait()
    out["stream:sum"] = _np(t)
    box = [rank, f"from {rank}"]
    dist.broadcast_object_list(box, src=1)
    out["broadcast_object_list"] = box
    got = []
    dist.scatter_object_list(got, [f"o{i}" for i in range(2 * n)]
                             if rank == 0 else None, src=0)
    out["scatter_object_list"] = got
    dist.wait(t)
    dist.barrier()
    out["world"] = (dist.get_rank(), dist.get_world_size(),
                    dist.get_backend(), dist.is_initialized())
    out["rejections"] = _rejections(dist, x, evens)
    out["bounds"] = case_error_bounds(rank, n, inp.get("bounds", {}))
    return out


def _rejections(dist, x, group):
    msgs = {}
    for key, call in (
            ("int", lambda: dist.all_reduce(x.to(torch.int32),
                                            compress="int8")),
            ("op", lambda: dist.all_reduce(x.clone(),
                                           op=dist.ReduceOp.MAX,
                                           compress="int8")),
            ("codec", lambda: dist.all_reduce(x.clone(), compress="fp8")),
            ("rs_op", lambda: dist.reduce_scatter(
                x.clone(), x.clone(), op=dist.ReduceOp.MIN,
                compress="bf16")),
            ("explicit", lambda: dist.all_reduce(x.clone(), group=group,
                                                 compress="int8"))):
        try:
            call()
            msgs[key] = None
        except (ValueError, NotImplementedError) as e:
            msgs[key] = (type(e).__name__, str(e))
    return msgs


def case_error_bounds(rank, n, inp):
    """The int8 and bf16 wires on the reference's error-bound shapes."""
    import paddle_tpu_torch.distributed as dist
    out = {}
    for key, x in inp.items():
        api, comp, dtype, _ = key.split(":", 3)
        t = _t(x[rank]).to(getattr(torch, dtype))
        if api == "all_reduce":
            dist.all_reduce(t, compress=comp)
            out[key] = _np(t.float())
        else:
            o = t.new_empty((t.shape[0] // n,) + tuple(t.shape[1:]))
            dist.reduce_scatter(o, t, compress=comp)
            out[key] = _np(o.float())
    return out


# -- fleet ---------------------------------------------------------------------
def _hcg_view(hcg):
    groups = {a: hcg.get_axis_group(a) for a in ("dp", "mp", "pp",
                                                  "sharding", "sep", "ep")}
    return {
        "degrees": (hcg.get_data_parallel_world_size(),
                    hcg.get_model_parallel_world_size(),
                    hcg.get_pipe_parallel_world_size(),
                    hcg.get_sharding_parallel_world_size(),
                    hcg.get_sep_parallel_world_size(),
                    hcg.get_expert_parallel_world_size()),
        "ranks": (hcg.get_data_parallel_rank(),
                  hcg.get_model_parallel_rank(), hcg.get_stage_id(),
                  hcg.get_sharding_parallel_rank()),
        "groups": {a: (g.ranks, g.rank) for a, g in groups.items()
                   if g is not None},
        "src": (hcg.get_data_parallel_group_src_rank(),
                hcg.get_model_parallel_group_src_rank()),
        "stages": (hcg.is_first_stage(), hcg.is_last_stage()),
        "names": hcg.topology.get_hybrid_group_names(),
        "comm_lists": {nm: hcg.topology.get_comm_list(nm)
                       for nm in hcg.topology.get_hybrid_group_names()},
    }


def case_fleet(rank, n, inp):
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.utils import (
        broadcast_dp_parameters, broadcast_mp_parameters,
        fused_allreduce_gradients)
    out = {"views": {}}
    for name, hc in inp["configs"].items():
        s = fleet.DistributedStrategy()
        s.hybrid_configs = hc
        try:
            fleet.init(is_collective=True, strategy=s, device="cpu")
        except ValueError as e:
            out["views"][name] = ("ValueError", str(e))
            continue
        hcg = fleet.get_hybrid_communicate_group()
        view = _hcg_view(hcg)
        view["worker"] = (fleet.worker_num(), fleet.worker_index(),
                          fleet.is_first_worker())
        fleet.barrier_worker()
        # the int8 wire over each hybrid axis' group (group rank != global
        # rank on the mp groups of dp2 x mp2)
        x = _t(inp["int8"][rank])
        for axis in ("dp", "mp"):
            t = x.clone()
            dist.all_reduce(t, group=hcg.get_axis_group(axis),
                            compress="int8")
            view[f"int8:{axis}"] = _np(t)
        model = torch.nn.Sequential(torch.nn.Linear(4, 8),
                                    torch.nn.Linear(8, 2))
        with torch.no_grad():
            for i, p in enumerate(model.parameters()):
                p.fill_(100 * rank + i)
        wrapped = fleet.distributed_model(model)
        view["wrapper"] = type(wrapped).__name__
        view["params_after_wrap"] = [_np(p) for p in model.parameters()]
        with torch.no_grad():
            for i, p in enumerate(model.parameters()):
                p.fill_(100 * rank + i)
        broadcast_dp_parameters(model, hcg)
        view["after_dp_broadcast"] = [float(p.flatten()[0])
                                      for p in model.parameters()]
        broadcast_mp_parameters(model, hcg)
        view["after_mp_broadcast"] = [float(p.flatten()[0])
                                      for p in model.parameters()]
        for i, p in enumerate(model.parameters()):
            p.grad = torch.full_like(p, float(rank + i))
        fused_allreduce_gradients(list(model.parameters()), hcg)
        view["fused_grads"] = [float(p.grad.flatten()[0])
                               for p in model.parameters()]
        out["views"][name] = view
    return out


# -- data parallelism -----------------------------------------------------------
def _gpt_dp_run(inp, rank, n, compress=None, wrapper=None, accum=1,
                fleet_knobs=False):
    """Three AdamW steps of GPT on this rank's rows of the global batch;
    returns its losses, parameters and the scheduler."""
    from paddle_tpu_torch import AdamW, TrainStep
    from paddle_tpu_torch.convert import gpt_params_from_jax
    from paddle_tpu_torch.distributed import DataParallel, fleet
    from paddle_tpu_torch.distributed.fleet import GradBucketScheduler
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(**inp["cfg"])
    model = GPTForCausalLM(cfg, device="cpu")
    model.load_state_dict(gpt_params_from_jax(inp["sd"], cfg))
    opt = AdamW(learning_rate=inp["lr"], parameters=model.parameters())
    sched = None
    if fleet_knobs:
        s = fleet.DistributedStrategy()
        s.hybrid_configs = {"dp_degree": n, "mp_degree": 1, "pp_degree": 1}
        s.grad_compress = compress
        s.grad_bucket_mb = inp["bucket_mb"]
        fleet.init(is_collective=True, strategy=s, device="cpu")
        model = fleet.distributed_model(model)
        opt = fleet.distributed_optimizer(opt)
    elif wrapper == "dp":
        model = DataParallel(model)
    else:
        sched = GradBucketScheduler(
            [(k, tuple(p.shape), "float32")
             for k, p in model.named_parameters()],
            bucket_mb=inp["bucket_mb"], compress=compress)
    step = TrainStep(model, lambda lo, la: model_loss(cfg, lo, la), opt,
                     grad_sync=sched, accum_steps=accum)
    per = inp["ids"].shape[0] // n
    ids = _t(inp["ids"][rank * per:(rank + 1) * per])
    labels = _t(inp["labels"][rank * per:(rank + 1) * per])
    losses = [float(step((ids,), (labels,))) for _ in range(inp["steps"])]
    params = {k: _np(p) for k, p in model.named_parameters()}
    return losses, params, step._grad_sync


def model_loss(cfg, logits, labels):
    from paddle_tpu_torch.nn.functional.loss import cross_entropy
    return cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                         labels.reshape(-1))


def case_dp(rank, n, inp):
    import paddle_tpu_torch.distributed as dist
    out = {}
    for name, kw in (("exact", {}), ("int8", {"compress": "int8"}),
                     ("bf16", {"compress": "bf16"}),
                     ("wrapper", {"wrapper": "dp"}),
                     ("accum", {"accum": 2}),
                     ("fleet_int8", {"compress": "int8",
                                     "fleet_knobs": True})):
        losses, params, sched = _gpt_dp_run(inp, rank, n, **kw)
        out[name] = {"losses": losses, "params": params}
        if sched is not None:
            out[name]["sched"] = {
                "compress": sched.compress, "axis": sched.axis,
                "buckets": [b.names for b in sched.buckets],
                "bytes_per_step": sched.bytes_per_step,
                "wire_bytes_per_step": sched.wire_bytes_per_step,
                "counters": dict(sched.counters)}
    # no_sync: the gradients stay local, the next synced backward averages
    # the accumulated sum
    lin = torch.nn.Linear(3, 2)
    dp = dist.DataParallel(lin)
    x = torch.full((1, 3), float(rank + 1))
    with dp.no_sync():
        dp(x).sum().backward()
    out["no_sync_local"] = _np(lin.weight.grad)
    dp(x).sum().backward()
    out["no_sync_then_synced"] = _np(lin.weight.grad)
    loss = dp(x).sum()
    out["wrapper_surface"] = (
        dp.scale_loss(loss) is loss,
        sorted(dp.state_dict()) == sorted(lin.state_dict()),
        [id(p) for p in dp.parameters()] == [id(p) for p in
                                              lin.parameters()],
        [k for k, _ in dp.named_parameters()] == ["weight", "bias"])
    return out


# -- tensor parallelism --------------------------------------------------------
def _init_mp(n, mp):
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": n // mp, "mp_degree": mp,
                        "pp_degree": 1}
    fleet.init(is_collective=True, strategy=s, device="cpu")
    return fleet.get_hybrid_communicate_group()


def case_mp_layers(rank, n, inp):
    """Each mp layer on this rank's dp rows: outputs, the gradients of
    sum(out * gout) and the input gradient."""
    from paddle_tpu_torch.convert import tp_shard
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
        VocabParallelEmbedding)
    hcg = _init_mp(n, inp["mp"])
    mp, mr = inp["mp"], hcg.get_model_parallel_rank()
    dr, dp = hcg.get_data_parallel_rank(), n // inp["mp"]
    out = {"dp_rank": dr, "mp_rank": mr}

    def rows(a):
        per = a.shape[0] // dp
        return _t(a[dr * per:(dr + 1) * per])

    def run(name, layer, x, gout, params, as_name):
        """``as_name``: the parameter name whose shard rule the layer's
        weights follow (convert.tp_shard)."""
        with torch.no_grad():
            for pname, full in params.items():
                getattr(layer, pname).copy_(tp_shard(as_name + "." + pname,
                                                     _t(full), mr, mp))
        y = layer(x)
        (y * gout).sum().backward()
        out[name] = {"y": _np(y), "x_grad": _np(x.grad) if x.grad is not None
                     and x.is_floating_point() else None,
                     "grads": {k: _np(getattr(layer, k).grad)
                               for k in params}}

    w = inp["w"]
    x = rows(inp["x"]).requires_grad_()
    ids = rows(inp["ids"])
    emb = VocabParallelEmbedding(*w["emb"].shape, device="cpu")
    run("embed", emb, ids, rows(inp["g_emb"]), {"weight": w["emb"]},
        "embed_tokens")
    for gather in (True, False):
        col = ColumnParallelLinear(8, 12, has_bias=True,
                                   gather_output=gather, device="cpu")
        xx = x.detach().clone().requires_grad_()
        g = rows(inp["g_col"])
        if not gather:
            g = g.chunk(mp, -1)[mr]
        run(f"column{'_gather' if gather else ''}", col, xx, g,
            {"weight": w["col"], "bias": w["col_b"]}, "fc_in")
    for parallel in (True, False):
        row = RowParallelLinear(12, 8, has_bias=True,
                                input_is_parallel=parallel, device="cpu")
        xi = rows(inp["x_row"])
        if parallel:
            xi = xi.chunk(mp, -1)[mr]
        xi = xi.clone().requires_grad_()
        run(f"row{'_parallel' if parallel else ''}", row, xi,
            rows(inp["g_row"]), {"weight": w["row"], "bias": w["row_b"]},
            "fc_out")
    logits = rows(inp["logits"]).chunk(mp, -1)[mr].clone().requires_grad_()
    labels = rows(inp["labels"])
    loss = ParallelCrossEntropy()(logits, labels.unsqueeze(-1))
    (loss * rows(inp["g_ce"])).sum().backward()
    out["pce"] = {"loss": _np(loss), "grad": _np(logits.grad)}
    return out


def case_tp_models(rank, n, inp):
    """GPT and Llama with tensor_parallel=True: logits, loss, gradients
    (after TensorParallel's dp sync) and the parameters after one AdamW
    step through fleet's wrappers."""
    from paddle_tpu_torch import AdamW
    from paddle_tpu_torch.convert import tp_params_from_jax
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.models.llama import (
        LlamaConfig, LlamaForCausalLM, LlamaPretrainingCriterion)
    hcg = _init_mp(n, inp["mp"])
    mp, mr = inp["mp"], hcg.get_model_parallel_rank()
    dr, dp = hcg.get_data_parallel_rank(), n // inp["mp"]
    out = {"dp_rank": dr, "mp_rank": mr}
    for fam, spec in inp["models"].items():
        if fam == "gpt":
            cfg = GPTConfig(tensor_parallel=True, **spec["cfg"])
            model = GPTForCausalLM(cfg, device="cpu")
            crit = model.loss
        else:
            cfg = LlamaConfig(tensor_parallel=True, **spec["cfg"])
            model = LlamaForCausalLM(cfg, device="cpu")
            crit = LlamaPretrainingCriterion(cfg)
        model.load_state_dict(tp_params_from_jax(spec["sd"], cfg, mr, mp))
        wrapped = fleet.distributed_model(model)
        opt = fleet.distributed_optimizer(
            AdamW(learning_rate=inp["lr"], parameters=model.parameters()))
        per = spec["ids"].shape[0] // dp
        ids = _t(spec["ids"][dr * per:(dr + 1) * per])
        labels = _t(spec["labels"][dr * per:(dr + 1) * per])
        logits = wrapped(ids)
        loss = crit(logits, labels)
        loss.backward()
        res = {"wrapper": type(wrapped).__name__, "logits": _np(logits),
               "loss": float(loss),
               "grads": {k: _np(p.grad) for k, p in model.named_parameters()}}
        opt.step()
        res["params"] = {k: _np(p) for k, p in model.named_parameters()}
        out[fam] = res
    return out


# -- pipeline parallelism ------------------------------------------------------
def _init_pp(n, pp, mp=1, **pp_configs):
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": n // (pp * mp), "mp_degree": mp,
                        "pp_degree": pp, "pp_configs": pp_configs}
    fleet.init(is_collective=True, strategy=s, device="cpu")
    return fleet.get_hybrid_communicate_group()


def _pp_model(spec, hcg):
    """The pipelined model of a spec {"family", "cfg", "sd"} with this
    rank's stage of the JAX weights."""
    from paddle_tpu_torch.convert import pp_params_from_jax
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.models.llama import (
        LlamaConfig, LlamaForCausalLM, LlamaPretrainingCriterion)
    gpt = spec["family"] == "gpt"
    cfg = (GPTConfig if gpt else LlamaConfig)(pipeline_parallel=True,
                                             **spec["cfg"])
    model = (GPTForCausalLM if gpt else LlamaForCausalLM)(cfg, device="cpu")
    sd = pp_params_from_jax(spec["sd"], cfg, hcg.get_stage_id(),
                            hcg.get_pipe_parallel_world_size(),
                            hcg.get_model_parallel_rank(),
                            hcg.get_model_parallel_world_size())
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not missing and not unexpected, (missing, unexpected)
    crit = model.loss if gpt else LlamaPretrainingCriterion(cfg)
    return model, crit


def _pp_train(spec, hcg, lr, steps):
    from paddle_tpu_torch import AdamW, TrainStep
    model, crit = _pp_model(spec, hcg)
    step = TrainStep(model, lambda lo, la: crit(lo, la),
                     AdamW(learning_rate=lr, parameters=model.parameters()))
    ids, labels = _t(spec["ids"]), _t(spec["labels"])
    losses = [float(step((ids,), (labels,))) for _ in range(steps)]
    tied = model._pp_tied()
    return {"losses": losses, "stats": model.last_pipeline_stats,
            "tied": None if tied is None else _np(tied),
            "params": sum(p.numel() for p in model.parameters())}


def case_pipeline(rank, n, inp):
    """Llama and GPT with pipeline_parallel=True trained by TrainStep from
    the JAX weights, each spec in its own fleet topology, and the
    executor's, converters' and layouts' checks."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.convert import pp_params_to_jax
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        spmd_pipeline, spmd_pipeline_interleaved)
    out = {}
    for name, spec in inp["train"].items():
        hcg = _init_pp(n, spec["pp"], spec.get("mp", 1))
        out[name] = _pp_train(spec, hcg, inp["lr"], inp["steps"])
        out[name]["stage"] = hcg.get_stage_id()
    for name, spec in inp.get("layouts", {}).items():
        hcg = _init_pp(n, spec["pp"], spec.get("mp", 1))
        model, _ = _pp_model(spec, hcg)
        try:
            model(_t(spec["ids"]), attn_mask=torch.ones(1))
            mask_error = None
        except (ValueError, NotImplementedError, TypeError) as e:
            mask_error = (type(e).__name__, str(e))
        # the one-rank model's whole natural-order state dict loads into
        # this rank's stage
        from paddle_tpu_torch.convert import pp_params_from_jax
        whole = pp_params_from_jax(spec["sd"], model.config, 0, 1)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        with torch.no_grad():
            for p in model.parameters():
                p.zero_()
        missing, _ = model.set_state_dict(whole)
        reloaded = all(torch.equal(before[k], v)
                       for k, v in model.state_dict().items())
        out["layout:" + name] = {
            "mask_error": mask_error, "reloaded": reloaded,
            "reload_missing": missing,
            "to_jax": pp_params_to_jax(model),
            "factors": model._pp_stack().placement_factors(),
            "chunks": model._pp_stack().chunks,
            "names": sorted(model.state_dict()),
            "logits": _np(model(_t(spec["ids"])))}
    # the forward-only runners against the stages applied in order
    hcg = _init_pp(n, n)
    ws = [_t(w) for w in inp["runner"]["ws"]]
    x = _t(inp["runner"]["x"])
    s = hcg.get_stage_id()
    out["runner"] = _np(spmd_pipeline(lambda w, h: torch.tanh(h @ w),
                                      ws[s], x))
    out["runner_vpp"] = _np(spmd_pipeline_interleaved(
        lambda w, h: torch.tanh(h @ w), [ws[s], ws[n + s]], x, 2))
    out["errors"] = _pp_errors(n, inp["errors"])
    dist.barrier()
    return out


def _pp_errors(n, specs):
    """The type and message of each spec's construction or first step."""
    out = {}
    for name, spec in specs.items():
        hcg = _init_pp(n, n)
        try:
            _pp_train(spec, hcg, 1e-3, 1)
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = (type(e).__name__, str(e))
    return out


def case_pp_layers(rank, n, inp):
    """A PipelineLayer with a shared embedding under fleet's
    PipelineParallel.train_batch, and fleet's wrapper over Llama's
    internal pipeline."""
    import torch.nn.functional as F
    from paddle_tpu_torch import AdamW, SGD
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, PipelineLayer, SharedLayerDesc)
    from paddle_tpu_torch.models.llama import (LlamaConfig,
                                               LlamaForCausalLM,
                                               LlamaPretrainingCriterion)
    out = {}
    hcg = _init_pp(n, n, accumulate_steps=inp["accumulate_steps"])
    V, H = inp["vocab"], inp["hidden"]

    def head(layer, x):
        return F.linear(x, layer.weight)

    descs = [SharedLayerDesc("emb", torch.nn.Embedding, None, "weight", V,
                             H)]
    descs += [LayerDesc(torch.nn.Linear, H, H) for _ in range(inp["mid"])]
    descs += [SharedLayerDesc("emb", torch.nn.Embedding, head, "weight", V,
                              H)]

    def loss_fn(logits, labels):
        return F.cross_entropy(logits.reshape(-1, V), labels.reshape(-1))

    pl = PipelineLayer(descs, loss_fn=loss_fn, seg_method="uniform")
    with torch.no_grad():
        for key, w in inp["weights"].items():
            idx, pname = key.split(".", 1)
            if idx in pl._callables:
                getattr(pl._callables[idx], pname).copy_(_t(w))
    model = fleet.distributed_model(pl)
    opt = SGD(learning_rate=inp["lr"], parameters=model.parameters())
    ids, labels = _t(inp["ids"]), _t(inp["labels"])
    out["wrapper"] = type(model).__name__
    out["stages"] = [pl.get_stage_from_index(i) for i in range(len(descs))]
    out["losses"] = [float(model.train_batch((ids, labels), opt))
                     for _ in range(inp["steps"])]
    out["eval"] = float(model.eval_batch((ids, labels)))
    out["emb"] = _np(pl._shared["emb"].weight)
    out["own"] = len(pl.parameters_of_stage[hcg.get_stage_id()])
    # fleet over Llama's internal pipeline: accumulate_steps becomes the
    # stack's microbatch count, the user's config stays as it was
    cfg = LlamaConfig(pipeline_parallel=True, **inp["llama_cfg"])
    llama = LlamaForCausalLM(cfg, device="cpu")
    crit = LlamaPretrainingCriterion(cfg)
    llama._loss_fn = lambda lo, la: crit(lo, la)
    wrapped = fleet.distributed_model(llama)
    out["llama_wrapper"] = type(wrapped).__name__
    out["mb_override"] = llama.llama.decoder_stack._mb_override
    out["cfg_microbatches"] = cfg.pp_microbatches
    lopt = AdamW(learning_rate=1e-3, parameters=llama.parameters())
    lids = _t(inp["llama_ids"])
    out["llama_losses"] = [float(wrapped.train_batch((lids, lids), lopt))
                           for _ in range(2)]
    out["llama_microbatches"] = llama.last_pipeline_stats["microbatches"]
    return out


def case_p2p_cuda(rank, n, inp):
    """send / recv / batch_isend_irecv of CUDA tensors over gloo: staged
    through host memory and counted."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.collective import p2p_host_staged
    x = torch.arange(6, dtype=torch.float32, device="cuda") + 10 * rank
    got = torch.zeros_like(x)
    task = dist.isend(x, (rank + 1) % n)
    dist.recv(got, (rank - 1) % n)
    task.wait()
    fwd, back = torch.zeros_like(x), torch.zeros_like(x)
    for t in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, (rank + 1) % n),
            dist.P2POp(dist.isend, 2 * x, (rank - 1) % n),
            dist.P2POp(dist.irecv, fwd, (rank - 1) % n),
            dist.P2POp(dist.irecv, back, (rank + 1) % n)]):
        t.wait()
    return {"recv": _np(got), "fwd": _np(fwd), "back": _np(back),
            "staged": dict(p2p_host_staged), "device": str(got.device)}


CASES = {"collectives": case_collectives, "fleet": case_fleet, "dp": case_dp,
         "mp_layers": case_mp_layers, "tp_models": case_tp_models,
         "pipeline": case_pipeline, "pp_layers": case_pp_layers,
         "p2p_cuda": case_p2p_cuda}
