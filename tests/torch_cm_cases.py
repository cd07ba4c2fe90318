"""The rank side of the collective-matmul, sequence-parallel and
quantized-linear tests (tests/test_torch_collective_matmul.py,
test_torch_sequence_parallel.py, test_torch_quant_linear.py), run through
``torch_dist_cases.start_world(..., module="torch_cm_cases")``. Like
torch_dist_cases it imports neither JAX nor the JAX package: the parent
computes the JAX side and compares.

Inputs come as whole (global) numpy arrays in the JAX package's layout
(weights [in, out]); each rank takes its shard as the kind's per-rank
layout says (the collective_matmul module docstring) and returns its
local results, which the parent holds against the matching shard of
the JAX results.
"""
from __future__ import annotations

import numpy as np
import torch

from torch_dist_cases import _np, _t

# kind -> (x split over mp along dim, w [in, out] split along dim, output
# split along dim, dx split along dim); None is whole on every mp rank
LAYOUT = {"column_sp": (1, 1, 2, 1), "row_sp": (2, 0, 1, 2),
          "column": (None, 1, 2, None),
          "column_gather": (None, 1, None, None),
          "row": (2, 0, None, 2)}


def shard(a, dim, n, m):
    return a if dim is None else np.split(a, n, axis=dim)[m]


def _fleet(mp, dp=1, **knobs):
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp, "pp_degree": 1}
    for k, v in knobs.items():
        setattr(s, k, v)
    fleet.init(is_collective=True, strategy=s, device="cpu")
    return fleet.get_hybrid_communicate_group()


def _cm_job(job, d, m, n, mesh):
    """One cm_matmul call: forward, then backward of sum(y * g); returns
    the local y, dx, dw (JAX layout [in, out]) and the bytes posted."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        collective_matmul as cm)
    xd, wd, yd, _ = LAYOUT[job["kind"]]
    b = job["x"].shape[0] // job["dp"]
    x = _t(shard(job["x"][d * b:(d + 1) * b], xd, n, m)).requires_grad_()
    w = _t(shard(job["w"], wd, n, m).T).requires_grad_()
    g = _t(shard(job["g"][d * b:(d + 1) * b], yd, n, m))
    cm.reset_counters()
    y = cm.cm_matmul(x, w, mesh=mesh, axis="mp", kind=job["kind"],
                     chunks=job["chunks"], compress=job["compress"],
                     impl=job["impl"])
    (y * g).sum().backward()
    return {"y": _np(y), "dx": _np(x.grad), "dw": _np(w.grad).T,
            "posted": cm.counters["posted_wire_bytes"][job["kind"]]}


def _layers(inp, group):
    """Column (gather_output both ways) and Row under mp_overlap and
    without, from one seed: outputs and gradients of both, and the
    counters of the overlapped calls against their plans."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ColumnParallelLinear, RowParallelLinear)
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        collective_matmul as cm)
    out = {}
    x_in = _t(inp["x"])
    for name, make in (
            ("column", lambda: ColumnParallelLinear(
                64, 64, gather_output=False, device="cpu")),
            ("column_gather", lambda: ColumnParallelLinear(
                64, 64, gather_output=True, device="cpu")),
            ("row", lambda: RowParallelLinear(
                64, 64, input_is_parallel=False, device="cpu"))):
        res = {}
        for overlap in (False, True):
            layer = make()
            with torch.no_grad():
                for p in layer.parameters():
                    p.add_(0.1)                  # a bias not zero
            x = x_in.clone().requires_grad_()
            cm.reset_counters()
            with cm.mp_overlap_ctx(enabled=overlap, compress=inp["compress"]
                                   if overlap else None, chunks=2):
                y = layer(x)
                (y * y).sum().backward()
            res[overlap] = {"y": _np(y), "dx": _np(x.grad),
                            "grads": [_np(p.grad)
                                      for p in layer.parameters()],
                            "counters": {k: dict(v) for k, v in
                                         cm.counters.items()}}
        out[name] = res
    return out


def case_cm(rank, n, inp):
    """The jobs of ``inp["jobs"]`` whose world is n; the world of 2 also
    runs the mp layers under the knob, the knob plumbing through
    fleet.init, and the errors."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.auto_parallel import ProcessMesh
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        collective_matmul as cm)
    out = {"jobs": {}}
    hcg = _fleet(n)
    for key, job in inp["jobs"].items():
        if job["world"] != n:
            continue
        if job["dp"] > 1:
            mesh = ProcessMesh(np.arange(n).reshape(job["dp"], -1),
                               dim_names=["dp", "mp"])
            d, m = rank // (n // job["dp"]), rank % (n // job["dp"])
            nm = n // job["dp"]
        else:
            mesh, d, m, nm = None, 0, hcg.get_model_parallel_rank(), n
        out["jobs"][key] = _cm_job(job, d, m, nm, mesh)
    if n != 2:
        return out
    out["layers"] = _layers(inp["layers"], hcg.get_model_parallel_group())
    # the errors: a bad kind, indivisible shapes, an integer payload
    errs = {}
    for name, x, kind, comp in (
            ("kind", torch.ones(1, 4, 8), "diag", None),
            ("seq", torch.ones(2, 5, 8), "row_sp", None),
            ("rows", torch.ones(1, 5, 8), "column", None),
            ("floating", torch.ones(1, 4, 8, dtype=torch.int32),
             "column_sp", "int8")):
        try:
            cm.cm_matmul(x, torch.ones(4, 8), kind=kind, compress=comp)
            errs[name] = None
        except ValueError as e:
            errs[name] = str(e)
    out["errors"] = errs
    # the ineligible calls run the exact path
    with cm.mp_overlap_ctx(enabled=True):
        g = hcg.get_model_parallel_group()
        out["ineligible"] = [
            cm.overlapped_linear(torch.ones(4, 8), torch.ones(4, 8), g,
                                 "column") is None,
            cm.overlapped_linear(torch.ones(1, 3, 8), torch.ones(4, 8), g,
                                 "row") is None,
            cm.overlapped_linear(torch.ones(1, 4, 8), torch.ones(4, 8), g,
                                 "column") is not None]
    # fleet.init sets the knobs, and a re-init with them off clears them
    on = _fleet(2, mp_overlap=True, mp_activation_compress="int8",
                mp_overlap_chunks=2, matmul_quant="fp8")
    from paddle_tpu_torch.kernels.quant_matmul import (active_matmul_dtype,
                                                        get_matmul_quant)
    out["knobs_on"] = (cm.mp_overlap_config(), get_matmul_quant(),
                       active_matmul_dtype())
    _fleet(2)
    out["knobs_off"] = (cm.mp_overlap_config(), get_matmul_quant(),
                        active_matmul_dtype())
    del on
    dist.barrier()
    return out


# -- sequence parallelism -----------------------------------------------------
def _sp_linears(inp):
    """The reference test's Column/Row sequence-parallel pair on this
    rank: out = GatherOp(row(col(ScatterOp(x)))), and the gradients of
    sum(out * g)."""
    from paddle_tpu_torch.distributed.fleet.utils import (
        ColumnSequenceParallelLinear, GatherOp, RowSequenceParallelLinear,
        ScatterOp)
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        collective_matmul as cm)
    col = ColumnSequenceParallelLinear(8, 16, has_bias=True, device="cpu")
    row = RowSequenceParallelLinear(16, 8, has_bias=True, device="cpu")
    m, n = col.rank, col.world_size
    with torch.no_grad():
        col.weight.copy_(_t(shard(inp["col_w"], 1, n, m).T))
        col.bias.copy_(_t(shard(inp["col_b"], 0, n, m)))
        row.weight.copy_(_t(shard(inp["row_w"], 0, n, m).T))
        row.bias.copy_(_t(inp["row_b"]))
    res = {}
    for overlap in (False, True):
        x = _t(inp["x"]).requires_grad_()
        for p in (*col.parameters(), *row.parameters()):
            p.grad = None
        with cm.mp_overlap_ctx(enabled=overlap, chunks=2):
            out = GatherOp.apply(row(col(ScatterOp.apply(x))))
            (out * _t(inp["g"])).sum().backward()
        res[overlap] = {"out": _np(out), "dx": _np(x.grad),
                        "col_w": _np(col.weight.grad).T,
                        "col_b": _np(col.bias.grad),
                        "row_w": _np(row.weight.grad).T,
                        "row_b": _np(row.bias.grad)}
    return res


def _sp_ops(inp, m):
    """Each sequence op forward and backward of sum(out * g), on this
    rank's row of the stacked inputs."""
    from paddle_tpu_torch.distributed.fleet.utils import (
        AllGatherOp, GatherOp, ReduceScatterOp, ScatterOp)
    ops = {"scatter": ScatterOp, "gather": GatherOp,
           "all_gather": AllGatherOp, "reduce_scatter": ReduceScatterOp}
    res = {}
    for name, op in ops.items():
        x = _t(inp[name]["x"][m]).requires_grad_()
        y = op.apply(x)
        (y * _t(inp[name]["g"][m])).sum().backward()
        res[name] = {"y": _np(y), "dx": _np(x.grad)}
    return res


def _sp_llama(spec, hcg, mp, dp, lr):
    """Llama with tensor_parallel and sequence_parallel through fleet's
    wrappers on this rank's dp rows: logits, loss, gradients, parameters
    after one AdamW step, and the rings' counters."""
    from paddle_tpu_torch import AdamW
    from paddle_tpu_torch.convert import tp_params_from_jax
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        collective_matmul as cm)
    from paddle_tpu_torch.models.llama import (
        LlamaConfig, LlamaForCausalLM, LlamaPretrainingCriterion)
    mr, dr = hcg.get_model_parallel_rank(), hcg.get_data_parallel_rank()
    cfg = LlamaConfig(tensor_parallel=True, sequence_parallel=True,
                      **spec["cfg"])
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(tp_params_from_jax(spec["sd"], cfg, mr, mp))
    wrapped = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(
        AdamW(learning_rate=lr, parameters=model.parameters()))
    crit = LlamaPretrainingCriterion(cfg)
    per = spec["ids"].shape[0] // dp
    ids = _t(spec["ids"][dr * per:(dr + 1) * per])
    labels = _t(spec["labels"][dr * per:(dr + 1) * per])
    cm.reset_counters()
    logits = wrapped(ids)
    loss = crit(logits, labels)
    loss.backward()
    res = {"logits": _np(logits), "loss": float(loss),
           "grads": {k: _np(p.grad) for k, p in model.named_parameters()},
           "counters": {k: dict(v) for k, v in cm.counters.items()},
           "marked": sorted(k for k, p in model.named_parameters()
                            if getattr(p, "sequence_parallel", False))}
    opt.step()
    res["params"] = {k: _np(p) for k, p in model.named_parameters()}
    return res


def _ring_llama(spec, hcg, mp):
    """Llama with tensor_parallel alone (the column / row rings under
    mp_overlap) through fleet's wrappers on the whole batch: the loss and
    every gradient."""
    from paddle_tpu_torch.convert import tp_params_from_jax
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models.llama import (
        LlamaConfig, LlamaForCausalLM, LlamaPretrainingCriterion)
    cfg = LlamaConfig(tensor_parallel=True, **spec["cfg"])
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(tp_params_from_jax(
        spec["sd"], cfg, hcg.get_model_parallel_rank(), mp))
    loss = LlamaPretrainingCriterion(cfg)(
        fleet.distributed_model(model)(_t(spec["ids"])), _t(spec["labels"]))
    loss.backward()
    return {"loss": float(loss.detach()),
            "grads": {k: _np(p.grad) for k, p in model.named_parameters()}}


def case_sp(rank, n, inp):
    """The sequence ops and linears (world 2), and the sequence-parallel
    Llama in each lane of ``inp["lanes"]`` (mp 2, at dp n / 2); at world
    2 also the tensor-parallel Llama in each lane of ``inp["rings"]``."""
    mp, dp = inp["mp"], n // inp["mp"]
    out = {}
    hcg = _fleet(mp, dp)
    out["dp_rank"] = hcg.get_data_parallel_rank()
    out["mp_rank"] = hcg.get_model_parallel_rank()
    if n == mp:
        out["linears"] = _sp_linears(inp["linears"])
        out["ops"] = _sp_ops(inp["ops"], out["mp_rank"])
        out["rings"] = {}
        for name, knobs in inp["rings"].items():
            hcg = _fleet(mp, **knobs)
            out["rings"][name] = _ring_llama(inp["llama"], hcg, mp)
    out["llama"] = {}
    for name, knobs in inp["lanes"].items():
        hcg = _fleet(mp, dp, **knobs)
        out["llama"][name] = _sp_llama(inp["llama"], hcg, mp, dp,
                                       inp["lr"])
    _fleet(mp, dp)
    return out


# -- the quantized mp layers --------------------------------------------------
def case_quant(rank, n, inp):
    """Column (both gather_output) and Row (input split and whole) under
    matmul_quant int8 and fp8 at mp n: outputs and the gradients of
    sum(out * g)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ColumnParallelLinear, RowParallelLinear)
    out = {}
    for q in ("int8", "fp8"):
        hcg = _fleet(n, matmul_quant=q)
        m = hcg.get_model_parallel_rank()
        for name, spec in inp["layers"].items():
            k, o = spec["w"].shape
            if name.startswith("column"):
                layer = ColumnParallelLinear(
                    k, o, gather_output=spec["gather"], device="cpu")
                w, b = shard(spec["w"], 1, n, m), shard(spec["b"], 0, n, m)
            else:
                layer = RowParallelLinear(
                    k, o, input_is_parallel=spec["parallel"], device="cpu")
                w, b = shard(spec["w"], 0, n, m), spec["b"]
            with torch.no_grad():
                layer.weight.copy_(_t(w.T))
                layer.bias.copy_(_t(b))
            x = _t(shard(spec["x"], 2 if spec.get("parallel") else None,
                         n, m)).requires_grad_()
            y = layer(x)
            g = spec["g"] if spec.get("gather", True) else shard(
                spec["g"], 2, n, m)
            (y * _t(g)).sum().backward()
            out[f"{q}:{name}"] = {"y": _np(y), "dx": _np(x.grad),
                                  "dw": _np(layer.weight.grad).T,
                                  "db": _np(layer.bias.grad)}
    _fleet(n)
    return out


CASES = {"cm": case_cm, "sp": case_sp, "quant": case_quant}
