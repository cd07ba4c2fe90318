"""Sequence parallelism in the port against the JAX package, on the CPU.

The JAX side runs under fleet.init(mp_degree=2, dp_degree=-1) on the 8
virtual devices: the reference's sequence-parallel linears test
(tests/test_distributed.py::test_sequence_parallel_linears: x [2, 4, 8],
ColumnSequenceParallelLinear(8, 16) then RowSequenceParallelLinear(16,
8), biases) with the gradients of sum(out * g), and llama_tiny with
tensor_parallel and sequence_parallel (vocab 256, hidden 64, 2 layers, 4
heads, 2 key-value heads, float32, XLA's attention) over the batch 4 x 16:
logits, loss, every gradient (the norm weights included) and the
parameters after one eager AdamW step at lr 1e-3. The port runs in gloo
worlds of 2 ranks (mp 2) and 4 (dp 2 x mp 2) (tests/torch_cm_cases.py),
through fleet.init, the model built with both flags, each rank's shard of
the JAX weights (convert.tp_params_from_jax, strict: the names are tensor
parallelism's), fleet.distributed_model and fleet.distributed_optimizer,
once with mp_overlap off and once on (the column_sp / row_sp rings, 2
chunks a hop); rank (d, m) runs the d-th dp slice of the batch. The
world of 2 also runs the tensor-parallel Llama alone (not sequence-
parallel) on the column / row rings with the int8 wire, held to the JAX
Llama on the same rings (fleet.init with mp_overlap and
mp_activation_compress="int8", one step of its TrainStep).

The sequence ops are held against numpy. Tolerances are
test_torch_tensor_parallel.py's: logits, loss and gradients 1e-5
relative and 1e-5 of each tensor's largest magnitude; the parameters
after AdamW every element within 2 lr and all but 0.1 % of all elements
within 1e-6. The parameters no rank splits (the norms, sequence-parallel:
each rank's gradient is the mp sum of its positions' parts) take the same
step on every rank bit for bit.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.distributed.fleet.meta_parallel import collective_matmul \
    as jcm
from paddle_tpu.distributed.fleet.utils import sequence_parallel_utils \
    as jsp
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import LlamaPretrainingCriterion as JaxCrit
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny

from paddle_tpu_torch.convert import _TP_SPLITS, tp_params_from_jax
from paddle_tpu_torch.models.llama import llama_tiny

import torch_dist_cases as cases

MP = 2
B, S = 4, 16
LR = 1e-3
TOL = 1e-5
CFG = dict(use_flash_attention=False)
LANES = {"exact": {}, "overlap": {"mp_overlap": True,
                                  "mp_overlap_chunks": 2}}
# the tensor-parallel Llama alone on the column / row rings, int8 wire.
# Held to the JAX Llama on the same rings, relative to what the codec
# moves the reference from its exact result: the port's and the
# reference's products round apart in the last bit, which moves a few
# codes by one step. Read on this CPU: the loss 0.028 of the codec's
# move, every gradient's distance at most 0.27 of it; with the backward
# rings' codes truncated instead of rounded, 2.8-2.9
RINGS = {"ring_int8": {"mp_overlap": True, "mp_overlap_chunks": 2,
                       "mp_activation_compress": "int8"}}
RING_LOSS_FRAC = 0.1
RING_GRAD_FRAC = 1.0


def _np(t):
    return np.asarray(t.numpy(), np.float32)


def _jax_linears(rng):
    """The reference test's pair, with the gradients of sum(out * g)."""
    col = jsp.ColumnSequenceParallelLinear(8, 16, has_bias=True)
    row = jsp.RowSequenceParallelLinear(16, 8, has_bias=True)
    x = pt.to_tensor(rng.standard_normal((2, 4, 8)).astype(np.float32))
    x.stop_gradient = False
    g = rng.standard_normal((2, 4, 8)).astype(np.float32)
    out = jsp.GatherOp.apply(row(col(jsp.ScatterOp.apply(x))))
    (out * pt.to_tensor(g)).sum().backward()
    spec = {"x": _np(x), "g": g, "col_w": _np(col.weight),
            "col_b": _np(col.bias), "row_w": _np(row.weight),
            "row_b": _np(row.bias)}
    want = {"out": _np(out), "dx": _np(x.grad), "col_w": _np(col.weight.grad),
            "col_b": _np(col.bias.grad), "row_w": _np(row.weight.grad),
            "row_b": _np(row.bias.grad)}
    return spec, want


def _jax_rings(ref):
    """The JAX Llama (tensor_parallel, the fixture's weights) through
    fleet.init with each RINGS lane's knobs: the loss and every gradient
    of one step of the reference's TrainStep (its rings run under jit),
    the gradients read as the step of SGD at lr 1. The mesh is mp 2 x
    sharding 4 with dp 1, so that each device's rings carry the whole
    batch, as each rank of the port's world of two does: the int8 wire
    quantizes per block of what a rank sends, which depends on how the
    rows are split."""
    out = {}
    try:
        for name, knobs in RINGS.items():
            s = jdist.fleet.DistributedStrategy()
            s.hybrid_configs = {"dp_degree": 1, "mp_degree": MP,
                                "pp_degree": 1, "sharding_degree": 4}
            for k, v in knobs.items():
                setattr(s, k, v)
            jdist.fleet.init(is_collective=True, strategy=s)
            cfg = jax_llama_tiny(tensor_parallel=True, **CFG)
            model, crit = JaxLlama(cfg), JaxCrit(cfg)
            missing, unexpected = model.set_state_dict(ref["sd"])
            assert not missing and not unexpected
            before = {k: _np(p) for k, p in model.named_parameters()}
            step = pt.jit.TrainStep(
                model, lambda lo, la: crit(lo, la),
                pt.optimizer.SGD(learning_rate=1.0,
                                 parameters=model.parameters()))
            loss = float(step((pt.to_tensor(ref["ids"]),),
                              (pt.to_tensor(ref["labels"]),)))
            out[name] = {"loss": loss, "grads": {
                k: before[k] - _np(p) for k, p in model.named_parameters()}}
    finally:
        jcm.configure_mp_overlap(enabled=False, compress="none",
                                 chunks="auto")
    return out


def _ops(rng):
    """Stacked per-rank inputs of the four sequence ops and the numpy
    results each rank must return."""
    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    whole, parts = r(2, 8, 3), r(MP, 2, 4, 3)
    gw, gp = r(2, 8, 3), r(MP, 2, 4, 3)
    per = r(MP, 2, 8, 3)
    cat = np.concatenate(list(parts), axis=1)
    inp = {"scatter": {"x": [whole] * MP, "g": gp},
           "gather": {"x": parts, "g": [gw] * MP},
           "all_gather": {"x": parts, "g": per},
           "reduce_scatter": {"x": per, "g": gp}}
    split = lambda a, m: np.split(a, MP, axis=1)[m]  # noqa: E731
    want = {m: {"scatter": (split(whole, m), np.concatenate(list(gp), 1)),
                "gather": (cat, split(gw, m)),
                "all_gather": (cat, split(per.sum(0), m)),
                "reduce_scatter": (split(per.sum(0), m),
                                   np.concatenate(list(gp), 1))}
            for m in range(MP)}
    return {k: {"x": np.stack(v["x"]), "g": np.stack(v["g"])}
            for k, v in inp.items()}, want


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    saved = mesh_mod._global_mesh[0]
    try:
        s = jdist.fleet.DistributedStrategy()
        s.hybrid_configs = {"dp_degree": -1, "mp_degree": MP,
                            "pp_degree": 1}
        jdist.fleet.init(is_collective=True, strategy=s)
        rng = np.random.default_rng(53)
        lin_spec, lin_want = _jax_linears(rng)
        ops_in, ops_want = _ops(rng)
        pt.seed(41)
        cfg = jax_llama_tiny(tensor_parallel=True, sequence_parallel=True,
                             **CFG)
        model, crit = JaxLlama(cfg), JaxCrit(cfg)
        ref = {"sd": {k: _np(v) for k, v in model.state_dict().items()},
               "ids": rng.integers(0, 256, (B, S)).astype(np.int64),
               "labels": rng.integers(0, 256, (B, S)).astype(np.int64)}
        port_cfg = {k: v for k, v in vars(_port_cfg()).items()
                    if not k.startswith("_")
                    and k not in ("tensor_parallel", "sequence_parallel")}
        payload = {"mp": MP, "lr": LR, "lanes": LANES, "linears": lin_spec,
                   "ops": ops_in, "llama": {"cfg": port_cfg, **ref},
                   "rings": RINGS}
        tmp = tmp_path_factory.mktemp("sp")
        handles = {n: cases.start_world(n, "sp", payload, tmp,
                                        module="torch_cm_cases")
                   for n in (2, 4)}
        logits = model(pt.to_tensor(ref["ids"]))
        loss = crit(logits, pt.to_tensor(ref["labels"]))
        loss.backward()
        ref["grads"] = {k: _np(p.grad) for k, p in model.named_parameters()}
        pt.optimizer.AdamW(learning_rate=LR,
                           parameters=model.parameters()).step()
        ref.update(logits=_np(logits), loss=float(loss),
                   params={k: _np(p) for k, p in model.named_parameters()})
        ref["rings"] = _jax_rings(ref)
        worlds = {n: cases.finish_world(h) for n, h in handles.items()}
        return {"linears": lin_want, "ops": ops_want, "llama": ref}, worlds
    finally:
        mesh_mod._global_mesh[0] = saved


def _port_cfg():
    return llama_tiny(tensor_parallel=True, sequence_parallel=True, **CFG)


def _close(got, ref, what):
    np.testing.assert_allclose(got, ref, rtol=TOL,
                               atol=TOL * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


def _shards(named, m):
    return {k: v.numpy() for k, v in
            tp_params_from_jax(named, _port_cfg(), m, MP).items()}


def test_sequence_ops_match_numpy(run):
    ref, worlds = run
    for res in worlds[2]:
        for name, (y, dx) in ref["ops"][res["mp_rank"]].items():
            np.testing.assert_allclose(res["ops"][name]["y"], y, rtol=1e-6,
                                       atol=1e-6, err_msg=name)
            np.testing.assert_allclose(res["ops"][name]["dx"], dx,
                                       rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("overlap", [False, True])
def test_sequence_parallel_linears_match_jax(run, overlap):
    """The reference test's pair: the gathered output and the gradients
    (each rank's weight and bias gradients are its shards)."""
    ref, worlds = run
    want = ref["linears"]
    for res in worlds[2]:
        m = res["mp_rank"]
        got = res["linears"][overlap]
        _close(got["out"], want["out"], "out")
        _close(got["dx"], want["dx"], "dx")
        _close(got["col_w"], np.split(want["col_w"], MP, 1)[m], "col_w")
        _close(got["col_b"], np.split(want["col_b"], MP)[m], "col_b")
        _close(got["row_w"], np.split(want["row_w"], MP, 0)[m], "row_w")
        _close(got["row_b"], want["row_b"], "row_b")


CASES = [(n, lane) for n in (2, 4) for lane in LANES]


@pytest.mark.parametrize("n,lane", CASES)
def test_llama_forward_and_loss_match_jax(run, n, lane):
    ref, worlds = run
    r = ref["llama"]
    dp = n // MP
    per = B // dp
    for res in worlds[n]:
        d, m = res["dp_rank"], res["mp_rank"]
        want = np.split(r["logits"][d * per:(d + 1) * per], MP, -1)[m]
        _close(res["llama"][lane]["logits"], want, f"logits ({d}, {m})")
    loss = np.mean([res["llama"][lane]["loss"] for res in worlds[n]])
    assert loss == pytest.approx(r["loss"], rel=TOL)


@pytest.mark.parametrize("n,lane", CASES)
def test_llama_gradients_match_jax(run, n, lane):
    """Every gradient, the norm weights' included (their mp sum), after
    TensorParallel's dp sync."""
    ref, worlds = run
    for res in worlds[n]:
        want = _shards(ref["llama"]["grads"], res["mp_rank"])
        got = res["llama"][lane]["grads"]
        assert set(got) == set(want)
        assert any(k.endswith("norm.weight") for k in got)
        for k in want:
            _close(got[k], want[k], f"grad {k}, rank {res['mp_rank']}")


@pytest.mark.parametrize("n,lane", CASES)
def test_llama_adamw_step_matches_jax(run, n, lane):
    ref, worlds = run
    for res in worlds[n]:
        want = _shards(ref["llama"]["params"], res["mp_rank"])
        got = res["llama"][lane]["params"]
        d = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
        assert d.max() <= 2 * LR * (1 + 1e-3)
        assert np.mean(d > 1e-6) < 1e-3


@pytest.mark.parametrize("n,lane", CASES)
def test_llama_norms_marked_and_equal_across_ranks(run, n, lane):
    ref, worlds = run
    norms = sorted(k for k in ref["llama"]["params"]
                   if k.endswith("norm.weight"))
    full = [k for k in ref["llama"]["params"]
            if ".".join(k.split(".")[-2:]) not in _TP_SPLITS]
    for res in worlds[n]:
        assert res["llama"][lane]["marked"] == norms
    for k in full:
        vals = [res["llama"][lane]["params"][k] for res in worlds[n]]
        for v in vals[1:]:
            np.testing.assert_array_equal(v, vals[0], err_msg=k)


@pytest.mark.parametrize("n", [2, 4])
def test_llama_overlap_lane_runs_the_sequence_rings(run, n):
    """With mp_overlap the q/k/v and gate/up products are column_sp
    rings, o and down row_sp rings, and the head (on the gathered final
    hidden state) a column ring; each rank's posted bytes are the plans'
    of its calls. Without it nothing is posted."""
    ref, worlds = run
    h, f = 64, 128
    b = B // (n // MP)
    kv = 2 * 16                         # 2 key-value heads of 16
    col = [h, kv, kv, f, f]             # q, k, v, gate, up: out features
    for res in worlds[n]:
        on = res["llama"]["overlap"]["counters"]
        off = res["llama"]["exact"]["counters"]
        assert not any(off["posted_wire_bytes"].values())
        want_col = 2 * sum(jcm.overlap_wire_plan(
            "column_sp", MP, b, S, h, o, 4)["wire_bytes"] for o in col)
        want_row = 2 * sum(jcm.overlap_wire_plan(
            "row_sp", MP, b, S, i, h, 4)["wire_bytes"] for i in (h, f))
        assert on["posted_wire_bytes"]["column_sp"] == want_col
        assert on["posted_wire_bytes"]["row_sp"] == want_row
        assert on["paddle_tpu_mp_overlap_compressed_bytes_total"] == \
            on["posted_wire_bytes"]
        assert on["posted_wire_bytes"]["column"] == jcm.overlap_wire_plan(
            "column", MP, b, S, h, 256, 4)["wire_bytes"]


def test_llama_int8_ring_loss_matches_jax(run):
    """The tensor-parallel Llama on the column / row rings with the int8
    wire: the loss (the forward wire's error) against the JAX Llama's on
    the same rings, within a tenth of what the codec moves the reference's
    loss from the exact one (the fixture's)."""
    ref, worlds = run
    jax_loss = ref["llama"]["rings"]["ring_int8"]["loss"]
    codec = abs(jax_loss - ref["llama"]["loss"])
    assert codec > 1e-6 * abs(jax_loss)
    for res in worlds[2]:
        got = res["rings"]["ring_int8"]["loss"]
        assert abs(got - jax_loss) <= RING_LOSS_FRAC * codec


def test_llama_int8_ring_gradients_match_jax(run):
    """Every gradient of that Llama (the backward wire's error) against
    the JAX Llama's on the int8 rings: each tensor's distance to the
    reference's is smaller than the reference's own distance to the exact
    gradients (the fixture's), RING_GRAD_FRAC of it at most."""
    ref, worlds = run
    jax_grads = ref["llama"]["rings"]["ring_int8"]["grads"]
    for res in worlds[2]:
        m = res["mp_rank"]
        want = _shards(jax_grads, m)
        exact = _shards(ref["llama"]["grads"], m)
        got = res["rings"]["ring_int8"]["grads"]
        assert set(got) == set(want)
        for k in want:
            codec = np.linalg.norm(exact[k] - want[k])
            assert codec > 0, k
            assert np.linalg.norm(got[k] - want[k]) <= \
                RING_GRAD_FRAC * codec, f"grad {k}, rank {m}"

