"""The port's tensor-parallel layers
(paddle_tpu_torch/distributed/fleet/meta_parallel/mp_layers.py) against
the JAX package's, on the CPU.

The JAX layers run under fleet.init(mp_degree=2, dp_degree=-1) on the 8
virtual devices (the reference's topology needs degrees whose product is
the device count), over the global batch. The port's run in a world of 2
ranks (mp 2) and one of 4 (dp2 x mp2), gloo, spawned
(tests/torch_dist_cases.py): rank (d, m) takes the d-th dp slice of the
batch and holds the m-th mp shard of each weight (convert.tp_shard's
rules; the weights are the JAX layers' full ones, transposed to torch's
[out, in]). Each layer computes y and the gradients of sum(y * g) for a
fixed random g: VocabParallelEmbedding, ColumnParallelLinear with and
without gather_output, RowParallelLinear with and without
input_is_parallel, and ParallelCrossEntropy with ignore_index rows.

Rank (d, m)'s output is its slice of the JAX output (rows of d, and the
columns of m where the output stays sharded); its input gradient the
slice of the JAX input gradient; the sum over the dp ranks of its weight
gradients is the m-th shard of the JAX weight gradient (the layers alone
do not sync over dp), so the shards together are the full gradient.
Tolerance: float32 on both sides, summed in different orders, so 1e-5
relative and 1e-5 of each tensor's largest magnitude.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import jax
import jax.numpy as jnp
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.distributed.fleet.meta_parallel import mp_layers as JL

from paddle_tpu_torch.convert import tp_shard
import torch

import torch_dist_cases as cases

MP = 2
B, S, H, F, V = 4, 3, 8, 12, 16
TOL = 1e-5


def _inputs():
    rng = np.random.default_rng(21)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa
    labels = rng.integers(0, V, (B, S)).astype(np.int64)
    labels[0, 1] = labels[3, 2] = -100           # ignored positions
    # the weights, in the JAX layout ([in, out] for a Linear)
    w = {"emb": f32(V, H), "col": f32(H, F), "col_b": f32(F),
         "row": f32(F, H), "row_b": f32(H)}
    return {"jax_w": w, "x": f32(B, S, H),
            "ids": rng.integers(0, V, (B, S)).astype(np.int64),
            "g_emb": f32(B, S, H), "g_col": f32(B, S, F),
            "x_row": f32(B, S, F), "g_row": f32(B, S, H),
            "logits": f32(B, S, V) * 3, "labels": labels,
            "g_ce": f32(B, S, 1)}


def _set(param, value):
    param._data = jax.device_put(jnp.asarray(value), param._data.sharding)


def _jax_side(inp):
    """Every layer on the global batch: outputs, input and weight
    gradients, in the JAX layout."""
    saved = mesh_mod._global_mesh[0]
    try:
        s = jdist.fleet.DistributedStrategy()
        s.hybrid_configs = {"dp_degree": -1, "mp_degree": MP,
                            "pp_degree": 1}
        jdist.fleet.init(is_collective=True, strategy=s)
        out = {}
        w = inp["jax_w"]

        def run(name, layer, x, g, params):
            for k, v in params.items():
                _set(getattr(layer, k), v)
            xt = pt.to_tensor(x, stop_gradient=not np.issubdtype(
                x.dtype, np.floating))
            y = layer(xt)
            (y * pt.to_tensor(g)).sum().backward()
            out[name] = {
                "y": np.asarray(y.numpy()),
                "x_grad": np.asarray(xt.grad.numpy())
                if xt.grad is not None else None,
                "grads": {k: np.asarray(getattr(layer, k).grad.numpy())
                          for k in params}}

        emb = JL.VocabParallelEmbedding(V, H)
        run("embed", emb, inp["ids"], inp["g_emb"], {"weight": w["emb"]})
        for gather in (True, False):
            col = JL.ColumnParallelLinear(H, F, has_bias=True,
                                          gather_output=gather)
            run(f"column{'_gather' if gather else ''}", col, inp["x"],
                inp["g_col"], {"weight": w["col"], "bias": w["col_b"]})
        for parallel in (True, False):
            row = JL.RowParallelLinear(F, H, has_bias=True,
                                       input_is_parallel=parallel)
            run(f"row{'_parallel' if parallel else ''}", row,
                inp["x_row"], inp["g_row"],
                {"weight": w["row"], "bias": w["row_b"]})
        logits = pt.to_tensor(inp["logits"], stop_gradient=False)
        loss = JL.ParallelCrossEntropy()(
            logits, pt.to_tensor(inp["labels"][..., None]))
        (loss * pt.to_tensor(inp["g_ce"])).sum().backward()
        out["pce"] = {"loss": np.asarray(loss.numpy()),
                      "grad": np.asarray(logits.grad.numpy())}
        return out
    finally:
        mesh_mod._global_mesh[0] = saved


@pytest.fixture(scope="module")
def layers(tmp_path_factory):
    inp = _inputs()
    ref = _jax_side(inp)
    # the port takes the same weights in torch's [out, in] layout
    jw = inp.pop("jax_w")
    w = {"emb": jw["emb"], "col": jw["col"].T, "col_b": jw["col_b"],
         "row": jw["row"].T, "row_b": jw["row_b"]}
    tmp = tmp_path_factory.mktemp("mp_layers")
    worlds = {}
    for n in (2, 4):
        payload = dict(inp, mp=MP, w=w)
        worlds[n] = cases.start_world(n, "mp_layers", payload, tmp)
    return inp, ref, w, {n: cases.finish_world(h)
                         for n, h in worlds.items()}


def _close(got, ref, what):
    np.testing.assert_allclose(got, ref, rtol=TOL,
                               atol=TOL * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


def _rows(a, d, dp):
    per = a.shape[0] // dp
    return a[d * per:(d + 1) * per]


LAYER_CASES = {
    # name: (JAX weight layout -> port layout transposes, sharded output,
    #        sharded input, the shard rule's parameter name)
    "embed": (False, False, False, "embed_tokens"),
    "column_gather": (True, False, False, "fc_in"),
    "column": (True, True, False, "fc_in"),
    "row_parallel": (True, False, True, "fc_out"),
    "row": (True, False, False, "fc_out"),
}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_layer_matches_jax(layers, n, name):
    _, ref, _, worlds = layers
    transpose, out_sharded, in_sharded, as_name = LAYER_CASES[name]
    ranks = worlds[n]
    dp = n // MP
    sums = {}
    jref = ref[name]
    for res in ranks:
        d, m = res["dp_rank"], res["mp_rank"]
        got = res[name]
        y = _rows(jref["y"], d, dp)
        if out_sharded:
            y = np.split(y, MP, -1)[m]
        _close(got["y"], y, f"{name} y, rank ({d}, {m})")
        if jref["x_grad"] is not None:
            xg = _rows(jref["x_grad"], d, dp)
            if in_sharded:
                xg = np.split(xg, MP, -1)[m]
            _close(got["x_grad"], xg, f"{name} x grad, rank ({d}, {m})")
        for k, g in got["grads"].items():
            sums.setdefault((m, k), []).append(g)
    for (m, k), gs in sums.items():
        full = jref["grads"][k]
        if transpose and full.ndim == 2:
            full = full.T
        want = tp_shard(f"{as_name}.{k}", torch.from_numpy(np.array(full)),
                        m, MP).numpy()
        _close(np.sum(gs, 0), want, f"{name} {k} grad shard {m}")


@pytest.mark.parametrize("n", [2, 4])
def test_parallel_cross_entropy_matches_jax(layers, n):
    """Vocab-sharded logits: the loss per position (0 where the label is
    ignored) and the logits' gradient shard (0 on ignored rows)."""
    inp, ref, _, worlds = layers
    dp = n // MP
    for res in worlds[n]:
        d, m = res["dp_rank"], res["mp_rank"]
        _close(res["pce"]["loss"], _rows(ref["pce"]["loss"], d, dp),
               f"pce loss, rank ({d}, {m})")
        _close(res["pce"]["grad"],
               np.split(_rows(ref["pce"]["grad"], d, dp), MP, -1)[m],
               f"pce grad, rank ({d}, {m})")
    ignored = inp["labels"] == -100
    for res in worlds[n]:
        d, m = res["dp_rank"], res["mp_rank"]
        mask = _rows(ignored, d, dp)
        assert np.all(res["pce"]["loss"][mask] == 0)
        assert np.all(res["pce"]["grad"][mask] == 0)
