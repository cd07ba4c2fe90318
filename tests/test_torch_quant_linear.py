"""The quantized linear and the quantized mp layers in the port against
the JAX package, on the CPU.

``quantized_linear`` (int8; fp8 with the amax taken in the call and with
a given x_scale) on x [3, 5, 256] and w [256, 192] (the JAX layout; the
port's is its transpose), float32: the output and the straight-through
gradients of sum(y * g) against JAX's ``quantized_linear`` (its
reference branch on the CPU; the port's wrapper takes the kernel's plain
version for CPU tensors). The codec gives the JAX codes transposed bit
for bit and both multiply in float32, so 1e-5 relative and 1e-5 of each
tensor's largest magnitude. ``DelayedScaleState`` and the process-wide
knob against JAX's.

The mp layers under ``matmul_quant`` int8 and fp8: ColumnParallelLinear
(gather_output both ways) and RowParallelLinear (input split and whole),
K 256 -> O 128 with biases, x [2, 4, 256]: the JAX layers under
fleet.init(mp_degree=2) on the 8 virtual devices against the port's at
one rank (in this process) and at mp 2 (a gloo world of 2 ranks,
tests/torch_cm_cases.py), each rank's output, input gradient and weight
and bias gradients against the matching shards of the JAX ones. At mp 2
each row shard holds 128 contraction rows, one whole block of the JAX
codec, so the shards' codes are the JAX codes' slices; the fp8 scale is
the amax of the whole x (the row layer's ranks MAX-reduce theirs).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import jax
import jax.numpy as jnp
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.distributed.fleet.meta_parallel import mp_layers as JL
from paddle_tpu.kernels.pallas import quant_matmul as jq

from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    ColumnParallelLinear, RowParallelLinear)
from paddle_tpu_torch.kernels import quant_matmul as tq

import torch_dist_cases as cases
from torch_cm_cases import shard

MP = 2
K, O = 256, 128
TOL = 1e-5
QDTYPES = ("int8", "fp8")
LAYERS = ("column_gather", "column", "row_parallel", "row")


def _close(got, ref, what):
    """Within TOL; NaN where the reference's is (an fp8 cast past 448
    under a stale x_scale)."""
    np.testing.assert_allclose(got, ref, rtol=TOL,
                               atol=TOL * max(np.nanmax(np.abs(ref)), 1e-30),
                               err_msg=what)


def _linear_inputs():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 256)).astype(np.float32)
    # a few outliers set the amax; past 448 x 0.11 they overflow fp8
    x[0, 0, :7] *= 40.0
    w = (rng.standard_normal((256, 192)) * 0.05).astype(np.float32)
    g = rng.standard_normal((3, 5, 192)).astype(np.float32)
    return x, w, g


LINEAR_CASES = [("int8", None), ("fp8", None), ("fp8", 0.11)]


@pytest.mark.parametrize("qdtype,x_scale", LINEAR_CASES)
def test_quantized_linear_matches_jax(qdtype, x_scale):
    x, w, g = _linear_inputs()

    def jfn(x, w):
        return jq.quantized_linear(x, w, qdtype=qdtype, x_scale=x_scale)
    y, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w.T.copy()).requires_grad_()
    yt = tq.quantized_linear(xt, wt, qdtype=qdtype, x_scale=x_scale)
    (yt * torch.from_numpy(g)).sum().backward()
    _close(yt.detach().numpy(), np.asarray(y), "y")
    assert np.isnan(np.asarray(y)).any() == (x_scale is not None)
    _close(xt.grad.numpy(), np.asarray(jdx), "dx")
    _close(wt.grad.numpy().T, np.asarray(jdw), "dw")
    if qdtype == "fp8":
        # the fake-quantized activation moved the output past the int8 one
        y8 = tq.quantized_linear(xt, wt, qdtype="int8")
        assert not torch.equal(yt, y8)


@pytest.mark.parametrize("qdtype", QDTYPES)
def test_functional_quant_linear_matches_jax(qdtype):
    """nn.functional.quant_linear, the mp layers' entry: x @ w per block
    quantized, bias-free, in each package's weight layout."""
    from paddle_tpu_torch.nn.functional import quant_linear
    x, w, _ = _linear_inputs()
    want = pt.nn.functional.quant_linear(pt.to_tensor(x), pt.to_tensor(w),
                                         qdtype=qdtype)
    got = quant_linear(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                       qdtype=qdtype)
    _close(got.numpy(), np.asarray(want.numpy()), "y")


def test_quantized_linear_rejects_a_bad_dtype():
    with pytest.raises(ValueError, match="qdtype"):
        tq.quantized_linear(torch.ones(2, 128), torch.ones(4, 128),
                            qdtype="int4")


def test_delayed_scale_state_and_knob_match_jax():
    js, ts = jq.DelayedScaleState(history_len=3), \
        tq.DelayedScaleState(history_len=3)
    assert js.scale == ts.scale == 1.0
    for amax in (2.0, 448.0, 0.5, 0.25, 0.0, 9.0):
        assert js.observe(amax) == ts.observe(amax)
        assert js.scale == ts.scale
    before = (jq.get_matmul_quant(), tq.get_matmul_quant())
    try:
        for d in ("int8", "fp8", "none"):
            assert jq.configure_matmul_quant(d) == \
                tq.configure_matmul_quant(d)
            assert jq.active_matmul_dtype() == tq.active_matmul_dtype()
            assert jq.active_matmul_dtype("float32") == \
                tq.active_matmul_dtype("float32")
        for mod in (jq, tq):
            with pytest.raises(ValueError):
                mod.configure_matmul_quant("int4")
    finally:
        jq.configure_matmul_quant(before[0] or "none")
        tq.configure_matmul_quant(before[1] or "none")


def _layer_inputs():
    rng = np.random.default_rng(17)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa
    specs = {}
    for name in LAYERS:
        w = f32(K, O) * 0.05
        specs[name] = {"w": w, "b": f32(O), "x": f32(2, 4, K),
                       "g": f32(2, 4, O)}
        if name.startswith("column"):
            specs[name]["gather"] = name == "column_gather"
        else:
            specs[name]["parallel"] = name == "row_parallel"
    return specs


def _set(param, value):
    param._data = jax.device_put(jnp.asarray(value), param._data.sharding)


def _jax_layers(specs):
    out = {}
    prev = jq.get_matmul_quant()
    saved = mesh_mod._global_mesh[0]
    try:
        s = jdist.fleet.DistributedStrategy()
        s.hybrid_configs = {"dp_degree": -1, "mp_degree": MP,
                            "pp_degree": 1}
        jdist.fleet.init(is_collective=True, strategy=s)
        for q in QDTYPES:
            jq.configure_matmul_quant(q)
            for name, sp in specs.items():
                if name.startswith("column"):
                    layer = JL.ColumnParallelLinear(
                        K, O, has_bias=True, gather_output=sp["gather"])
                else:
                    layer = JL.RowParallelLinear(
                        K, O, has_bias=True, input_is_parallel=sp["parallel"])
                _set(layer.weight, sp["w"])
                _set(layer.bias, sp["b"])
                x = pt.to_tensor(sp["x"], stop_gradient=False)
                y = layer(x)
                (y * pt.to_tensor(sp["g"])).sum().backward()
                out[f"{q}:{name}"] = {
                    "y": np.asarray(y.numpy()), "dx": np.asarray(
                        x.grad.numpy()),
                    "dw": np.asarray(layer.weight.grad.numpy()),
                    "db": np.asarray(layer.bias.grad.numpy())}
        return out
    finally:
        jq.configure_matmul_quant(prev or "none")
        mesh_mod._global_mesh[0] = saved


def _port_one_rank(specs):
    out = {}
    prev = tq.get_matmul_quant()
    try:
        for q in QDTYPES:
            tq.configure_matmul_quant(q)
            for name, sp in specs.items():
                if name.startswith("column"):
                    layer = ColumnParallelLinear(K, O, gather_output=sp[
                        "gather"], device="cpu")
                else:
                    layer = RowParallelLinear(
                        K, O, input_is_parallel=sp["parallel"], device="cpu")
                with torch.no_grad():
                    layer.weight.copy_(torch.from_numpy(sp["w"].T.copy()))
                    layer.bias.copy_(torch.from_numpy(sp["b"]))
                x = torch.from_numpy(sp["x"]).requires_grad_()
                y = layer(x)
                (y * torch.from_numpy(sp["g"])).sum().backward()
                out[f"{q}:{name}"] = {
                    "y": y.detach().numpy(), "dx": x.grad.numpy(),
                    "dw": layer.weight.grad.numpy().T,
                    "db": layer.bias.grad.numpy()}
        return out
    finally:
        tq.configure_matmul_quant(prev or "none")


@pytest.fixture(scope="module")
def layers(tmp_path_factory):
    specs = _layer_inputs()
    handle = cases.start_world(MP, "quant", {"layers": specs},
                               tmp_path_factory.mktemp("quant"),
                               module="torch_cm_cases")
    ref = _jax_layers(specs)
    one = _port_one_rank(specs)
    return specs, ref, one, cases.finish_world(handle)


KEYS = [f"{q}:{name}" for q in QDTYPES for name in LAYERS]


@pytest.mark.parametrize("key", KEYS)
def test_quantized_layers_at_one_rank_match_jax(layers, key):
    _, ref, one, _ = layers
    for what in ("y", "dx", "dw", "db"):
        _close(one[key][what], ref[key][what], f"{key} {what}")


@pytest.mark.parametrize("key", KEYS)
def test_quantized_layers_at_mp2_match_jax(layers, key):
    """Each rank's output, input gradient and weight and bias gradients
    are its shards of the JAX ones."""
    specs, ref, _, world = layers
    name = key.split(":")[1]
    col = name.startswith("column")
    want = ref[key]
    for m, res in enumerate(world):
        got = res[key]
        y = want["y"] if name != "column" else shard(want["y"], 2, MP, m)
        dx = shard(want["dx"], 2, MP, m) if name == "row_parallel" \
            else want["dx"]
        _close(got["y"], y, f"{key} y r{m}")
        _close(got["dx"], dx, f"{key} dx r{m}")
        _close(got["dw"], shard(want["dw"], 1 if col else 0, MP, m),
               f"{key} dw r{m}")
        _close(got["db"], shard(want["db"], 0, MP, m) if col
               else want["db"], f"{key} db r{m}")
