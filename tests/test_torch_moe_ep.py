"""The port's expert-parallel MoE (MoELayer under fleet's ep axis, the
all-to-all exchange of dispatch.py, the capacity path's global drops, the
gate's whole-batch aux loss and ClipGradForMOEByGlobalNorm) against the
JAX package, on the CPU.

One world of 2 gloo ranks (tests/torch_zero_cases.py) runs
fleet.init(ep_degree=2) once for the module; rank r takes batch row r.
The JAX references are computed once: MoELayer on a 2-device ``ep`` mesh
(tests/test_moe.py:96-122 builds it that way), on the whole batch, with
the same weights (hidden 16, 4 experts, width 32, 2 x 16 tokens, float32
inputs from numpy on a seed, GShard gates with random_routing=False: the
two packages draw different random numbers). Loss = mean(out^2) + 0.01 x
aux on both sides; each rank's loss is the mean over its own rows, so
the JAX gradient of a dense parameter is the mean of the ranks', of an
expert the owner's over 2, and of an input row its rank's over 2.

Tolerances, and why:
- exact wire (dispatch_compress None) and the capacity path: outputs,
  aux loss and gradients within 1e-5 of each tensor's largest element
  (float32 products and sums in other orders);
- "bf16" and "int8" wires against JAX's codec run: both encode the same
  values the same way, but a value that differs by float noise before
  the codec may round to the neighbouring code, so at most 1 % of the
  elements may pass 1e-5 of the largest, and none may pass one code step
  of it (2^-8 for bf16, 1/127 for int8; two for gradients, which pass the
  codec twice more). At these sizes no element passes 1e-5;
- each codec lane departs from the exact lane: more than half of the
  elements of the output and of every gradient by more than 1e-5 of the
  largest (a lane that skipped its codec would equal the exact lane bit
  for bit; the codecs moved 95-100 % of them, by up to 0.2-1.5 %);
- ClipGradForMOEByGlobalNorm: the clipped gradients within 1e-5 of each
  tensor's largest (the scale is one float32 norm);
- the capacity path's kept-route mask equal to JAX's, element for element,
  with routes that really drop;
- GShard's random second-route drop (random_routing=True) and int8
  expert products (expert_quant) against the port's own layer on one
  process, its gate seeded alike: 1e-5 of the largest (each rank draws
  the whole batch's uniforms and keeps its rows; it quantizes its own
  experts as one process quantizes all).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt  # noqa: F401  (installs the JAX shims first)
import jax
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.incubate.distributed.models.moe import (
    ClipGradForMOEByGlobalNorm as JClip, GShardGate as JGShard,
    MoELayer as JMoELayer)
from paddle_tpu.incubate.distributed.models.moe.moe_layer import (
    _route as jroute)

from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.incubate.distributed.models.moe import (
    ExpertMLP, GShardGate, MoELayer)
from paddle_tpu_torch.incubate.distributed.models.moe.dispatch import (
    dispatch_wire_bytes)

import torch_dist_cases as cases

N = 2
H, E, F, S = 16, 4, 32, 16
BM = 8                       # JAX's group alignment (its "auto" reads a
AUX = 0.01                   # cache); the port's layers use "auto" (128)
CLIP = 0.02
TOL = 1e-5
CODEC_STEP = {"bf16": 2.0 ** -8, "int8": 1.0 / 127}
CODEC_FLIPS = 0.01           # elements of a codec lane past TOL (code flips)
CODEC_MOVES = 0.5            # elements a codec must move past TOL
CONFIGS = {"grouped": {"mode": "grouped"},
           "grouped_bf16": {"mode": "grouped", "compress": "bf16"},
           "grouped_int8": {"mode": "grouped", "compress": "int8"},
           "capacity_drops": {"mode": "capacity", "cf": 0.5}}
# held against the port's own layer on one process: GShard's random
# second-route drop (the JAX package draws other numbers) and int8 expert
# products (the JAX package's ep path ignores expert_quant)
PORT_ONLY = {"grouped_random": {"mode": "grouped", "random": True},
             "grouped_expert_int8": {"mode": "grouped", "quant": "int8"}}


def _jax_run(spec, x):
    """JAX MoELayer on the 2-way ep mesh: weights, output, aux loss and
    gradients of mean(out^2) + AUX x aux, and the capacity path's
    kept-route mask."""
    mesh_mod._global_mesh[0] = None
    mesh_mod.build_mesh(["ep"], [N], devices=jax.devices()[:N])
    try:
        pt.seed(17)
        layer = JMoELayer(d_model=H, num_expert=E, d_hidden=F,
                          gate=JGShard(H, E, random_routing=False),
                          dispatch_mode=spec["mode"],
                          capacity_factor=spec.get("cf", 1.25),
                          group_block=BM,
                          dispatch_compress=spec.get("compress"))
        sd = {k: np.asarray(v.numpy(), np.float32)
              for k, v in layer.state_dict().items()}
        xt = pt.to_tensor(x)
        xt.stop_gradient = False
        out = layer(xt)
        aux = layer.gate.get_loss()
        ((out ** 2).mean() + AUX * aux).backward()
        grads = {k: np.asarray(p.grad.numpy())
                 for k, p in layer.named_parameters()}
        clipped = JClip(CLIP)([(p, p.grad) for p in layer.parameters()])
        res = {"sd": sd, "out": np.asarray(out.numpy()),
               "aux": float(aux.numpy()), "x_grad": np.asarray(xt.grad.numpy()),
               "grads": grads,
               "clipped": {k: np.asarray(g.numpy()) for (k, _), (_, g)
                           in zip(layer.named_parameters(), clipped)}}
        if spec["mode"] == "capacity":
            idx = layer.gate(pt.to_tensor(x.reshape(-1, H)))[1]
            cap = layer._capacity(x.shape[0] * x.shape[1])
            _, valid = jroute(idx, num_expert=E, capacity=cap)
            res["valid"] = np.asarray(valid.numpy())
        return res
    finally:
        mesh_mod._global_mesh[0] = None


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    x = np.random.default_rng(23).standard_normal((N, S, H)) \
        .astype(np.float32)
    refs = {name: _jax_run(spec, x) for name, spec in CONFIGS.items()}
    refs["x"] = x
    sd = refs["grouped"]["sd"]
    for ref in CONFIGS:                 # every layer drew the same weights
        for k, v in refs[ref]["sd"].items():
            np.testing.assert_array_equal(v, sd[k])
    payload = {"H": H, "E": E, "F": F, "bm": "auto", "aux_coef": AUX,
               "clip_norm": CLIP, "clip_config": "grouped", "x": x,
               "configs": {**CONFIGS, **PORT_ONLY},
               "gate_w": sd["gate.gate.weight"],
               "gate_b": sd["gate.gate.bias"],
               **{k: sd["experts." + k] for k in ("w1", "b1", "w2", "b2")}}
    results = cases.run_world(N, "moe_ep", payload,
                              tmp_path_factory.mktemp("moe_ep"),
                              module="torch_zero_cases")
    return refs, results


def _port_grads(results, name):
    """The JAX-layout gradients of the whole batch's loss from the ranks'
    local-mean gradients."""
    out = {}
    for k in results[0][name]:
        if not k.startswith("grad:"):
            continue
        key = k[5:]
        parts = [r[name][k] for r in results]
        if key.startswith("experts."):
            g = np.concatenate(parts) / N
        else:
            g = np.mean(parts, axis=0)
        out[key] = g.T if key == "gate.gate.weight" else g
    return out


def _assert_matches(got, ref, name, grads=False, what=""):
    """Exact lanes within TOL of the largest element; codec lanes within
    one code step (two for gradients), at most CODEC_FLIPS of the elements
    past TOL."""
    big = np.abs(ref).max()
    comp = CONFIGS[name].get("compress")
    if comp is None:
        np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * big,
                                   err_msg=what)
        return
    step = CODEC_STEP[comp] * (2 if grads else 1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=step * big,
                               err_msg=what)
    flips = float((np.abs(got - ref) > TOL * big).mean())
    assert flips <= CODEC_FLIPS, (what, flips)


def _lane(results, name):
    """The whole batch's output, input gradient and JAX-layout parameter
    gradients of one configuration."""
    return {"out": np.concatenate([r[name]["out"] for r in results]),
            "x_grad": np.concatenate([r[name]["x_grad"]
                                      for r in results]) / N,
            **_port_grads(results, name)}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_jax(world, name):
    refs, results = world
    ref = refs[name]
    _assert_matches(_lane(results, name)["out"], ref["out"], name)
    for r in results:          # the aux loss of the whole batch, on each
        np.testing.assert_allclose(r[name]["aux"], ref["aux"], rtol=TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_gradients_match_jax(world, name):
    refs, results = world
    ref = refs[name]
    got = _lane(results, name)
    _assert_matches(got.pop("x_grad"), ref["x_grad"], name, True, "x")
    got.pop("out")
    assert set(got) == set(ref["grads"])
    for k, g in got.items():
        _assert_matches(g, ref["grads"][k], name, True, k)


@pytest.mark.parametrize("name", ["grouped_bf16", "grouped_int8"])
def test_codec_lanes_depart_from_the_exact_lane(world, name):
    """The codec acts: more than CODEC_MOVES of the elements of the output
    and of every gradient differ from the exact wire's by more than TOL
    of the largest."""
    _, results = world
    exact, got = _lane(results, "grouped"), _lane(results, name)
    assert set(got) == set(exact)
    for k, v in got.items():
        moved = np.abs(v - exact[k]) > TOL * np.abs(exact[k]).max()
        assert moved.mean() > CODEC_MOVES, (k, moved.mean())


@pytest.mark.parametrize("name", list(PORT_ONLY))
def test_matches_the_port_on_one_process(world, name):
    """grouped_random: each rank's gate draws the whole batch's uniforms
    and keeps its rows, so the ep run's random second-route drops are one
    process's; grouped_expert_int8: each rank quantizes its own experts
    as one process quantizes all. The port's MoELayer on the whole batch,
    its gate seeded alike, gives the same outputs and input gradients."""
    refs, results = world
    spec = PORT_ONLY[name]
    sd = refs["grouped"]["sd"]
    layer = MoELayer(d_model=H, num_expert=E, d_hidden=F,
                     gate=GShardGate(H, E, random_routing=bool(
                         spec.get("random")), device="cpu"),
                     dispatch_mode="grouped",
                     expert_quant=spec.get("quant"), device="cpu")
    with torch.no_grad():
        layer.gate.gate.weight.copy_(torch.tensor(sd["gate.gate.weight"]).t())
        layer.gate.gate.bias.copy_(torch.tensor(sd["gate.gate.bias"]))
        for k in ("w1", "b1", "w2", "b2"):
            getattr(layer.experts, k).copy_(torch.tensor(sd["experts." + k]))
    x = torch.from_numpy(refs["x"].copy()).requires_grad_()
    out = layer(x)
    ((out ** 2).mean() + AUX * layer.gate.get_loss()).backward()
    got = np.concatenate([r[name]["out"] for r in results])
    ref = out.detach().numpy()
    assert not np.allclose(got, np.concatenate(
        [r["grouped"]["out"] for r in results]))     # the option acts
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=TOL * np.abs(ref).max())
    gx = np.concatenate([r[name]["x_grad"] for r in results])
    np.testing.assert_allclose(gx / N, x.grad.numpy(), rtol=0,
                               atol=TOL * np.abs(x.grad.numpy()).max())


def test_capacity_drops_the_routes_jax_drops(world):
    refs, results = world
    valid = refs["capacity_drops"]["valid"]
    assert (valid == 0).sum() > 0                  # routes really drop
    for r in results:
        np.testing.assert_array_equal(r["capacity_drops"]["valid"], valid)


def test_each_rank_holds_its_experts(world):
    _, results = world
    for rank, r in enumerate(results):
        assert r["grouped"]["expert_offset"] == rank * E // N
        assert r["grouped"]["expert_marked"] == [True] * 4
        assert r["grouped"]["bm"] == 128       # group_block "auto"
    assert results[0]["groups"] == ([0, 1], [0])
    assert results[1]["groups"] == ([0, 1], [1])
    assert results[0]["world_size_gate"] == E


@pytest.mark.parametrize("name", ["grouped", "grouped_bf16",
                                  "grouped_int8"])
def test_exchange_bytes_are_priced(world, name):
    """Four exchanges a layer (two forward, two backward), and the wire
    bytes counted from the payload the codec encoded equal to what
    dispatch_wire_bytes prices: [ep, cap, H] a direction."""
    _, results = world
    comp = CONFIGS[name].get("compress")
    want = 2 * dispatch_wire_bytes(N, S * 2, H, 4, comp)
    for r in results:
        assert r[name]["a2a_calls"] == 4
        assert r[name]["a2a_bytes"] == r[name]["priced_bytes"] == want
    if comp:
        assert want < 2 * dispatch_wire_bytes(N, S * 2, H, 4, None)


def test_moe_clip_matches_jax(world):
    refs, results = world
    ref = refs["grouped"]["clipped"]
    got = {}
    for k in results[0]["grouped"]["clipped"]:
        parts = [r["grouped"]["clipped"][k] for r in results]
        g = np.concatenate(parts) if k.startswith("experts.") else parts[0]
        got[k] = g.T if k == "gate.gate.weight" else g
        if not k.startswith("experts."):
            np.testing.assert_array_equal(parts[0], parts[1])
    total = np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                        for v in refs["grouped"]["grads"].values()))
    assert total > CLIP                            # the clip really bites
    for k, g in got.items():
        np.testing.assert_allclose(g, ref[k], rtol=0,
                                   atol=TOL * np.abs(ref[k]).max(),
                                   err_msg=k)


@pytest.mark.parametrize("what,kind", [
    ("mp_group", "NotImplementedError"),
    ("moe_group_type", "TypeError"),
    ("expert_list", "NotImplementedError"),
    ("capacity_compress", "NotImplementedError"),
    ("clip_without_func", "ValueError"),
    ("plain_clip_over_experts", "NotImplementedError"),
    ("odd_experts", "ValueError")])
def test_out_of_scope_options_raise(world, what, kind):
    _, results = world
    for r in results:
        assert r["errors"][what] is not None and \
            r["errors"][what][0] == kind, r["errors"][what]


def test_ep_axes_need_a_topology_and_strategy_knobs_validate():
    with pytest.raises(ValueError, match="fleet.init"):
        ExpertMLP(E, H, F, ep_axes=("ep",), device="cpu")
    assert GShardGate(H, E // 2, world_size=2, device="cpu").tot_expert == E
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"ep_degree": 2}
    s.dispatch_compress = "int8"
    assert s.validate() is s
    s.dispatch_compress = "fp8"
    with pytest.raises(ValueError, match="dispatch_compress"):
        s.validate()
    layer = MoELayer(d_model=H, num_expert=E, d_hidden=F,
                     dispatch_compress="bf16", device="cpu")
    assert layer.dispatch_compress == "bf16" and layer._ep is None


@pytest.mark.parametrize("mode", ["train", "eval", "no_grad"])
def test_aux_loss_averages_over_the_group_only_in_training(monkeypatch,
                                                           mode):
    """A gate with a group averages its aux-loss means over it only in
    training with gradients enabled; an eval or no_grad forward (evaluation
    or generation on some ranks) calls no collective and gives this rank's
    own aux loss."""
    from paddle_tpu_torch.incubate.distributed.models.moe import dispatch

    class Pair:                          # a stand-in group of two ranks
        nranks, rank = 2, 0
    calls = []

    def spy(x, group):
        calls.append(group)
        return x
    monkeypatch.setattr(dispatch, "group_mean", spy)
    gate = GShardGate(H, E, random_routing=False, device="cpu")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (S, H)).astype(np.float32))
    gate(x)
    local = float(gate.get_loss().detach())
    gate.group = Pair()
    if mode == "eval":
        gate.eval()
    with torch.set_grad_enabled(mode != "no_grad"):
        gate(x)
    assert len(calls) == (2 if mode == "train" else 0)
    np.testing.assert_allclose(float(gate.get_loss().detach()), local,
                               rtol=1e-6)
