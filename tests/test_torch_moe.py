"""The port's MoE gates and MoELayer against the JAX package, on the CPU.

Each JAX layer is built from a seed; its weights cross to the port through
convert.moe_params_from_jax, and both get the same numpy inputs. The
port's grouped dispatch runs the plain versions of its grouped kernels
(CPU tensors); the JAX layer runs its own CPU path (the XLA reference of
its grouped kernel). Both use the same explicit bm.

Tolerances, and why:
- routing: top-k indices equal, and the auxiliary loss to 1e-6 relative.
  Where an index differs, the two probabilities must tie within 1e-6
  (softmax in two frameworks may differ in the last ulp, and top-k may
  then order a near-tie either way);
- gate values, layer outputs and parameter gradients in float32: 1e-5 of
  each tensor's largest element (products and sums in other orders);
- GShard's random second-route drop and Switch's jitter draw from
  different generators in the two packages, so they are held with the
  same uniforms handed to both (keep the second route when 2 p2 > r).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.ops.creation as jcreation
from paddle_tpu.incubate.distributed.models.moe import (
    GShardGate as JGShard, MoELayer as JMoELayer, NaiveGate as JNaive,
    SwitchGate as JSwitch)

from paddle_tpu_torch.convert import moe_params_from_jax
from paddle_tpu_torch.incubate.distributed.models.moe import (
    ExpertMLP, GShardGate, MoELayer, NaiveGate, SwitchGate)
from paddle_tpu_torch.incubate.distributed.models.moe.moe_layer import (
    _route)
from paddle_tpu_torch.models.gpt_moe import GPTMoEConfig

H, E, F = 32, 4, 64
BM = 8
REL_TOL = 1e-5
TIE_TOL = 1e-6


def _cfg():
    return GPTMoEConfig(hidden_size=H, num_experts=E, d_hidden=F,
                        vocab_size=16, num_heads=4)


def _x(seed, b=2, s=16):
    return np.random.default_rng(seed).standard_normal((b, s, H)).astype(
        np.float32)


def _jgate(kind, **kw):
    cls = {"naive": JNaive, "switch": JSwitch, "gshard": JGShard}[kind]
    return cls(H, E, topk=1 if kind == "switch" else 2, **kw)


def _tgate(kind, **kw):
    cls = {"naive": NaiveGate, "switch": SwitchGate,
           "gshard": GShardGate}[kind]
    return cls(H, E, topk=1 if kind == "switch" else 2, device="cpu", **kw)


def _pair(seed, kind="gshard", gate_kw=None, **layer_kw):
    """A JAX MoELayer from ``seed`` and the port's with its weights."""
    gate_kw = gate_kw or {}
    pt.seed(seed)
    jl = JMoELayer(d_model=H, num_expert=E, d_hidden=F,
                   gate=_jgate(kind, **gate_kw), **layer_kw)
    tl = MoELayer(d_model=H, num_expert=E, d_hidden=F,
                  gate=_tgate(kind, **gate_kw), device="cpu", **layer_kw)
    sd = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    tl.load_state_dict(moe_params_from_jax(sd, _cfg()))
    return jl, tl


def _assert_routing_equal(jval, jidx, tval, tidx, probs):
    """Indices equal, or the differing routes tie within TIE_TOL."""
    jidx = np.asarray(jidx)
    tidx = tidx.numpy()
    bad = np.argwhere(jidx != tidx)
    for r, c in bad:
        p = probs[r]
        assert abs(p[jidx[r, c]] - p[tidx[r, c]]) <= TIE_TOL, (r, c)
    np.testing.assert_allclose(tval.detach().numpy(), np.asarray(jval),
                               rtol=0, atol=REL_TOL)


@pytest.mark.parametrize("kind", ["naive", "switch", "gshard"])
def test_gates_match_jax(kind):
    gate_kw = {"random_routing": False} if kind == "gshard" else {}
    jl, tl = _pair(1, kind, gate_kw)
    jl.eval()
    tl.eval()
    flat = _x(2).reshape(-1, H)
    jv, ji = jl.gate(pt.to_tensor(flat))
    tv, ti = tl.gate(torch.from_numpy(flat))
    assert ti.dtype == torch.int32 and tuple(ti.shape) == tuple(ji.shape)
    probs = torch.softmax(tl.gate.gate(torch.from_numpy(flat)), -1) \
        .detach().numpy()
    _assert_routing_equal(jv.numpy(), ji.numpy(), tv, ti, probs)
    if kind == "naive":
        assert tl.gate.loss is None
    else:
        np.testing.assert_allclose(tl.gate.get_loss().item(),
                                   float(jl.gate.get_loss().numpy()),
                                   rtol=1e-6)
        assert tl.gate.loss is None


def test_gshard_keep_rule_on_shared_uniforms(monkeypatch):
    """In training, the second route is kept where 2 p2 > r: the same
    uniforms r go to both gates."""
    jl, tl = _pair(3, "gshard")
    flat = _x(4).reshape(-1, H)
    r = np.random.default_rng(5).uniform(0, 0.6, flat.shape[0]).astype(
        np.float32)
    monkeypatch.setattr(jcreation, "rand",
                        lambda shape, dtype=None, name=None: pt.to_tensor(r))
    monkeypatch.setattr(tl.gate, "_uniform",
                        lambda shape, like: torch.from_numpy(r))
    jv, ji = jl.gate(pt.to_tensor(flat))
    tv, ti = tl.gate(torch.from_numpy(flat))
    tv = tv.detach().numpy()
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji.numpy()))
    np.testing.assert_allclose(tv, np.asarray(jv.numpy()), rtol=0,
                               atol=REL_TOL)
    dropped = tv[:, 1] == 0
    assert 0 < dropped.sum() < len(r)            # the rule both ways
    p2 = torch.softmax(tl.gate.gate(torch.from_numpy(flat)), -1) \
        .topk(2, -1).values[:, 1].detach().numpy()
    np.testing.assert_array_equal(dropped, ~(2 * p2 > r))


def test_switch_jitter_on_shared_uniforms(monkeypatch):
    jl, tl = _pair(6, "switch")
    flat = _x(7).reshape(-1, H)
    u = np.random.default_rng(8).uniform(size=(flat.shape[0], E)).astype(
        np.float32)
    monkeypatch.setattr(jcreation, "rand",
                        lambda shape, dtype=None, name=None: pt.to_tensor(u))
    monkeypatch.setattr(tl.gate, "_uniform",
                        lambda shape, like: torch.from_numpy(u))
    jv, ji = jl.gate(pt.to_tensor(flat))
    tv, ti = tl.gate(torch.from_numpy(flat))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji.numpy()))
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv.numpy()),
                               rtol=0, atol=REL_TOL)
    np.testing.assert_allclose(tl.gate.loss.item(),
                               float(jl.gate.loss.numpy()), rtol=1e-6)


def _run_pair(jl, tl, x, seed):
    """Outputs and parameter gradients of loss = sum(out * g) on both."""
    g = np.random.default_rng(seed).standard_normal(x.shape).astype(
        np.float32)
    jout = jl(pt.to_tensor(x))
    (jout * pt.to_tensor(g)).sum().backward()
    tout = tl(torch.from_numpy(x))
    (tout * torch.from_numpy(g)).sum().backward()
    jgrads = {k: np.asarray(p.grad.numpy()) for k, p in
              jl.named_parameters()}
    tgrads = {k: p.grad.numpy() for k, p in tl.named_parameters()}
    return np.asarray(jout.numpy()), tout.detach().numpy(), jgrads, tgrads


def _assert_grads_close(jgrads, tgrads):
    assert set(jgrads) == set(tgrads)
    for k, ref in jgrads.items():
        got = tgrads[k].T if k == "gate.gate.weight" else tgrads[k]
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=REL_TOL * np.abs(ref).max(),
                                   err_msg=k)


@pytest.mark.parametrize("mode,cf", [("capacity", 1.25), ("capacity", 0.5),
                                     ("grouped", 1.25)])
def test_layer_matches_jax(mode, cf):
    """Outputs and every parameter gradient, in training mode with the
    GShard gate's random drop off; cf 0.5 makes the capacity path drop
    routes, which both packages must drop alike."""
    jl, tl = _pair(11, "gshard", {"random_routing": False},
                   dispatch_mode=mode, capacity_factor=cf, group_block=BM)
    x = _x(12)
    jout, tout, jgrads, tgrads = _run_pair(jl, tl, x, 13)
    np.testing.assert_allclose(tout, jout, rtol=0,
                               atol=REL_TOL * np.abs(jout).max())
    _assert_grads_close(jgrads, tgrads)
    if cf < 1:
        idx = np.array(jl.gate(pt.to_tensor(x.reshape(-1, H)))[1].numpy())
        _, valid = _route(torch.from_numpy(idx), E,
                          tl._capacity(x.shape[0] * x.shape[1]))
        assert (valid == 0).any()                # routes did drop


def test_expert_quant_int8_matches_jax():
    jl, tl = _pair(21, "gshard", {"random_routing": False},
                   dispatch_mode="grouped", group_block=BM,
                   expert_quant="int8")
    assert tl.expert_quant == "int8"
    jout, tout, jgrads, tgrads = _run_pair(jl, tl, _x(22), 23)
    np.testing.assert_allclose(tout, jout, rtol=0,
                               atol=REL_TOL * np.abs(jout).max())
    _assert_grads_close(jgrads, tgrads)


def test_expert_quant_auto_reads_the_knob(monkeypatch):
    from paddle_tpu_torch.kernels import quant_matmul
    monkeypatch.setitem(quant_matmul._MATMUL_QUANT, "dtype", "fp8")
    layer = MoELayer(d_model=H, num_expert=E, d_hidden=F,
                     dispatch_mode="grouped", device="cpu")
    assert layer.expert_quant == "fp8"
    out = layer(torch.from_numpy(_x(24)))
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("kind", ["switch", "gshard"])
def test_grouped_equals_capacity_when_nothing_drops(kind):
    """With capacity_factor E / top_k no route drops, and both dispatch
    modes compute one function: outputs and gradients
    (tests/test_moe.py:65 for the JAX layer)."""
    top_k = 1 if kind == "switch" else 2
    layers = {}
    for mode in ("capacity", "grouped"):
        gen = torch.Generator().manual_seed(31)
        gate = _tgate(kind, generator=gen) if kind == "switch" else \
            _tgate(kind, generator=gen, random_routing=False)
        layer = MoELayer(d_model=H, num_expert=E, d_hidden=F, gate=gate,
                         dispatch_mode=mode, capacity_factor=E / top_k,
                         group_block=16, device="cpu", generator=gen)
        layer.eval()
        layers[mode] = layer
    x = torch.from_numpy(_x(32))
    outs, grads = {}, {}
    for mode, layer in layers.items():
        out = layer(x)
        (out ** 2).sum().backward()
        outs[mode] = out.detach()
        grads[mode] = {k: p.grad for k, p in layer.named_parameters()}
    ref = outs["capacity"]
    torch.testing.assert_close(outs["grouped"], ref, rtol=0,
                               atol=REL_TOL * ref.abs().max().item())
    for k, r in grads["capacity"].items():
        torch.testing.assert_close(grads["grouped"][k], r, rtol=0,
                                   atol=REL_TOL * r.abs().max().item())


def test_bf16_activations_stay_bf16():
    for mode in ("capacity", "grouped"):
        layer = MoELayer(d_model=H, num_expert=E, d_hidden=F, gate="switch",
                         dispatch_mode=mode, device="cpu",
                         dtype=torch.bfloat16)
        layer.eval()
        out = layer(torch.from_numpy(_x(33)).to(torch.bfloat16))
        assert out.dtype == torch.bfloat16, mode


@pytest.mark.parametrize("kw,exc", [
    ({"moe_group": object()}, NotImplementedError),
    ({"mp_group": object()}, NotImplementedError),
    ({"dispatch_compress": "int8"}, NotImplementedError),
    ({"dispatch_compress": "bf16"}, NotImplementedError),
    ({"dispatch_compress": "fp4"}, ValueError),
    ({"dispatch_mode": "ep"}, ValueError),
    ({"expert_quant": "int4"}, ValueError),
    ({"group_block": "big"}, ValueError)])
def test_unported_and_bad_options_raise(kw, exc):
    with pytest.raises(exc):
        MoELayer(d_model=H, num_expert=E, d_hidden=F, device="cpu", **kw)


def test_unported_expert_and_gate_options_raise():
    with pytest.raises(NotImplementedError):
        ExpertMLP(E, H, F, ep_axes=("ep",), device="cpu")
    with pytest.raises(NotImplementedError):
        GShardGate(H, E, world_size=2, device="cpu")
    with pytest.raises(NotImplementedError):
        GShardGate(H, E, group=object(), device="cpu")
    experts = [torch.nn.Linear(H, H) for _ in range(E)]
    layer = MoELayer(d_model=H, experts=experts, gate="naive",
                     dispatch_mode="grouped", device="cpu")
    with pytest.raises(ValueError, match="grouped"):
        layer(torch.from_numpy(_x(34)))
    layer.dispatch_mode = "capacity"             # the list form's own path
    assert layer(torch.from_numpy(_x(34))).shape == (2, 16, H)


def test_converter_transposes_each_linear_once():
    """Expert stacks keep [E, K, N]; the gate's Linear is transposed; a
    shape that does not match the config raises."""
    pt.seed(41)
    jl = JMoELayer(d_model=H, num_expert=E, d_hidden=F, gate="gshard")
    sd = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    out = moe_params_from_jax(sd, _cfg())
    np.testing.assert_array_equal(out["gate.gate.weight"].numpy(),
                                  sd["gate.gate.weight"].T)
    for k in ("experts.w1", "experts.b1", "experts.w2", "experts.b2",
              "gate.gate.bias"):
        np.testing.assert_array_equal(out[k].numpy(), sd[k])
    assert tuple(out["experts.w1"].shape) == (E, H, F)
    bad = dict(sd, **{"experts.w1": sd["experts.w1"][:, :, :F - 1]})
    with pytest.raises(ValueError, match="experts.w1"):
        moe_params_from_jax(bad, _cfg())
