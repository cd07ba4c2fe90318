"""Llama with ``pipeline_parallel=True`` in the port against the JAX
package, on the CPU.

The JAX side: the pipelined Llama (4 layers, tensor_parallel and
pipeline_parallel, pp_microbatches 2) on the 8 virtual devices under
fleet.init(dp 2, mp 2, pp 2), trained 5 AdamW steps by its TrainStep; and
the plain Llama of 8 layers, 5 steps on a batch whose -100 labels are
spread unevenly over its rows. Each runs once for the module.

The port's side runs in a world of 2 ranks (pp 2) and one of 4 (pp 2 x mp
2), gloo, spawned (tests/torch_dist_cases.py): each rank builds its stage
under fleet.init, loads its stage of the JAX weights
(convert.pp_params_from_jax) and trains through TrainStep, which runs the
1F1B or interleaved schedule over send/recv. pp 2 and pp 2 x mp 2 are held
to the JAX pipelined losses; the interleaved stack (virtual_pp_degree 2 on
8 layers, so that a wrong chunk map shows) and whole-stage recompute are
held to the JAX plain model, on the uneven labels, whose batch loss the
port must weigh by each microbatch's valid labels. Tolerance: the
reference's own pipeline-parity tolerance (tests/test_pipeline_llama.py:
rtol 2e-4, atol 2e-5). Tiny widths: vocab 128, hidden 64, 4 heads, batch
4 x 32, float32, XLA's attention on the JAX side.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import LlamaPretrainingCriterion as JaxCrit

from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

import torch_dist_cases as cases

STEPS, LR = 5, 1e-3
VOCAB, B, S = 128, 4, 32
RTOL, ATOL = 2e-4, 2e-5
CFG = dict(vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
           num_attention_heads=4, num_key_value_heads=4,
           max_position_embeddings=64, use_flash_attention=False)


def _np(t):
    return np.asarray(t.numpy(), np.float32)


def _jax_train(model, cfg, ids, labels):
    crit = JaxCrit(cfg)
    opt = pt.optimizer.AdamW(learning_rate=LR, parameters=model.parameters())
    step = pt.jit.TrainStep(model, lambda lg, lb: crit(lg, lb), opt)
    return [float(step((pt.to_tensor(ids, dtype="int64"),),
                       (pt.to_tensor(labels, dtype="int64"),)))
            for _ in range(STEPS)]


def _uneven_labels(rng):
    """Labels with -100 over most of row 0, a few of row 2, none of rows 1
    and 3: the microbatches count different numbers of valid labels."""
    labels = rng.integers(0, VOCAB, (B, S))
    labels[0, 4:] = -100
    labels[2, ::7] = -100
    return labels


def _spec(sd, ids, labels, pp=2, mp=1, **cfg):
    return {"family": "llama", "pp": pp, "mp": mp, "sd": sd, "ids": ids,
            "labels": labels, "cfg": dict(CFG, **cfg)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rng = np.random.default_rng(11)
    ids_a = rng.integers(0, VOCAB, (B, S))
    labels_a = rng.integers(0, VOCAB, (B, S))
    ids_b = rng.integers(0, VOCAB, (B, S))
    labels_b = _uneven_labels(rng)
    saved = mesh_mod._global_mesh[0]
    try:
        s = jdist.fleet.DistributedStrategy()
        s.hybrid_configs = {"dp_degree": 2, "mp_degree": 2, "pp_degree": 2}
        jdist.fleet.init(is_collective=True, strategy=s)
        pt.seed(77)
        pcfg = JaxConfig(num_hidden_layers=4, tensor_parallel=True,
                         pipeline_parallel=True, pp_microbatches=2, **CFG)
        piped = JaxLlama(pcfg)
        piped_sd = {k: _np(v) for k, v in piped.state_dict().items()}
        pt.seed(31)
        plain_cfg = JaxConfig(num_hidden_layers=8, **CFG)
        plain = JaxLlama(plain_cfg)
        plain_sd = {k: _np(v) for k, v in plain.state_dict().items()}
        a = dict(sd=piped_sd, ids=ids_a, labels=labels_a)
        b = dict(sd=plain_sd, ids=ids_b, labels=labels_b)
        two = {"lr": LR, "steps": STEPS, "train": {
            "pp": _spec(**a, num_hidden_layers=4, pp_microbatches=2),
            "pp_unroll": _spec(**a, num_hidden_layers=4, pp_microbatches=2,
                               pipeline_save_mode="unroll"),
            "pp_buffer": _spec(**a, num_hidden_layers=4, pp_microbatches=2,
                               pipeline_save_mode="buffer"),
            "vpp": _spec(**b, num_hidden_layers=8, pp_microbatches=4,
                         virtual_pp_degree=2),
            "stage": _spec(**b, num_hidden_layers=8, pp_microbatches=2,
                           recompute=True, recompute_granularity="stage")},
            "layouts": {
                "vpp": _spec(**a, num_hidden_layers=4, pp_microbatches=2,
                             virtual_pp_degree=2)},
            "runner": {"ws": rng.standard_normal((8, 8, 8)).astype(
                np.float32) * 0.3,
                "x": rng.standard_normal((4, 2, 8)).astype(np.float32)},
            "errors": {
                "layers": _spec(**a, num_hidden_layers=6,
                                virtual_pp_degree=2, pp_microbatches=2),
                "policy": _spec(**a, num_hidden_layers=4, recompute=True,
                                recompute_policy="dots"),
                "sequence": _spec(**a, num_hidden_layers=4,
                                  sequence_parallel=True),
                "save_mode": _spec(**a, num_hidden_layers=4,
                                   virtual_pp_degree=2,
                                   pipeline_save_mode="buffer")}}
        four = {"lr": LR, "steps": STEPS, "train": {
            "pp_mp": _spec(**a, mp=2, num_hidden_layers=4,
                           pp_microbatches=2, tensor_parallel=True)},
            "layouts": {"pp_mp": _spec(**a, mp=2, num_hidden_layers=4,
                                       tensor_parallel=True)},
            "runner": two["runner"], "errors": {}}
        tmp = tmp_path_factory.mktemp("pipeline")
        handles = [cases.start_world(2, "pipeline", two, tmp),
                   cases.start_world(4, "pipeline", four, tmp)]
        ref = {"piped": _jax_train(piped, pcfg, ids_a, labels_a),
               "plain": _jax_train(plain, plain_cfg, ids_b, labels_b),
               "piped_sd": piped_sd, "ids_a": ids_a, "runner": two["runner"]}
        return ref, [cases.finish_world(h) for h in handles]
    finally:
        mesh_mod._global_mesh[0] = saved


def _losses(world, name):
    got = [r[name]["losses"] for r in world]
    for g in got[1:]:
        assert g == got[0], f"{name}: the pp ranks return different losses"
    return got[0]


@pytest.mark.parametrize("world,name,ref", [
    (0, "pp", "piped"), (1, "pp_mp", "piped"), (0, "vpp", "plain"),
    (0, "stage", "plain")])
def test_losses_match_jax(run, world, name, ref):
    refs, worlds = run
    np.testing.assert_allclose(_losses(worlds[world], name), refs[ref],
                               rtol=RTOL, atol=ATOL)


def test_uneven_labels_weigh_microbatches_by_valid_count(run):
    """The -100 labels of batch B sit unevenly: the plain mean of the
    microbatch means differs from the batch loss, which the port matches."""
    refs, worlds = run
    labels = _uneven_labels(np.random.default_rng(0))
    valid = (labels != -100).sum(1)
    assert len(set(valid.tolist())) > 1
    np.testing.assert_allclose(_losses(worlds[0], "vpp")[0],
                               refs["plain"][0], rtol=RTOL, atol=ATOL)


def test_losses_equal_across_save_modes(run):
    _, worlds = run
    assert _losses(worlds[0], "pp_unroll") == _losses(worlds[0], "pp")
    assert _losses(worlds[0], "pp_buffer") == _losses(worlds[0], "pp")


def test_schedule_stats(run):
    """pp 2 with 2 microbatches: 4 instructions a rank, one activation
    and one gradient message of [2, 32, 64] float32 each way a
    microbatch; vpp 2 with 4 microbatches: 16 instructions a rank."""
    _, worlds = run
    for r in worlds[0]:
        assert r["pp"]["stats"]["instructions"] == 4
        assert r["pp"]["stats"]["p2p_messages"] == 2
        assert r["pp"]["stats"]["p2p_bytes"] == 2 * 2 * S * 64 * 4
        assert r["pp"]["stats"]["microbatches"] == 2
        assert r["vpp"]["stats"]["instructions"] == 16


def test_state_dict_round_trip_in_natural_order(run):
    """The JAX pipelined model's stacked state dict -> each rank's stage
    (vpp 2, and pp 2 x mp 2) -> gathered back on stage 0: the JAX state
    dict, exactly."""
    refs, worlds = run
    for world, name in ((0, "vpp"), (1, "pp_mp")):
        for r in worlds[world]:
            got = r["layout:" + name]["to_jax"]
            if got is None:
                continue
            assert set(got) == set(refs["piped_sd"])
            for k, v in refs["piped_sd"].items():
                np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_stage_layers_and_parameter_share(run):
    """vpp 2 at pp 2 on 4 layers: stage s holds chunks [s] and [2 + s]
    (natural index), named by it; at pp 2 x mp 2 a rank holds 1/pp of
    every stacked weight and 1/(pp mp) of the tensor-parallel ones."""
    _, worlds = run
    for s, r in enumerate(worlds[0]):
        lay = r["layout:vpp"]
        assert lay["chunks"] == [[s], [2 + s]]
        layers = {int(k.split(".")[3]) for k in lay["names"]
                  if ".decoder_stack.layers." in k}
        assert layers == {s, 2 + s}
        assert all(f == 2 for f in lay["factors"].values())
    for r in worlds[1]:
        f = r["layout:pp_mp"]["factors"]
        assert {k for k, v in f.items() if v == 2} == {"ln1", "ln2"}
        assert all(v == 4 for k, v in f.items() if not k.startswith("ln"))


def test_forward_returns_the_logits_on_every_rank(run):
    """forward on each rank of the vpp 2 model: the one-rank port model's
    logits on the same weights."""
    refs, worlds = run
    sd = {}
    for k, v in refs["piped_sd"].items():
        if ".decoder_stack." in k:
            from paddle_tpu_torch.models.llama_pipe import (
                LlamaStackedDecoder)
            path = ".".join(LlamaStackedDecoder._LAYER_ATTRS[
                k.rsplit(".", 1)[1]])
            for l in range(v.shape[0]):
                sd[f"llama.layers.{l}.{path}"] = v[l]
        else:
            sd[k] = v
    cfg = LlamaConfig(num_hidden_layers=4, **CFG)
    plain = LlamaForCausalLM(cfg, device="cpu")
    plain.load_state_dict(params_from_jax(sd, cfg))
    with torch.no_grad():
        want = plain(torch.from_numpy(refs["ids_a"])).numpy()
    for r in worlds[0]:
        np.testing.assert_allclose(r["layout:vpp"]["logits"], want,
                                   rtol=1e-5,
                                   atol=1e-5)


def test_whole_state_dict_loads_into_each_stage(run):
    """set_state_dict takes the whole model's natural-order state dict
    (every stage's entries, whole tensors) and loads this rank's, at vpp
    2 and at pp 2 x mp 2 (tensor-parallel shards cut on the way)."""
    _, worlds = run
    for world, name in ((0, "vpp"), (1, "pp_mp")):
        for r in worlds[world]:
            lay = r["layout:" + name]
            assert lay["reloaded"] and lay["reload_missing"] == []


def test_attention_mask_is_refused_under_the_pipeline(run):
    _, worlds = run
    for r in worlds[0]:
        kind, msg = r["layout:vpp"]["mask_error"]
        assert kind == "ValueError" and "attn_mask" in msg


def test_forward_runners_apply_the_stages_in_order(run):
    refs, worlds = run
    ws, x = refs["runner"]["ws"], refs["runner"]["x"]
    for world in worlds:
        n = len(world)
        for key, order in (("runner", range(n)),
                           ("runner_vpp", range(2 * n))):
            want = x.copy()
            for k in order:
                want = np.tanh(want @ ws[k])
            for r in world:
                np.testing.assert_allclose(r[key], want, rtol=1e-5,
                                           atol=1e-6)


@pytest.mark.parametrize("name,kind,match", [
    ("layers", "ValueError", "must divide num_hidden_layers"),
    ("policy", "NotImplementedError", "recompute_policy"),
    ("sequence", "NotImplementedError", "sequence_parallel"),
    ("save_mode", "ValueError", "pipeline_save_mode")])
def test_unsupported_and_invalid_configs_raise(run, name, kind, match):
    _, worlds = run
    for r in worlds[0]:
        err = r["errors"][name]
        assert err is not None and err[0] == kind and match in err[1], err


def test_pipeline_needs_a_pp_topology():
    with pytest.raises(ValueError, match="pp topology"):
        LlamaForCausalLM(LlamaConfig(num_hidden_layers=4,
                                     pipeline_parallel=True, **CFG),
                         device="cpu")
    with pytest.raises(ValueError, match="recompute_granularity"):
        LlamaConfig(recompute_granularity="block")
