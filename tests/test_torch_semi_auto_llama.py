"""The port's semi-auto Llama (BASELINE configuration 5 at CPU size) against
the JAX package, on the CPU: a port of tests/test_semi_auto_llama.py.

The reference's config (vocab 128, hidden 64, ffn 128, 2 layers, 4 heads,
float32), its data (three [4, 32] id batches from default_rng(7)) and 3
AdamW steps at lr 1e-3, the weights drawn by the JAX package
(pt.seed(1234)) and loaded through convert.params_from_jax. One world of
4 gloo ranks (tests/torch_auto_parallel_cases.py) on the mesh
[[0, 1], [2, 3]] named ["dp", "mp"] runs, with the reference's megatron
shard_fn and the optimizer built before shard_layer:
- the port's dense model and its semi-auto model, MHA and GQA (2
  key-value heads over mp 2);
- a batch split over dp by shard_dataloader;
- DistModel under Strategy gradient_merge k_steps 2 on the dp-split
  batch (each rank's rows cut into the microbatches);
- TrainStep with accum_steps 2 and master_grad over the bf16 model;
- the reshard round trip.
The JAX package runs its dense training and its DistModel meanwhile.

Tolerances, and why:
- semi-auto losses against the JAX package's dense ones: rtol 2e-4,
  atol 2e-5, the reference's own (float32 through two packages);
- semi-auto losses against the port's dense run: 1e-6 relative (the
  same kernels on split heads; the all-reduces sum in another order);
- the split-batch losses against the port's dense run: 1e-5 relative
  (the loss and the gradients are summed over the two data ranks);
- parameters after step 3 (gathered by semi_auto_params_to_jax) against
  the JAX package's: 1e-5 absolute on every element (1/100 of lr: AdamW
  moves an element whose gradient is near zero by the sign of its
  rounding noise, up to lr a step, and none does here);
- the bf16 model, sharded and dense, under TrainStep(accum_steps=2,
  master_grad=True) against the JAX package's TrainStep with the same
  knobs from the same bf16 weights: losses BF16_RTOL relative (bf16
  through two packages; measured at most 3.5e-4, where a run with no
  update is 2.6e-3 off at step 2); parameters after the steps, over all
  elements, a mean difference of at most BF16_MEAN_ATOL (measured
  2.8e-5; no update: 1.7e-3), at most BF16_OFF_SHARE of elements more
  than one bf16 spacing apart (measured 2.4 %: AdamW moves an element
  whose gradient is near zero by the sign of its rounding noise; no
  update: 78 %), and none further than that sign noise can take it
  (2 lr a step) and two spacings;
- the round trip: equal.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.distributed as jdist

import torch_dist_cases as cases
from paddle_tpu_torch.nn.functional.flash_attention import attention_route

N = 4
STEPS = 3
LR = 1e-3
CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=4, max_position_embeddings=64,
           dtype="float32")
REF_RTOL, REF_ATOL = 2e-4, 2e-5
DENSE_RTOL = 1e-6
SPLIT_BATCH_RTOL = 1e-5
PARAM_ATOL = 1e-5
BF16_RTOL = 1e-3
BF16_MEAN_ATOL = 1e-4
BF16_OFF_SHARE = 0.05


def _jax_model(kv):
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM
    pt.seed(1234)
    model = LlamaForCausalLM(LlamaConfig(**dict(CFG,
                                                num_key_value_heads=kv)))
    return model, pt.optimizer.AdamW(learning_rate=LR,
                                     parameters=model.parameters())


def _sd(model):
    return {k: np.asarray(v.numpy(), np.float32)
            for k, v in model.state_dict().items()}


def _ce(logits, labels):
    v = CFG["vocab_size"]
    return pt.nn.CrossEntropyLoss()(
        logits.reshape([-1, v]).astype("float32"), labels.reshape([-1]))


def _jax_master_grad(ids):
    """The JAX package's bf16 model under TrainStep(accum_steps=2,
    master_grad=True): its weights, the losses of its steps, its
    parameters after them, and the losses with no update at all."""
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM
    pt.seed(1234)
    model = LlamaForCausalLM(LlamaConfig(**dict(CFG, dtype="bfloat16")))
    sd = _sd(model)
    batches = [pt.to_tensor(a, dtype="int64") for a in ids]
    with pt.no_grad():
        frozen = [float(_ce(model(x), x)) for x in batches]
    opt = pt.optimizer.AdamW(learning_rate=LR, parameters=model.parameters())
    step = pt.jit.TrainStep(model, _ce, opt, accum_steps=2,
                            master_grad=True)
    losses = [float(step((x,), (x,))) for x in batches]
    return sd, {"losses": losses, "params": _sd(model), "frozen": frozen}


def _jax_train(model, opt, ids):
    losses = []
    for a in ids:
        x = pt.to_tensor(a, dtype="int64")
        loss = _ce(model(x), x)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(7)
    ids = [rng.integers(0, 128, (4, 32)) for _ in range(STEPS)]
    models = {kv: _jax_model(kv) for kv in (4, 2)}
    sd_bf16, master_grad = _jax_master_grad(ids)
    inp = {"cfg": CFG, "lr": LR, "ids": ids, "sd_bf16": sd_bf16,
           "sd": {kv: _sd(m) for kv, (m, _) in models.items()},
           "w": np.random.default_rng(8).standard_normal(
               (8, 16)).astype(np.float32)}
    handle = cases.start_world(N, "semi_auto_llama", inp,
                               tmp_path_factory.mktemp("semi_auto"),
                               module="torch_auto_parallel_cases")
    ref = {f"dense_{kv}": _jax_train(m, opt, ids)
           for kv, (m, opt) in models.items()}
    ref["params_4"] = _sd(models[4][0])
    ref["master_grad"] = master_grad
    model, opt = _jax_model(4)
    dm, _ = jdist.to_static(model, None, _ce, opt, jdist.Strategy(
        {"gradient_merge": {"enable": True, "k_steps": 2}}))
    ref["dist_model"] = [float(dm(pt.to_tensor(a, dtype="int64"),
                                  pt.to_tensor(a, dtype="int64")))
                         for a in ids]
    return inp, ref, cases.finish_world(handle)


@pytest.mark.parametrize("kv", [4, 2], ids=["mha", "gqa"])
def test_semi_auto_llama_matches_dense(world, kv):
    inp, ref, res = world
    for r in res:
        semi = r[f"semi_{kv}"]
        assert all(np.isfinite(semi)) and semi[-1] != semi[0]
        np.testing.assert_allclose(semi, ref[f"dense_{kv}"], rtol=REF_RTOL,
                                   atol=REF_ATOL)
        np.testing.assert_allclose(semi, r[f"dense_{kv}"], rtol=DENSE_RTOL)
        # the optimizer built before shard_layer steps the DTensor
        # parameters the model holds, not stale copies
        assert all(r[f"opt_holds_{kv}"])
        # flash_attention ran on each rank's heads, a layer a step, by the
        # route its dtype and head dim pick (head dim 16: the plain one)
        route = attention_route(torch.float32, CFG["hidden_size"]
                                // CFG["num_attention_heads"])
        calls = r[f"flash_calls_{kv}"]
        assert calls[route] == STEPS * CFG["num_hidden_layers"]
        assert sum(calls.values()) == calls[route]
    assert all(r[f"semi_{kv}"] == res[0][f"semi_{kv}"] for r in res)


def test_semi_auto_params_match_jax_after_three_steps(world):
    inp, ref, res = world
    got, want = res[0]["params_4"], ref["params_4"]
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)


def test_sharded_gradients_are_the_shards(world):
    """Every split parameter's gradient after backward is its shard, laid
    out as the parameter (with the whole batch on every rank), not a
    partial whole gradient computed on every rank; with a batch split
    over dp only its dp placement is a pending Partial sum (the
    data-parallel all-reduce the step makes)."""
    inp, ref, res = world
    hd = CFG["hidden_size"]
    for r in res:
        assert tuple(r["local_q_rows"]) == (hd // 2, hd)
        assert r["grad_layout"] == []
        assert r["dp_grad_layout"] == []


def test_batch_split_over_dp_by_shard_dataloader(world):
    inp, ref, res = world
    for r in res:
        assert r["dp_local_rows"] == 2
        np.testing.assert_allclose(r["dp_sharded"], ref["dense_4"],
                                   rtol=REF_RTOL, atol=REF_ATOL)
        np.testing.assert_allclose(r["dp_sharded"], r["dense_4"],
                                   rtol=SPLIT_BATCH_RTOL)


def test_dist_model_gradient_merge_matches_jax(world):
    inp, ref, res = world
    for r in res:
        assert r["dist_model_accum"] == 2
        np.testing.assert_allclose(r["dist_model"], ref["dist_model"],
                                   rtol=REF_RTOL, atol=REF_ATOL)


def test_train_step_accum_master_grad_over_bf16_dtensors(world):
    """TrainStep with accum_steps 2 and master_grad over the bf16 semi-auto
    model, and over the port's dense bf16 model, against the JAX
    package's TrainStep with the same knobs from the same bf16 weights:
    the optimizer is handed a float32 gradient for every parameter, laid
    out as it; the losses are within BF16_RTOL of JAX's and the
    parameters after the steps agree as the module docstring says.
    Losses with no update at all lie outside BF16_RTOL, so a step that
    skips the update fails."""
    inp, ref, res = world
    want = ref["master_grad"]
    n_params = len(ref["params_4"])
    frozen, w_losses = np.array(want["frozen"]), np.array(want["losses"])
    assert frozen[0] == pytest.approx(w_losses[0], rel=BF16_RTOL)
    assert np.all(np.abs(frozen[1:] - w_losses[1:])
                  > BF16_RTOL * np.abs(w_losses[1:]))
    for r in res:
        got = r["master_grad"]
        assert got["sharded"]["param_dtypes"] == ["torch.bfloat16"]
        for handed in got["sharded"]["handed"]:
            assert handed == [("torch.float32", True)] * n_params
        for run in ("sharded", "dense"):
            np.testing.assert_allclose(got[run]["losses"], w_losses,
                                       rtol=BF16_RTOL, err_msg=run)
    names = sorted(want["params"])
    w = np.concatenate([want["params"][k].ravel() for k in names])
    spacing = np.spacing(np.abs(w)) * 2.0 ** 16      # bf16's, at each w
    for run in ("sharded", "dense"):
        params = res[0]["master_grad"][run]["params"]
        assert set(params) == set(names)
        d = np.abs(np.concatenate([params[k].ravel() for k in names]) - w)
        assert d.mean() <= BF16_MEAN_ATOL, run
        assert (d > spacing).mean() <= BF16_OFF_SHARE, run
        assert np.all(d <= 2 * LR * STEPS + 2 * spacing), run


def test_reshard_roundtrip_keeps_values(world):
    inp, ref, res = world
    for r in res:
        np.testing.assert_array_equal(r["roundtrip"], inp["w"])
