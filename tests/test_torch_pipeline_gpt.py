"""GPT with ``pipeline_parallel=True`` in the port against the JAX
package's plain GPT, on the CPU.

The JAX side: GPT of 4 layers (vocab 128, hidden 64, 4 heads, dropout 0,
XLA's attention), trained 5 AdamW steps by its TrainStep on a batch of 4
x 32 with a few -100 labels. The port's side: a world of 2 ranks (pp 2,
gloo, spawned by tests/torch_dist_cases.py), each holding its stage of
the JAX weights (convert.pp_params_from_jax) under fleet.init and trained
through TrainStep, at virtual_pp_degree 1 (2 microbatches) and 2 (4
microbatches, one layer a chunk), and at pp 1 x dp 2 with two chunks
(each dp rank runs the whole batch; the gradients are averaged). The head is tied: wte lives on both
stages, and the summed gradient must keep the two copies equal bit for
bit. Tolerance: the reference's pipeline-parity tolerance (rtol 2e-4,
atol 2e-5).
"""
import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.models.gpt import GPTConfig as JaxConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT

import torch_dist_cases as cases

STEPS, LR = 5, 1e-3
VOCAB, B, S = 128, 4, 32
RTOL, ATOL = 2e-4, 2e-5
CFG = dict(vocab_size=VOCAB, hidden_size=64, num_hidden_layers=4,
           num_attention_heads=4, max_position_embeddings=64, dropout=0.0,
           use_flash_attention=False)


def _spec(sd, ids, labels, pp=2, **cfg):
    return {"family": "gpt", "pp": pp, "sd": sd, "ids": ids,
            "labels": labels, "cfg": dict(CFG, **cfg)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rng = np.random.default_rng(4)
    ids = rng.integers(0, VOCAB, (B, S))
    labels = rng.integers(0, VOCAB, (B, S))
    labels[1, ::3] = -100
    pt.seed(21)
    model = JaxGPT(JaxConfig(**CFG))
    sd = {k: np.asarray(v.numpy(), np.float32)
          for k, v in model.state_dict().items()}
    payload = {"lr": LR, "steps": STEPS, "train": {
        "vpp1": _spec(sd, ids, labels, pp_microbatches=2),
        "vpp2": _spec(sd, ids, labels, pp_microbatches=4,
                      virtual_pp_degree=2),
        # pp 1 x dp 2: one stage holds both chunks and passes between
        # them locally; TrainStep syncs the gradients over dp
        "pp1_dp2_vpp2": _spec(sd, ids, labels, pp=1, pp_microbatches=2,
                              virtual_pp_degree=2)},
        "layouts": {"vpp2": _spec(sd, ids, labels, virtual_pp_degree=2)},
        "runner": {"ws": rng.standard_normal((4, 8, 8)).astype(np.float32),
                   "x": rng.standard_normal((2, 2, 8)).astype(np.float32)},
        "errors": {"dropout": _spec(sd, ids, labels, dropout=0.1)}}
    handle = cases.start_world(2, "pipeline", payload,
                               tmp_path_factory.mktemp("pipeline_gpt"))
    opt = pt.optimizer.AdamW(learning_rate=LR, parameters=model.parameters())
    step = pt.jit.TrainStep(model, lambda lg, lb: model.loss(lg, lb), opt)
    losses = [float(step((pt.to_tensor(ids, dtype="int64"),),
                         (pt.to_tensor(labels, dtype="int64"),)))
              for _ in range(STEPS)]
    return {"losses": losses, "sd": sd}, cases.finish_world(handle)


@pytest.mark.parametrize("name", ["vpp1", "vpp2", "pp1_dp2_vpp2"])
def test_losses_match_jax(run, name):
    ref, world = run
    got = [r[name]["losses"] for r in world]
    assert got[0] == got[1]
    np.testing.assert_allclose(got[0], ref["losses"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["vpp1", "vpp2"])
def test_tied_embedding_stays_equal_on_both_stages(run, name):
    _, world = run
    np.testing.assert_array_equal(world[0][name]["tied"],
                                  world[1][name]["tied"])


def test_state_dict_round_trip_in_natural_order(run):
    """The plain JAX state dict -> each rank's vpp 2 stage -> gathered on
    stage 0 in the JAX pipelined layout: the stacked per-layer arrays and
    the other entries, exactly."""
    from paddle_tpu_torch.models.gpt_pipe import GPTStackedDecoder
    ref, world = run
    got = world[0]["layout:vpp2"]["to_jax"]
    assert world[1]["layout:vpp2"]["to_jax"] is None
    want = {k: v for k, v in ref["sd"].items() if ".h." not in k}
    for key, attrs in GPTStackedDecoder._LAYER_ATTRS.items():
        path = ".".join(attrs)
        want["gpt.decoder_stack." + key] = np.stack(
            [ref["sd"][f"gpt.h.{l}.{path}"] for l in range(4)])
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert world[0]["layout:vpp2"]["chunks"] == [[0], [2]]
    assert world[1]["layout:vpp2"]["chunks"] == [[1], [3]]


def test_stages_hold_their_ends(run):
    """wte on both stages, wpe on the first, ln_f on the last."""
    _, world = run
    first, last = (set(r["layout:vpp2"]["names"]) for r in world)
    assert {"gpt.wte.weight", "gpt.wpe.weight"} <= first
    assert "gpt.ln_f.weight" not in first
    assert {"gpt.wte.weight", "gpt.ln_f.weight", "gpt.ln_f.bias"} <= last
    assert "gpt.wpe.weight" not in last


def test_dropout_is_refused_under_the_pipeline(run):
    _, world = run
    for r in world:
        kind, msg = r["errors"]["dropout"]
        assert kind == "ValueError" and "dropout" in msg
