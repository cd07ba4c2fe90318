"""The port's GPT-2 against the JAX package's, on the CPU.

``gpt_tiny`` (vocab 256, hidden 64, 2 layers, 4 heads of dim 16, dropout
0), batch 2 x 64, float32: the JAX model's weights cross over through
convert.gpt_params_from_jax, and both sides take the same ids and labels
(numpy, seeded). Head dim 16 takes the port's plain attention route (and
the JAX package's XLA attention on its CPU); a second width, 2 heads of
dim 64, takes the port's kernel route, whose plain versions run here under
the flash autograd Function.

Tolerances, and why:
- logits and loss: 1e-5 of the largest logit, 1e-5 relative (float32 on
  both sides, summed in different orders);
- every gradient, the tied wte's sum of the embedding's and the head's
  included: 1e-5 of each tensor's largest element, as the Llama parity;
- parameters after 3 AdamW TrainStep steps: AdamW moves an element by
  about lr a step whatever its gradient's size, so an element whose
  gradient is near 0 may take another sign on one side; every element is
  held to 2 lr x steps and all but 0.1 % to 1e-6;
- the bf16 forward (use_flash_attention=False on both sides): the two
  packages round the activations to bf16 at different points (torch's
  LayerNorm and attention keep float32 inside, the JAX ones compute in
  bf16), so the logits agree to a few bf16 ulps of the largest logit:
  the gap measured 1.1e-2 of the largest, held to 2^-5 (a dropped block
  or a wrong scale moves them by far more), and the loss to 1e-2
  relative;
- generate: greedy tokens equal, token for token;
- recompute at dropout 0.1: loss and gradients bitwise equal to the same
  model without recompute, from one seed (the recomputation replays the
  forward's masks).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny

from paddle_tpu_torch import AdamW, TrainStep
from paddle_tpu_torch.convert import gpt_params_from_jax, \
    optimizer_state_from_jax
from paddle_tpu_torch.models.gpt import (GPTForCausalLM, gpt2_124m,
                                         gpt_tiny)
from paddle_tpu_torch.nn import CrossEntropyLoss
from paddle_tpu_torch.nn.functional.flash_attention import flash_attention
from paddle_tpu_torch.observability import model_flops_per_token

BATCH, SEQ = 2, 64
LR = 1e-4
TOL = 1e-5
BF16_LOGIT_TOL = 2.0 ** -5
BF16_LOSS_RTOL = 1e-2
WIDTHS = {"d16": {}, "d64": {"hidden_size": 128, "num_attention_heads": 2}}


def _batch(vocab=256):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int64)
    labels = rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int64)
    return ids, labels


def _jax_side(seed, **kw):
    pt.seed(seed)
    model = JaxGPT(jax_gpt_tiny(**kw))
    sd = {k: np.asarray(v.numpy(), np.float32)
          for k, v in model.state_dict().items()}
    return model, sd


def _port_side(sd, **kw):
    cfg = gpt_tiny(**kw)
    model = GPTForCausalLM(cfg, device="cpu")
    model.load_state_dict(gpt_params_from_jax(sd, cfg))
    return cfg, model


def _is_linear(name):
    return name.endswith(("qkv_proj.weight", "out_proj.weight",
                          "fc_in.weight", "fc_out.weight"))


def _port_params(model):
    return {k: (p.detach().float().numpy().T if _is_linear(k)
                else p.detach().float().numpy())
            for k, p in model.named_parameters()}


def _jax_loss(logits, labels):
    v = logits.shape[-1]
    return pt.nn.CrossEntropyLoss()(logits.reshape([-1, v]).astype(
        "float32"), labels.reshape([-1]))


def _port_loss(logits, labels):
    """benchmarks/gpt2_dp.py's loss_fn: CrossEntropyLoss on the flattened
    float32 logits."""
    v = logits.shape[-1]
    return CrossEntropyLoss()(logits.reshape(-1, v).float(),
                              labels.reshape(-1))


@pytest.mark.parametrize("width", list(WIDTHS))
def test_forward_gradients_and_three_steps_match_jax(width):
    kw = WIDTHS[width]
    ids, labels = _batch()
    jmodel, sd = _jax_side(7, **kw)
    cfg, tmodel = _port_side(sd, **kw)
    assert {k for k, _ in tmodel.named_parameters()} == set(sd)
    assert all(p.param_name == k for k, p in tmodel.named_parameters())

    jlogits = jmodel(pt.to_tensor(ids))
    jloss = jmodel.loss(jlogits, pt.to_tensor(labels))
    jloss.backward()
    jgrads = {k: np.asarray(p.grad.numpy())
              for k, p in jmodel.named_parameters()}
    for p in jmodel.parameters():
        p.clear_grad()

    route = flash_attention.route_launches["kernel"]
    tids, tlabels = torch.from_numpy(ids), torch.from_numpy(labels)
    tlogits = tmodel(tids)
    # head dim 64 takes the kernel route (here the kernels' plain versions)
    assert (flash_attention.route_launches["kernel"] - route
            == (cfg.num_hidden_layers if width == "d64" else 0))
    ref = np.asarray(jlogits.numpy())
    np.testing.assert_allclose(tlogits.detach().numpy(), ref, rtol=0,
                               atol=TOL * np.abs(ref).max())
    tloss = tmodel.loss(tlogits, tlabels)
    np.testing.assert_allclose(tloss.item(), float(jloss.numpy()),
                               rtol=TOL)
    tloss.backward()
    for k, p in tmodel.named_parameters():
        g = p.grad.numpy().T if _is_linear(k) else p.grad.numpy()
        np.testing.assert_allclose(g, jgrads[k], rtol=0,
                                   atol=TOL * np.abs(jgrads[k]).max(),
                                   err_msg=k)
    tmodel.zero_grad()

    jopt = pt.optimizer.AdamW(learning_rate=LR,
                              parameters=jmodel.parameters())
    jstep = pt.jit.TrainStep(jmodel, _jax_loss, jopt)
    topt = AdamW(learning_rate=LR, parameters=tmodel.parameters())
    tstep = TrainStep(tmodel, _port_loss, topt)
    for _ in range(3):
        jl = float(jstep((pt.to_tensor(ids),),
                         (pt.to_tensor(labels),)).numpy())
        tl = tstep((tids,), (tlabels,))
        assert tl.dtype == torch.float32 and tl.dim() == 0
        np.testing.assert_allclose(tl.item(), jl, rtol=TOL)
    tparams = _port_params(tmodel)
    jparams = {k: np.asarray(p.numpy(), np.float32)
               for k, p in jmodel.named_parameters()}
    diffs = np.concatenate([np.abs(tparams[k] - jparams[k]).ravel()
                            for k in jparams])
    assert diffs.max() <= 2 * LR * 3 * (1 + 1e-3)
    assert np.mean(diffs > 1e-6) < 1e-3

    # the JAX run's optimizer state crosses over: wte's moments as they
    # are, the Linear moments transposed, and no head entry
    accums = {k: np.asarray(v) for k, v in jstep._accums_to_named().items()}
    state = optimizer_state_from_jax(accums, cfg, jopt._step_count)
    assert state["@step"] == 3 and not any("lm_head" in k for k in state)
    np.testing.assert_array_equal(
        state["gpt.wte.weight__moment1"].numpy(),
        accums["gpt.wte.weight::moment1"])
    np.testing.assert_array_equal(
        state["gpt.h.0.attn.qkv_proj.weight__moment2"].numpy(),
        accums["gpt.h.0.attn.qkv_proj.weight::moment2"].T)


def test_bf16_forward_without_flash_matches_jax():
    ids, labels = _batch()
    kw = dict(dtype="bfloat16", use_flash_attention=False)
    jmodel, sd = _jax_side(8, **kw)
    cfg, tmodel = _port_side(sd, **kw)
    assert all(p.dtype == torch.bfloat16 for p in tmodel.parameters())
    jlogits = jmodel(pt.to_tensor(ids))
    jloss = float(jmodel.loss(jlogits, pt.to_tensor(labels)).numpy())
    tlogits = tmodel(torch.from_numpy(ids))
    assert tlogits.dtype == torch.bfloat16
    ref = np.asarray(jlogits.numpy(), np.float32)
    np.testing.assert_allclose(tlogits.float().detach().numpy(), ref, rtol=0,
                               atol=BF16_LOGIT_TOL * np.abs(ref).max())
    tloss = tmodel.loss(tlogits, torch.from_numpy(labels)).item()
    np.testing.assert_allclose(tloss, jloss, rtol=BF16_LOSS_RTOL)


def test_generate_matches_jax_token_for_token():
    jmodel, sd = _jax_side(9)
    _, tmodel = _port_side(sd)
    prompt = np.random.default_rng(1).integers(0, 256, (2, 5))
    jout = np.asarray(jmodel.generate(pt.to_tensor(prompt),
                                      max_new_tokens=8).numpy())
    tout = tmodel.generate(torch.from_numpy(prompt), max_new_tokens=8)
    np.testing.assert_array_equal(tout.numpy(), jout)


def test_recompute_replays_the_dropout_masks():
    """Dropout 0.1 with recompute equals dropout 0.1 without it, from one
    seed: loss and every gradient bitwise, over two steps (the second
    shows that the generator went on from where the forward left it, not
    from a recomputation's end)."""
    ids = torch.from_numpy(_batch()[0])
    runs = []
    for recompute in (False, True):
        model = GPTForCausalLM(gpt_tiny(dropout=0.1, recompute=recompute),
                               device="cpu",
                               generator=torch.Generator().manual_seed(3))
        steps = []
        for _ in range(2):
            model.zero_grad()
            loss = model.loss(model(ids), ids)
            loss.backward()
            steps.append((loss.detach(), {k: p.grad.clone() for k, p in
                                          model.named_parameters()}))
        runs.append(steps)
    (a0, a1), (b0, b1) = runs
    for a, b in ((a0, b0), (a1, b1)):
        assert torch.equal(a[0], b[0])
        for k in a[1]:
            assert torch.equal(a[1][k], b[1][k]), k
    assert not torch.equal(a0[0], a1[0])      # each step drew new masks


def test_dropout_draws_from_the_model_generator_only():
    """Training draws masks (two forwards differ), eval draws none, and
    torch's global RNG is left alone."""
    ids = torch.from_numpy(_batch()[0])
    model = GPTForCausalLM(gpt_tiny(dropout=0.1), device="cpu")
    before = torch.get_rng_state()
    with torch.no_grad():
        a, b = model(ids), model(ids)
        assert not torch.equal(a, b)
        model.eval()
        state = model.gpt.generator.get_state()
        c, d = model(ids), model(ids)
    assert torch.equal(c, d)
    assert torch.equal(state, model.gpt.generator.get_state())
    assert torch.equal(before, torch.get_rng_state())


def test_converter_keeps_wte_and_refuses_a_head():
    _, sd = _jax_side(10)
    cfg = gpt_tiny()
    out = gpt_params_from_jax(sd, cfg)
    np.testing.assert_array_equal(out["gpt.wte.weight"].numpy(),
                                  sd["gpt.wte.weight"])
    assert tuple(out["gpt.h.0.mlp.fc_in.weight"].shape) == (256, 64)
    with pytest.raises(ValueError, match="tied"):
        gpt_params_from_jax({**sd, "lm_head.weight": np.zeros((64, 256))},
                            cfg)
    with pytest.raises(ValueError, match="config expects"):
        gpt_params_from_jax(sd, gpt_tiny(hidden_size=32))


def test_full_width_counts():
    """benchmarks/gpt2_dp.py's configuration (vocab 50257) on the meta
    device: 124,439,808 parameters, the head counted once (tied), and
    the MFU formula's flops per token at S 1024."""
    cfg = gpt2_124m(vocab_size=50257, dtype="bfloat16")
    model = GPTForCausalLM(cfg, device="meta", generator=torch.Generator())
    n = sum(p.numel() for p in model.parameters())
    assert n == 124439808
    assert model_flops_per_token(cfg, 1024, n) == 6.0 * n + 12 * 12 * 768 \
        * 1024


def test_entry_point_needs_a_card_and_unported_options_raise():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPTForCausalLM(gpt_tiny())
    GPTForCausalLM(gpt_tiny(), device="cpu")
    for kw in ({"tensor_parallel": True}, {"pipeline_parallel": True}):
        with pytest.raises(NotImplementedError):
            GPTForCausalLM(gpt_tiny(**kw), device="cpu")
