"""The port's TrainStep against the JAX package's, on the CPU.

bench.py's CPU configuration (vocab 1024, hidden 128, FFN 256, 2 layers,
4 heads, float32, batch 2 x seq 128) with LlamaPretrainingCriterion and
AdamW at lr 1e-4. Both models start from the same weights (the JAX
model's, converted by params_from_jax) and take the same batch of ids and
labels; the JAX step differentiates its flash attention through the
Pallas backward in interpret mode, the port's through the plain version of
its backward kernel.

Tolerances, and why:
- the step-1 gradients are the tight check: each tensor agrees to 1e-5 of
  its largest element (float32 forward and backward, summed in different
  orders by the two frameworks);
- losses agree to 1e-5 relative;
- the first moment after step 1 is (1 - beta1) times the gradient the
  optimizer was handed, after accumulation: it holds every variant's
  division by accum_steps (or its absence), every microbatch and the
  master-gradient hand-off to the JAX step's. Float32: 1e-5 of each
  tensor's largest element, as the gradients;
- parameters after 3 steps: AdamW's first steps move each element by
  about lr times the sign of its gradient, so an element whose gradient
  is near 0 may take a different sign in the two runs and differ by up to
  2 lr per step. Every element is held to that bound, 2 lr x steps, and
  all but 0.1 % of them to 1e-6.

The bfloat16 variant (master_grad with accum_steps=2) rounds activations
and gradients to bfloat16 at points that differ between the frameworks,
so an element agrees to a few bfloat16 ulps (2^-8 relative) of its
tensor's largest, not better: the first moment is held to 2^-4 of each
tensor's largest element (a factor-2 error in the accumulation would be
0.5), the losses to 1e-3 relative (float32 means over 256 tokens of
bfloat16 logits), and each parameter to steps x (2 lr + one bfloat16 ulp
of its value), one rounding of the stored parameter per step on each side.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as pt
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import LlamaPretrainingCriterion as JaxCriterion

from paddle_tpu_torch import (AdamW, LlamaConfig, LlamaForCausalLM,
                              LlamaPretrainingCriterion, TrainStep)
from paddle_tpu_torch.convert import optimizer_state_from_jax, \
    params_from_jax
from torch_threads import one_thread  # noqa: F401  (autouse)

CPU_CFG = dict(vocab_size=1024, hidden_size=128, intermediate_size=256,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=4, max_position_embeddings=256,
               dtype="float32")
LR = 1e-4
GRAD_TOL = 1e-5
LOSS_RTOL = 1e-5
BF16_MOMENT_TOL = 2.0 ** -4
BF16_LOSS_RTOL = 1e-3


def _batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 1024, (2, 128)).astype(np.int64)
    labels = rng.integers(0, 1024, (2, 128)).astype(np.int64)
    return ids, labels


def _jax_side(seed, **cfg_kw):
    pt.seed(seed)
    cfg = JaxLlamaConfig(**{**CPU_CFG, **cfg_kw})
    model = JaxLlama(cfg)
    # float32 holds bfloat16 weights exactly; the port casts them back
    sd = {k: np.asarray(v.numpy(), dtype=np.float32)
          for k, v in model.state_dict().items()}
    return cfg, model, sd


def _jax_step(cfg, model, **kw):
    crit = JaxCriterion(cfg)
    opt = pt.optimizer.AdamW(learning_rate=LR,
                             parameters=model.parameters())
    return pt.jit.TrainStep(model, lambda lo, la: crit(lo, la), opt, **kw), \
        opt


def _port_side(sd, **cfg_kw):
    cfg = LlamaConfig(**{**CPU_CFG, **cfg_kw})
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(sd, cfg))
    return cfg, model


def _port_step(cfg, model, **kw):
    crit = LlamaPretrainingCriterion(cfg)
    opt = AdamW(learning_rate=LR, parameters=model.parameters())
    return TrainStep(model, lambda lo, la: crit(lo, la), opt, **kw), opt


def _jax_grads(cfg, model, ids, labels):
    """The gradients of the first step, from the JAX eager tape (the flash
    primitive's backward is the same _mha_bwd the fused step reaches)."""
    loss = JaxCriterion(cfg)(model(pt.to_tensor(ids)),
                             pt.to_tensor(labels))
    loss.backward()
    grads = {k: np.asarray(p.grad.numpy())
             for k, p in model.named_parameters()}
    for p in model.parameters():
        p.clear_grad()
    return grads


def _is_linear(name):
    return name.endswith("proj.weight") or name == "lm_head.weight"


def _port_params(model):
    return {k: (p.detach().float().numpy().T if _is_linear(k)
                else p.detach().float().numpy())
            for k, p in model.named_parameters()}


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def _assert_params_close(tparams, jmodel, steps, bf16=False):
    jparams = {k: np.asarray(p.numpy(), dtype=np.float32) for k, p in
               jmodel.named_parameters()}
    assert set(jparams) == set(tparams)
    if bf16:
        for k in jparams:
            ulp = _bf16_ulp(np.maximum(np.abs(tparams[k]),
                                       np.abs(jparams[k])))
            bound = steps * (2 * LR + ulp)
            assert np.all(np.abs(tparams[k] - jparams[k]) <= bound), k
        return
    diffs = np.concatenate([np.abs(tparams[k] - jparams[k]).ravel()
                            for k in jparams])
    assert diffs.max() <= 2 * LR * steps * (1 + 1e-3)
    assert np.mean(diffs > 1e-6) < 1e-3


def _assert_first_moments_close(tmodel, topt, jstep, tol):
    """Step 1's first moments, (1 - beta1) x the gradient each optimizer
    was handed, element by element within tol of each tensor's largest."""
    jm = {k.split("::")[0]: np.asarray(v, dtype=np.float32)
          for k, v in jstep._accums_to_named().items()
          if k.endswith("::moment1")}
    tstate = topt.state_dict()
    assert set(jm) == {k for k, _ in tmodel.named_parameters()}
    for name, ref in jm.items():
        m = tstate[f"{name}__moment1"].float().numpy()
        m = m.T if _is_linear(name) else m
        np.testing.assert_allclose(m, ref, rtol=0,
                                   atol=tol * np.abs(ref).max(),
                                   err_msg=name)


def _assert_grads_close(tmodel, jgrads):
    for k, p in tmodel.named_parameters():
        g = p.grad.numpy().T if _is_linear(k) else p.grad.numpy()
        ref = jgrads[k]
        np.testing.assert_allclose(g, ref, rtol=0,
                                   atol=GRAD_TOL * np.abs(ref).max(),
                                   err_msg=k)


VARIANTS = {      # (config fields, TrainStep options)
    "plain": ({}, {}),
    "accum2": ({}, {"accum_steps": 2}),
    "recompute": ({"recompute": True}, {}),
    "accum2_sum": ({}, {"accum_steps": 2, "accum_mean": False}),
    "bf16_master_grad": ({"dtype": "bfloat16"},
                         {"accum_steps": 2, "master_grad": True}),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_three_steps_match_jax(variant):
    cfg_kw, step_kw = VARIANTS[variant]
    bf16 = cfg_kw.get("dtype") == "bfloat16"
    ids, labels = _batch()
    jcfg, jmodel, sd = _jax_side(3, **cfg_kw)
    tcfg, tmodel = _port_side(sd, **cfg_kw)
    if variant == "plain":
        jgrads = _jax_grads(jcfg, jmodel, ids, labels)
    jstep, _ = _jax_step(jcfg, jmodel, **step_kw)
    tstep, topt = _port_step(tcfg, tmodel, **step_kw)
    tids, tlabels = torch.from_numpy(ids), torch.from_numpy(labels)
    for i in range(3):
        jloss = float(jstep((pt.to_tensor(ids),),
                            (pt.to_tensor(labels),)).numpy())
        tloss = tstep((tids,), (tlabels,))
        assert tloss.dtype == torch.float32 and tloss.dim() == 0
        np.testing.assert_allclose(tloss.item(), jloss,
                                   rtol=BF16_LOSS_RTOL if bf16 else LOSS_RTOL)
        if i == 0:
            _assert_first_moments_close(
                tmodel, topt, jstep, BF16_MOMENT_TOL if bf16 else GRAD_TOL)
            if variant == "plain":
                _assert_grads_close(tmodel, jgrads)
    assert topt.state_dict()["@step"] == 3
    if bf16:
        assert all(p.dtype == torch.bfloat16 for p in tmodel.parameters())
    _assert_params_close(_port_params(tmodel), jmodel, 3, bf16=bf16)


def test_continue_from_a_jax_run():
    """Two JAX steps, then the parameters and the optimizer state cross
    over (optimizer_state_from_jax transposes the Linear moments as
    params_from_jax transposes the weights), and one more step on each
    side must agree."""
    ids, labels = _batch()
    jcfg, jmodel, _ = _jax_side(4)
    jstep, jopt = _jax_step(jcfg, jmodel)
    for _ in range(2):
        jstep((pt.to_tensor(ids),), (pt.to_tensor(labels),))
    sd = {k: np.asarray(v.numpy()) for k, v in jmodel.state_dict().items()}
    accums = {k: np.asarray(v) for k, v in jstep._accums_to_named().items()}
    assert "llama.layers.0.self_attn.q_proj.weight::moment1" in accums
    tcfg, tmodel = _port_side(sd)
    tstep, topt = _port_step(tcfg, tmodel)
    state = optimizer_state_from_jax(accums, tcfg, jopt._step_count)
    assert state["@step"] == 2
    m = state["llama.layers.0.mlp.up_proj.weight__moment1"]
    assert tuple(m.shape) == (256, 128)          # torch's [out, in]
    topt.set_state_dict(state)
    jloss = float(jstep((pt.to_tensor(ids),),
                        (pt.to_tensor(labels),)).numpy())
    tloss = tstep((torch.from_numpy(ids),), (torch.from_numpy(labels),))
    np.testing.assert_allclose(tloss.item(), jloss, rtol=LOSS_RTOL)
    # the third step's update rests on the converted moments: had they
    # not been transposed the parameters would differ by about lr
    _assert_params_close(_port_params(tmodel), jmodel, 1)
    assert topt.state_dict()["@step"] == 3


def test_the_loss_falls_and_stays_on_the_device():
    ids, labels = _batch()
    _, _, sd = _jax_side(5)
    tcfg, tmodel = _port_side(sd)
    tstep, _ = _port_step(tcfg, tmodel)
    tstep.opt.set_lr(1e-2)
    losses = [tstep((torch.from_numpy(ids),), (torch.from_numpy(labels),))
              for _ in range(4)]
    assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu"
               for x in losses)
    assert losses[-1].item() < losses[0].item()


def test_master_grad_and_accum_sum_match_their_definitions():
    """accum_mean=False sums the microbatch gradients; master_grad sums
    them in float32 beside bfloat16 parameters."""
    ids, labels = _batch()
    _, _, sd = _jax_side(6)
    grads = {}
    for kw in ({"accum_steps": 2, "accum_mean": False},
               {"accum_steps": 2, "accum_mean": True}):
        tcfg, tmodel = _port_side(sd)
        tstep, _ = _port_step(tcfg, tmodel, **kw)
        tstep.opt.set_lr(0.0)
        tstep((torch.from_numpy(ids),), (torch.from_numpy(labels),))
        grads[kw["accum_mean"]] = {k: p.grad.clone() for k, p in
                                   tmodel.named_parameters()}
    for k in grads[True]:
        torch.testing.assert_close(grads[False][k], 2 * grads[True][k])
    tcfg, tmodel = _port_side(sd, dtype="bfloat16")
    tstep, topt = _port_step(tcfg, tmodel, accum_steps=2, master_grad=True)
    loss = tstep((torch.from_numpy(ids),), (torch.from_numpy(labels),))
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert all(p.dtype == torch.bfloat16 for p in tmodel.parameters())
    assert topt.state_dict()["@step"] == 1
