"""Learning-rate schedulers and gradient clipping against the JAX
package's, on the CPU, and both inside TrainStep.

The schedulers are pure Python in both packages, with the same formulas:
each one's learning rates over 30 steps must be equal, float for float,
and so must its state dict. The clip classes and functions take the same
numpy gradients on both sides (float32, and one bf16 gradient, which both
scale in float32 and round back): float32 results to 1e-6 relative (the
norms sum in different orders), bf16 ones to one bf16 ulp (2^-8
relative). The TrainStep check runs gpt_tiny 3 AdamW steps on both sides
with ClipGradByGlobalNorm(0.5) (the gradients' global norm is about 4,
so every step clips) and LinearWarmup over CosineAnnealingDecay, stepped
after each train step: step 1's first moments, (1 - beta1) x the clipped
gradient, to 1e-5 of each tensor's largest element (as the unclipped
parity), and the parameters after 3 steps to 2 x the sum of the 3
learning rates (AdamW moves an element by about lr a step whatever its
gradient's size, so a near-0 gradient may take another sign on one
side), all but 0.1 % of them to 1e-2 of that sum (rates up to 1e-3 move
such elements further than the 1e-4 of the unclipped parity, whose 1e-6
this scales: 0.060 % of the elements lie beyond 1e-5 here).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.nn import clip as jclip
from paddle_tpu.optimizer import lr as jlr

from paddle_tpu_torch import AdamW, TrainStep
from paddle_tpu_torch.convert import gpt_params_from_jax
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.optimizer import lr as tlr

STEPS = 30
CLIP_RTOL = 1e-6
BF16_RTOL = 2.0 ** -8
MOMENT_TOL = 1e-5

SCHEDULERS = {
    "NoamDecay": lambda m: m.NoamDecay(64, 10, learning_rate=1.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([5, 12, 20],
                                                 [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, gamma=0.1),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, gamma=0.2),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.5, 12, end_lr=0.01,
                                                   power=2.0, cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.1, T_max=20), 5, 0.0, 0.1),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.5, gamma=0.9),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.5, [5, 10, 20],
                                                 gamma=0.5),
    "StepDecay": lambda m: m.StepDecay(0.5, 7, gamma=0.5),
    "LambdaDecay": lambda m: m.LambdaDecay(0.5, lambda e: 0.95 ** e),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(0.5, factor=0.5,
                                                   patience=2, cooldown=1),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
        0.5, T_max=10, eta_min=0.01),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(
        0.5, lambda e: 0.9),
    "OneCycleLR": lambda m: m.OneCycleLR(0.5, 30),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, 4, mode="triangular2"),
    "LinearLR": lambda m: m.LinearLR(0.5, 20),
    "CosineAnnealingWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.5, T_0=5, T_mult=2, eta_min=0.01),
}
# ReduceOnPlateau's metric: falls, stalls, falls again, stalls
PLATEAU = [1.0, 0.9, 0.8] + [0.8] * 6 + [0.5] + [0.5] * 20


def _advance(sched, i):
    if isinstance(sched, (jlr.ReduceOnPlateau, tlr.ReduceOnPlateau)):
        sched.step(PLATEAU[i])
    else:
        sched.step()


def test_every_scheduler_is_ported():
    ported = {n for n in tlr.__all__ if n != "LRScheduler"}
    assert ported == set(SCHEDULERS) == {
        n for n in jlr.__all__ if n != "LRScheduler"}


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_scheduler_matches_jax(name):
    j, t = SCHEDULERS[name](jlr), SCHEDULERS[name](tlr)
    assert isinstance(t, tlr.LRScheduler)
    jr, tr = [j()], [t()]
    for i in range(STEPS):
        _advance(j, i)
        _advance(t, i)
        jr.append(j())
        tr.append(t())
    assert tr == jr
    assert len(set(tr)) > 1                     # the rate did move
    assert t.state_dict() == j.state_dict()
    # the state dict round trip: a fresh scheduler given it goes on alike
    fresh = SCHEDULERS[name](tlr)
    fresh.set_state_dict(t.state_dict())
    for i in range(5):
        _advance(fresh, STEPS + i - 5)
        _advance(t, STEPS + i - 5)
        assert fresh() == t()


def test_optimizer_reads_its_scheduler():
    model = torch.nn.Linear(4, 3)
    sched = tlr.StepDecay(0.1, 2, gamma=0.5)
    opt = AdamW(learning_rate=sched, parameters=model.parameters())
    seen = []
    for _ in range(5):
        seen.append(opt.get_lr())
        sched.step()
    assert seen == [0.1, 0.1, 0.05, 0.05, 0.025]
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.3)
    state = opt.state_dict()
    assert state["LR_Scheduler"] == sched.state_dict()
    other = tlr.StepDecay(0.1, 2, gamma=0.5)
    opt2 = AdamW(learning_rate=other, parameters=model.parameters())
    opt2.set_state_dict(state)
    assert other.last_epoch == 5 and opt2.get_lr() == opt.get_lr()
    with pytest.raises(NotImplementedError):
        AdamW(learning_rate="0.1", parameters=model.parameters())


class _P:
    """A parameter stand-in: the clip classes read only need_clip."""

    def __init__(self, need_clip=True):
        self.need_clip = need_clip


def _grads():
    rng = np.random.default_rng(3)
    shapes = [(16, 8), (8,), (4, 4, 3), (32,)]
    gs = [rng.standard_normal(s).astype(np.float32) * 2 for s in shapes]
    return gs, [_P(), _P(), _P(False), _P()]


def _check(tg, jg):
    if tg is None:
        assert jg is None
        return
    ref = np.asarray(jg._data.astype("float32") if tg.dtype ==
                     torch.bfloat16 else jg._data, np.float32)
    rtol = BF16_RTOL if tg.dtype == torch.bfloat16 else CLIP_RTOL
    np.testing.assert_allclose(tg.float().numpy(), ref, rtol=rtol, atol=0)


CLIPS = {"value": lambda m: m.ClipGradByValue(0.5, min=-0.3),
         "norm": lambda m: m.ClipGradByNorm(1.0),
         "global_norm": lambda m: m.ClipGradByGlobalNorm(1.0)}


@pytest.mark.parametrize("kind", list(CLIPS))
def test_clip_classes_match_jax(kind):
    gs, ps = _grads()
    jpg = [(p, pt.to_tensor(g)) for p, g in zip(ps, gs)]
    tpg = [(p, torch.from_numpy(g)) for p, g in zip(ps, gs)]
    # a bf16 gradient and a missing one pass through the same way
    bf = np.random.default_rng(4).standard_normal((6, 5)).astype(np.float32)
    jpg += [(_P(), pt.to_tensor(bf).astype("bfloat16")), (_P(), None)]
    tpg += [(jpg[-2][0], torch.from_numpy(bf).to(torch.bfloat16)),
            (jpg[-1][0], None)]
    jout = CLIPS[kind](jclip)(jpg)
    tout = CLIPS[kind](tclip)(tpg)
    assert [p for p, _ in tout] == [p for p, _ in tpg]
    for (_, tg), (_, jg) in zip(tout, jout):
        _check(tg, jg)
    # need_clip=False passes through unchanged
    assert tout[2][1] is tpg[2][1]
    if kind != "value":
        assert not torch.equal(tout[0][1], tpg[0][1])   # it did clip


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_matches_jax(norm_type):
    gs, _ = _grads()
    jparams = [pt.nn.Linear(1, 1).weight for _ in gs]
    for p, g in zip(jparams, gs):
        p.grad = pt.to_tensor(g)
    tparams = [torch.nn.Parameter(torch.zeros(g.shape)) for g in gs]
    for p, g in zip(tparams, gs):
        p.grad = torch.from_numpy(g.copy())
    jtotal = jclip.clip_grad_norm_(jparams, 1.5, norm_type=norm_type)
    ttotal = tclip.clip_grad_norm_(tparams, 1.5, norm_type=norm_type)
    assert ttotal.dtype == torch.float32
    np.testing.assert_allclose(ttotal.item(), float(jtotal.numpy()),
                               rtol=CLIP_RTOL)
    for tp, jp in zip(tparams, jparams):
        _check(tp.grad, jp.grad)


def test_clip_grad_value_matches_jax():
    gs, _ = _grads()
    jparams = [pt.nn.Linear(1, 1).weight for _ in gs]
    for p, g in zip(jparams, gs):
        p.grad = pt.to_tensor(g)
    tparams = [torch.nn.Parameter(torch.zeros(g.shape)) for g in gs]
    for p, g in zip(tparams, gs):
        p.grad = torch.from_numpy(g.copy())
    jclip.clip_grad_value_(jparams, 0.7)
    tclip.clip_grad_value_(tparams, 0.7)
    for tp, jp in zip(tparams, jparams):
        _check(tp.grad, jp.grad)


def _warmup_cosine(m):
    return m.LinearWarmup(m.CosineAnnealingDecay(1e-3, T_max=10), 2, 1e-4,
                          1e-3)


def _jax_loss(logits, labels):
    v = logits.shape[-1]
    return pt.nn.CrossEntropyLoss()(logits.reshape([-1, v]).astype(
        "float32"), labels.reshape([-1]))


def _port_loss(logits, labels):
    v = logits.shape[-1]
    return torch.nn.functional.cross_entropy(logits.reshape(-1, v).float(),
                                             labels.reshape(-1))


def _is_linear(name):
    return name.endswith(("qkv_proj.weight", "out_proj.weight",
                          "fc_in.weight", "fc_out.weight"))


def test_train_step_with_clip_and_scheduler_matches_jax():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 256, (2, 64)).astype(np.int64)
    labels = rng.integers(0, 256, (2, 64)).astype(np.int64)
    pt.seed(11)
    jmodel = JaxGPT(jax_gpt_tiny())
    sd = {k: np.asarray(v.numpy(), np.float32)
          for k, v in jmodel.state_dict().items()}
    cfg = gpt_tiny()
    tmodel = GPTForCausalLM(cfg, device="cpu")
    tmodel.load_state_dict(gpt_params_from_jax(sd, cfg))

    jsched, tsched = _warmup_cosine(jlr), _warmup_cosine(tlr)
    jopt = pt.optimizer.AdamW(learning_rate=jsched,
                              parameters=jmodel.parameters(),
                              grad_clip=jclip.ClipGradByGlobalNorm(0.5))
    topt = AdamW(learning_rate=tsched, parameters=tmodel.parameters(),
                 grad_clip=tclip.ClipGradByGlobalNorm(0.5))
    jstep = pt.jit.TrainStep(jmodel, _jax_loss, jopt)
    tstep = TrainStep(tmodel, _port_loss, topt)
    tids, tlabels = torch.from_numpy(ids), torch.from_numpy(labels)
    lrs = []
    for i in range(3):
        lrs.append(topt.get_lr())
        assert lrs[-1] == jopt.get_lr()
        jl = float(jstep((pt.to_tensor(ids),),
                         (pt.to_tensor(labels),)).numpy())
        tl = tstep((tids,), (tlabels,))
        np.testing.assert_allclose(tl.item(), jl, rtol=1e-5)
        if i == 0:
            norm = torch.stack([p.grad.square().sum() for p in
                                tmodel.parameters()]).sum().sqrt().item()
            assert norm > 1.0                   # the clip took effect
            jm = {k.split("::")[0]: np.asarray(v, np.float32)
                  for k, v in jstep._accums_to_named().items()
                  if k.endswith("::moment1")}
            tstate = topt.state_dict()
            for name, ref in jm.items():
                m = tstate[f"{name}__moment1"].numpy()
                m = m.T if _is_linear(name) else m
                np.testing.assert_allclose(
                    m, ref, rtol=0, atol=MOMENT_TOL * np.abs(ref).max(),
                    err_msg=name)
            # (1 - beta1) x the clipped gradient: its global norm is 0.5
            total = np.sqrt(sum(np.square(v / 0.1).sum()
                                for v in jm.values()))
            np.testing.assert_allclose(total, 0.5, rtol=1e-5)
        jsched.step()
        tsched.step()
    assert lrs == [1e-4, 5.5e-4, 1e-3]
    jparams = {k: np.asarray(p.numpy(), np.float32)
               for k, p in jmodel.named_parameters()}
    diffs = np.concatenate([
        np.abs((p.detach().numpy().T if _is_linear(k) else
                p.detach().numpy()) - jparams[k]).ravel()
        for k, p in tmodel.named_parameters()])
    assert diffs.max() <= 2 * sum(lrs) * (1 + 1e-3)
    assert np.mean(diffs > 1e-2 * sum(lrs)) < 1e-3
