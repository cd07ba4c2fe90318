"""The port's Adam and AdamW against the JAX package's, over 3 steps.

Both sides get the same numpy parameters and, at every step, the same
numpy gradients (set on ``p.grad``, then ``step()``). Parameters carry the
same names on both sides, so ``apply_decay_param_fun`` decides alike.
Tolerances: float32 parameters and moments agree to 1e-6 of the array's
largest magnitude (the update is the same float32 arithmetic, but XLA may
fuse beta1 * m + (1 - beta1) * g into one rounding where PyTorch rounds
twice; one ulp apart, and that ulp grows relative to an element where the
two terms cancel); bfloat16 values to one bf16 ulp (2^-7 relative), since
a float32 result that differs by one ulp may round to the neighbouring
bfloat16 value.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as pt
from paddle_tpu.framework.tensor import Parameter as JaxParameter
from paddle_tpu.framework.tensor import Tensor as JaxTensor

from paddle_tpu_torch.optimizer import Adam, AdamW

SHAPES = {"w0": (16, 8), "w1": (8,), "bias": (8,)}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _values(seed):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal(s).astype(np.float32)
            for n, s in SHAPES.items()}


def _grads(seed):
    g = _values(seed)
    # elements at and near 0 reach the update through eps
    g["w0"][0, :4] = [0.0, 1e-9, -1e-9, 3e-7]
    return g


def _make(dtype):
    """The same starting values on both sides, in buffers of their own: on
    the CPU, JAX may adopt a 64-byte aligned numpy array without a copy,
    and its step runs asynchronously, so a torch parameter sharing that
    array (torch.from_numpy) would be updated in place under JAX's
    still-pending first step, which then starts from torch's result."""
    vals = _values(0)
    jp = {n: JaxParameter(jnp.array(v, _JNP[dtype], copy=True), name=n)
          for n, v in vals.items()}
    tp = {}
    for n, v in vals.items():
        p = torch.nn.Parameter(torch.tensor(v, dtype=_TORCH[dtype]))
        p.param_name = n
        tp[n] = p
    return jp, tp


def _run(jopt, topt, jp, tp, dtype, steps=3, first=1):
    for i in range(first, first + steps):
        for n, g in _grads(i).items():
            jp[n].grad = JaxTensor(jnp.array(g, _JNP[dtype], copy=True))
            tp[n].grad = torch.tensor(g, dtype=_TORCH[dtype])
        jopt.step()
        topt.step()


def _close(a, b, dtype):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    if dtype == "bfloat16":
        np.testing.assert_allclose(a, b, rtol=2.0 ** -7, atol=1e-9)
    else:
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-6 * np.abs(b).max())


def _compare(jopt, topt, jp, tp, dtype, moment_dtype):
    for n in SHAPES:
        _close(tp[n].detach().float().numpy(),
               np.asarray(jp[n]._data.astype(jnp.float32)), dtype)
    jstate = jopt.state_dict()
    tstate = topt.state_dict()
    assert tstate["@step"] == jstate["@step"] == 3
    for key in (f"{n}__moment{i}" for n in SHAPES for i in (1, 2)):
        t = tstate[key]
        j = jstate[key]._data
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        _close(t.float().numpy(), np.asarray(j.astype(jnp.float32)),
               moment_dtype)


CASES = [
    # (optimizer, param dtype, moment_dtype, options)
    ("Adam", "float32", None, {}),
    ("Adam", "float32", None, {"weight_decay": 0.1}),
    ("AdamW", "float32", None, {}),
    ("AdamW", "float32", None, {"weight_decay": 0.1,
                                "apply_decay_param_fun":
                                    lambda n: n != "bias"}),
    ("AdamW", "float32", "bfloat16", {}),
    ("AdamW", "bfloat16", None, {}),
    ("AdamW", "bfloat16", "bfloat16", {"weight_decay": 0.1}),
    ("Adam", "bfloat16", None, {"beta1": 0.8, "epsilon": 1e-6}),
]


@pytest.mark.parametrize("name,dtype,moment_dtype,opts", CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}-{sorted(c[3])}"
                              for c in CASES])
def test_matches_jax_over_three_steps(name, dtype, moment_dtype, opts):
    jp, tp = _make(dtype)
    jcls = getattr(pt.optimizer, name)
    tcls = {"Adam": Adam, "AdamW": AdamW}[name]
    kw = dict(learning_rate=0.01, moment_dtype=moment_dtype, **opts)
    jopt = jcls(parameters=list(jp.values()), **kw)
    topt = tcls(parameters=list(tp.values()), **kw)
    _run(jopt, topt, jp, tp, dtype)
    m_dt = moment_dtype or "float32"
    _compare(jopt, topt, jp, tp, dtype, m_dt)


def test_a_group_with_its_own_lr():
    jp, tp = _make("float32")
    groups = lambda ps: [  # noqa: E731
        {"params": [ps["w0"]]},
        {"params": [ps["w1"], ps["bias"]], "learning_rate": 0.05}]
    jopt = pt.optimizer.AdamW(learning_rate=0.01, parameters=groups(jp))
    topt = AdamW(learning_rate=0.01, parameters=groups(tp))
    _run(jopt, topt, jp, tp, "float32")
    _compare(jopt, topt, jp, tp, "float32", "float32")
    # a group's own rate leaves the optimizer's base rate as it was
    assert topt.get_lr() == 0.01


def test_lr_ratio_and_set_lr():
    jp, tp = _make("float32")
    ratio = lambda p: 0.5 if p.shape[0] == 16 else 1.0  # noqa: E731
    jopt = pt.optimizer.AdamW(learning_rate=0.01, parameters=list(
        jp.values()), lr_ratio=ratio)
    topt = AdamW(learning_rate=0.01, parameters=list(tp.values()),
                 lr_ratio=ratio)
    jopt.set_lr(0.02)
    topt.set_lr(0.02)
    assert topt.get_lr() == jopt.get_lr() == 0.02
    _run(jopt, topt, jp, tp, "float32")
    _compare(jopt, topt, jp, tp, "float32", "float32")


def test_state_dict_round_trip():
    """Two steps, a fresh optimizer loaded from state_dict(), one more
    step: the same parameters as three steps straight through."""
    _, tp = _make("float32")
    opt = AdamW(learning_rate=0.01, parameters=list(tp.values()),
                moment_dtype="bfloat16")
    _, tp2 = _make("float32")
    opt2 = AdamW(learning_rate=0.01, parameters=list(tp2.values()),
                 moment_dtype="bfloat16")
    for i in (1, 2):
        for n, g in _grads(i).items():
            tp[n].grad = torch.from_numpy(g)
            tp2[n].grad = torch.from_numpy(g)
        opt.step()
        opt2.step()
    state = opt2.state_dict()
    assert state["@step"] == 2
    assert state["w0__moment1"].dtype == torch.bfloat16
    fresh = AdamW(learning_rate=0.01, parameters=list(tp2.values()),
                  moment_dtype="bfloat16")
    fresh.set_state_dict(state)
    for n, g in _grads(3).items():
        tp[n].grad = torch.from_numpy(g)
        tp2[n].grad = torch.from_numpy(g)
    opt.step()
    fresh.step()
    for n in SHAPES:
        assert torch.equal(tp[n], tp2[n])
    assert fresh.state_dict()["@step"] == 3


def test_clear_grad_and_bf16_grads_step_in_float32():
    _, tp = _make("bfloat16")
    opt = AdamW(learning_rate=0.01, parameters=list(tp.values()))
    for n, g in _grads(1).items():
        tp[n].grad = torch.from_numpy(g).bfloat16()
    opt.step()
    # bf16 params keep float32 moments unless moment_dtype says otherwise
    assert opt.state_dict()["w0__moment1"].dtype == torch.float32
    opt.clear_grad()
    assert all(p.grad is None for p in tp.values())
