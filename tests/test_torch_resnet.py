"""The port's ResNet-18 against the JAX package's, on the CPU.

resnet18(num_classes=10), float32, batch 4 x 3 x 64 x 64 (so layer4's
batch norms reduce over 4 x 2 x 2 = 16 values, not 2), weights, images
and labels from numpy with a seed (tests/torch_resnet_cases.py, which
also says why each comparison's batch seed is the one it is). Checked:
the eval forward; two ``TrainStep`` steps under ``Momentum(0.1, 0.9)``
and ``CrossEntropyLoss`` against the JAX TrainStep (losses, parameters,
``_mean``/``_variance`` and the velocities); ``flops`` and ``summary``;
and the checks of ``resnet_params_from_jax``.
tests/test_torch_resnet_accum.py has ``accum_steps=2`` and a run carried
over from the JAX optimizer's state.

Tolerances, and why:
- eval logits: 1e-5 of the largest (float32 convolutions summed in
  another order by XLA and by torch's CPU kernels; measured 7.2e-7);
- two steps: losses 1e-5 of the largest loss, every parameter, buffer
  and velocity 1e-4 of its array's largest magnitude (the same rounding,
  carried through two updates at lr 0.1; measured 1.2e-5).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt

import paddle_tpu_torch as ptt
from paddle_tpu_torch.convert import resnet_params_from_jax
from torch_resnet_cases import (assert_steps_match, batch, close,
                                port_state, resnet18_pair, resnet18_state,
                                train_pair)

LOGIT_TOL = 1e-5
LOSS_TOL = 1e-5
STATE_TOL = 1e-4


@pytest.fixture(scope="module")
def state():
    return resnet18_state(seed=0)


def test_eval_forward_matches_jax(state):
    x, _ = batch(4)
    jm, tm = resnet18_pair(state)
    jm.eval()
    tm.eval()
    ref = jm(pt.to_tensor(x)).numpy()
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (4, 10)
    close(got, ref, LOGIT_TOL)


def test_two_momentum_steps_match_jax(state):
    x, y = batch(4, seed=0)
    jm, jstep, tm, topt, jl, tl = train_pair(state, x, y, 2)
    assert tl[1] < tl[0]
    assert_steps_match(jm, jstep, tm, topt, jl, tl, LOSS_TOL, STATE_TOL)
    # the batch norms' running statistics moved in each step's forward
    moved = port_state(tm)["layer4.1.bn2._variance"]
    assert not np.allclose(moved, state["layer4.1.bn2._variance"])


def test_flops_match_jax(state):
    jm, tm = resnet18_pair(state)
    tm.train()
    assert ptt.flops(tm, [1, 3, 64, 64]) == \
        pt.flops(jm, [1, 3, 64, 64]) == 297115648
    assert tm.training            # flops ran in eval and restored the mode


def test_summary_counts_match_jax(state, capsys):
    jm, tm = resnet18_pair(state)
    ref = pt.summary(jm, (1, 3, 64, 64))
    got = ptt.summary(tm, (1, 3, 64, 64))
    assert got == ref == {"total_params": 11181642,
                          "trainable_params": 11181642}
    assert "layer4.1.bn2 (BatchNorm2D)" in capsys.readouterr().out


def test_conversion_checks_names_and_shapes(state):
    tm = ptt.vision.models.resnet18(num_classes=10, device="cpu")
    bad = dict(state)
    bad["fc.weight"] = bad["fc.weight"].T         # already torch's layout
    with pytest.raises(ValueError, match="fc.weight"):
        resnet_params_from_jax(bad, tm)
    short = {k: v for k, v in state.items()
             if k != "layer1.0.bn1._variance"}
    with pytest.raises(ValueError, match="missing"):
        resnet_params_from_jax(short, tm)
    extra = dict(state, **{"layer9.weight": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="layer9"):
        resnet_params_from_jax(extra, tm)
