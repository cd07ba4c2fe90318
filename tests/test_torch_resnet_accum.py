"""The port's ResNet-18 training step against the JAX package's with
``accum_steps=2``, and a run carried over from the JAX optimizer's state,
on the CPU (set-up and seeds: tests/torch_resnet_cases.py).

``accum_steps=2`` takes batch 8, so that each microbatch of 4 keeps
layer4's 16 values a channel: each microbatch's forward updates the batch
norms' buffers in order (eagerly in the port, in the JAX step's scan),
the gradients are averaged and the optimizer steps once.

Tolerances as tests/test_torch_resnet.py's two steps: losses 1e-5 of
the largest loss, parameters, buffers and velocities 1e-4 of each array's
largest magnitude (float32 convolutions summed in another order, through
updates at lr 0.1; measured 1.6e-5 with accumulation, 2.0e-6 continued from the JAX
state).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt

import paddle_tpu_torch as ptt
from paddle_tpu_torch.convert import (optimizer_state_from_jax,
                                      resnet_params_from_jax)
from torch_resnet_cases import (assert_steps_match, batch, resnet18_pair,
                                resnet18_state, train_pair)

LOSS_TOL = 1e-5
STATE_TOL = 1e-4


@pytest.fixture(scope="module")
def state():
    return resnet18_state(seed=0)


def test_accum_steps_match_jax(state):
    x, y = batch(8, seed=4)
    jm, jstep, tm, topt, jl, tl = train_pair(state, x, y, 2, accum_steps=2)
    assert_steps_match(jm, jstep, tm, topt, jl, tl, LOSS_TOL, STATE_TOL)


def test_continue_from_jax_optimizer_state(state):
    """One JAX step; its parameters, buffers and velocities carried into
    the port (resnet_params_from_jax, optimizer_state_from_jax); one more
    step on each side."""
    x, y = batch(4, seed=4)
    jm, _ = resnet18_pair(state)
    jm.train()
    jopt = pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                 parameters=jm.parameters())
    jstep = pt.jit.TrainStep(jm, pt.nn.CrossEntropyLoss(), jopt)
    jstep(pt.to_tensor(x), pt.to_tensor(y))
    tm = ptt.vision.models.resnet18(num_classes=10, device="cpu")
    tm.load_state_dict(resnet_params_from_jax(
        {k: np.array(v.numpy()) for k, v in jm.state_dict().items()}, tm))
    tm.train()
    topt = ptt.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                  parameters=tm.parameters())
    accums = {k: np.array(v) for k, v in jstep._accums_to_named().items()}
    topt.set_state_dict(optimizer_state_from_jax(accums, tm, 1))
    assert topt.state_dict()["@step"] == 1
    tstep = ptt.TrainStep(tm, ptt.nn.CrossEntropyLoss(), topt)
    jl = [float(jstep(pt.to_tensor(x), pt.to_tensor(y)).numpy())]
    tl = [float(tstep((torch.from_numpy(x),), (torch.from_numpy(y),)))]
    assert_steps_match(jm, jstep, tm, topt, jl, tl, LOSS_TOL, STATE_TOL)
