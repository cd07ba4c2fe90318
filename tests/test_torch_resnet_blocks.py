"""The port's ResNet blocks and ResNet-50 against the JAX package's, on
the CPU (set-up: tests/torch_resnet_cases.py).

Each block in training mode, weights, batch-norm statistics, input and
output gradient from numpy with a seed: BasicBlock and BottleneckBlock
without and with a downsample (a strided 1 x 1 Conv2D and a BatchNorm2D
in a Sequential), and a ResNeXt bottleneck (groups 32, base width 4).
Checked: the output, the gradients of the input and of every parameter,
and the running statistics after the forward. Then resnet50's eval
forward at 64 x 64.

Tolerances, and why: outputs and buffers 1e-5 of the largest, gradients
1e-4 of each array's largest (float32 convolutions summed in another
order by XLA and by torch's CPU kernels, the gradients through two or
three of them and a batch norm's backward; measured 9.9e-7 for the
blocks and 9.7e-7 for resnet50's logits).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.vision.models import resnet as jresnet

import paddle_tpu_torch as ptt
from paddle_tpu_torch.vision.models import resnet as tresnet
from torch_resnet_cases import (close, jax_shapes, load_jax, load_port,
                                random_state, zero_initializers)

OUT_TOL = 1e-5
GRAD_TOL = 1e-4

# (block, inplanes, planes, stride, downsample, groups, base_width)
BLOCKS = {
    "basic": ("BasicBlock", 64, 64, 1, False, 1, 64),
    "basic_downsample": ("BasicBlock", 64, 128, 2, True, 1, 64),
    "bottleneck": ("BottleneckBlock", 256, 64, 1, False, 1, 64),
    "bottleneck_downsample": ("BottleneckBlock", 64, 128, 2, True, 1, 64),
    "resnext_32x4d": ("BottleneckBlock", 128, 64, 1, True, 32, 4),
}


def _block(pkg, name, inplanes, planes, stride, downsample, groups, width):
    nn = pt.nn if pkg is jresnet else ptt.nn
    kw = {} if pkg is jresnet else {"device": "cpu"}
    cls = getattr(pkg, name)
    ds = None
    if downsample:
        out = planes * cls.expansion
        ds = nn.Sequential(nn.Conv2D(inplanes, out, 1, stride=stride,
                                     bias_attr=False, **kw),
                           nn.BatchNorm2D(out, **kw))
    return cls(inplanes, planes, stride, ds, groups, width, **kw)


@pytest.mark.parametrize("case", list(BLOCKS))
def test_block_train_forward_backward_matches_jax(case):
    args = BLOCKS[case]
    with zero_initializers():
        jb = _block(jresnet, *args)
    state = random_state(jax_shapes(jb), seed=len(case))
    load_jax(jb, state)
    tb = load_port(_block(tresnet, *args), state)
    jb.train()
    tb.train()
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, args[1], 16, 16)).astype(np.float32)

    jx = pt.to_tensor(x, stop_gradient=False)
    jout = jb(jx)
    g = rng.standard_normal(tuple(jout.shape)).astype(np.float32)
    (jout * pt.to_tensor(g)).sum().backward()

    tx = torch.from_numpy(x).requires_grad_()
    tout = tb(tx)
    (tout * torch.from_numpy(g)).sum().backward()

    close(tout.detach().numpy(), jout.numpy(), OUT_TOL)
    close(tx.grad.numpy(), jx.grad.numpy(), GRAD_TOL)
    jgrads = {k: p.grad.numpy() for k, p in jb.named_parameters()}
    tgrads = {k: p.grad.numpy() for k, p in tb.named_parameters()}
    assert set(jgrads) == set(tgrads) and len(tgrads) >= 6
    for k, ref in jgrads.items():
        close(tgrads[k], ref, GRAD_TOL)
    jbuf = {k: b.numpy() for k, b in jb.named_buffers()}
    tbuf = {k: b.numpy() for k, b in tb.named_buffers()}
    assert set(jbuf) == set(tbuf)
    for k, ref in jbuf.items():
        close(tbuf[k], ref, OUT_TOL)
        assert not np.array_equal(tbuf[k], state[k])


def test_resnet50_eval_forward_matches_jax():
    with zero_initializers():
        jm = pt.vision.models.resnet50(num_classes=10)
    state = random_state(jax_shapes(jm), seed=50)
    load_jax(jm, state)
    tm = load_port(ptt.vision.models.resnet50(num_classes=10, device="cpu"),
                   state)
    jm.eval()
    tm.eval()
    x = np.random.default_rng(5).standard_normal(
        (2, 3, 64, 64)).astype(np.float32)
    ref = jm(pt.to_tensor(x)).numpy()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 10)
    close(got, ref, OUT_TOL)


def test_constructors_and_pretrained():
    for name in tresnet.__all__:
        if name.startswith(("resnet", "resnext", "wide")):
            with pytest.raises(NotImplementedError, match="pretrained"):
                getattr(tresnet, name)(pretrained=True, device="cpu")
    m = tresnet.resnext50_32x4d(num_classes=0, with_pool=False,
                                device="cpu")
    assert m.layer1[0].conv2._groups == 32
    assert m.layer1[0].conv2.weight.shape == (128, 4, 3, 3)
    assert tresnet.wide_resnet50_2(num_classes=0, device="cpu").layer1[0] \
        .conv1.weight.shape == (128, 64, 1, 1)
    with torch.no_grad():
        out = m(torch.zeros(1, 3, 64, 64))
    assert out.shape == (1, 2048, 2, 2)
