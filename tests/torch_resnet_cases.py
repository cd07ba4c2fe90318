"""Shared set-up of the ResNet parity tests (tests/test_torch_resnet*.py).

Weights come from numpy with a seed and go into both packages: the JAX
model's own initializers are swapped for zeros while it is built (its
first build would otherwise compile an initializer per parameter shape,
about 15 s), then its ``set_state_dict`` and the port's
``resnet_params_from_jax`` load the same arrays. The batch norms get
random weights, biases and running statistics, so that an eval forward
reads them.

A ReLU network's gradient is discontinuous where a ReLU input crosses 0
or a max-pool window's two largest values tie, and with ~10^6 ReLU inputs
a step some lie within the few ulps by which XLA's and torch's float32
convolutions differ. Where the two runs straddle such a point, one
element's gradient is passed by one package and blocked by the other,
and two steps at lr 0.1 (the loss falls from ~3 to ~0.1) amplify that:
surveyed over five batch seeds, two Momentum steps at batch 4 agreed to
1.2e-5-1.5e-5 of the largest velocity for three and to 6.9e-4-9.2e-4 for
two; with accum_steps=2 at batch 8 one seed agreed to 1.6e-5 and four did
not (3e-2 to 0.5). The straddle is inside XLA too: its accum_steps=2
step differs from the mean of its own two single-microbatch steps by
6.5e-3, while the port's equals the mean of its own exactly, and the
port's float32 gradients were within 9e-6 of its float64 ones where
XLA's were 7e-3 away. So each comparison below uses a seed whose runs do
not straddle one, and the tolerance of a smooth run.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu as pt
from paddle_tpu.nn import initializer as jinit

import paddle_tpu_torch as ptt
from paddle_tpu_torch.convert import resnet_params_from_jax


@contextlib.contextmanager
def zero_initializers():
    """Build JAX layers with zeros for every initial value."""
    def zeros(self, shape, dtype):
        return jnp.asarray(np.zeros(shape, np.float32))
    classes = (jinit.KaimingUniform, jinit.Uniform, jinit.Constant,
               jinit.XavierNormal)
    saved = [c.__dict__["_build"] for c in classes]
    try:
        for c in classes:
            c._build = zeros
        yield
    finally:
        for c, b in zip(classes, saved):
            c._build = b


def random_state(shapes, seed):
    """{name: numpy array} for a ResNet or block state of these JAX
    shapes: Kaiming-uniform convolutions, Xavier-uniform fc, batch norms
    around (1, 0) with running means near 0 and variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in shapes.items():
        if name.endswith("_variance"):
            a = rng.uniform(0.5, 1.5, shape)
        elif name.endswith("_mean") or name.endswith("bias"):
            a = 0.1 * rng.standard_normal(shape)
        elif len(shape) == 1:                      # a batch norm's weight
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif len(shape) == 2:                      # fc, [in, out]
            lim = np.sqrt(6.0 / (shape[0] + shape[1]))
            a = rng.uniform(-lim, lim, shape)
        else:                                      # [out, in / g, kh, kw]
            lim = np.sqrt(6.0 / np.prod(shape[1:]))
            a = rng.uniform(-lim, lim, shape)
        out[name] = a.astype(np.float32)
    return out


def jax_shapes(jax_layer):
    return {k: tuple(v.shape) for k, v in jax_layer.state_dict().items()}


def load_jax(jax_layer, state):
    jax_layer.set_state_dict({k: pt.to_tensor(v) for k, v in state.items()})
    return jax_layer


def load_port(port_layer, state):
    port_layer.load_state_dict(resnet_params_from_jax(state, port_layer))
    return port_layer


def resnet18_pair(state):
    with zero_initializers():
        jm = pt.vision.models.resnet18(num_classes=10)
    tm = ptt.vision.models.resnet18(num_classes=10, device="cpu")
    return load_jax(jm, state), load_port(tm, state)


def resnet18_state(seed=0):
    with zero_initializers():
        jm = pt.vision.models.resnet18(num_classes=10)
    return random_state(jax_shapes(jm), seed)


def batch(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3, 64, 64)).astype(np.float32),
            rng.integers(0, 10, (n,)))


def close(got, ref, tol):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=tol * np.abs(ref).max())


def port_state(model):
    return {k: (v.detach().numpy().T if k == "fc.weight"
                else v.detach().numpy())
            for k, v in model.state_dict().items()}


def train_pair(state, x, y, steps, accum_steps=1):
    """``steps`` TrainStep calls under Momentum(0.1, 0.9) on each side;
    returns (jax model, jax step, port model, port optimizer, jax losses,
    port losses)."""
    jm, tm = resnet18_pair(state)
    jm.train()
    tm.train()
    jopt = pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                 parameters=jm.parameters())
    jstep = pt.jit.TrainStep(jm, pt.nn.CrossEntropyLoss(), jopt,
                             accum_steps=accum_steps)
    topt = ptt.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                  parameters=tm.parameters())
    tstep = ptt.TrainStep(tm, ptt.nn.CrossEntropyLoss(), topt,
                          accum_steps=accum_steps)
    jl, tl = [], []
    for _ in range(steps):
        jl.append(float(jstep(pt.to_tensor(x), pt.to_tensor(y)).numpy()))
        tl.append(float(tstep((torch.from_numpy(x),),
                              (torch.from_numpy(y),))))
    return jm, jstep, tm, topt, jl, tl


def assert_steps_match(jm, jstep, tm, topt, jl, tl, loss_tol, tol):
    close(tl, jl, loss_tol)
    jstate = {k: np.array(v.numpy()) for k, v in jm.state_dict().items()}
    tstate = port_state(tm)
    assert set(jstate) == set(tstate)
    for k, ref in jstate.items():
        close(tstate[k], ref, tol)
    jvel = {k: np.array(v) for k, v in jstep._accums_to_named().items()}
    tvel = topt.state_dict()
    assert len(jvel) == len(list(tm.parameters()))
    for key, ref in jvel.items():
        pname, acc = key.split("::")
        assert acc == "velocity"
        got = tvel[f"{pname}__velocity"].numpy()
        close(got.T if pname == "fc.weight" else got, ref, tol)
