"""The GPT slice's layers and functionals against the JAX package's, on
the CPU: gelu, layer_norm / LayerNorm, CrossEntropyLoss and dropout.

Inputs are numpy arrays from a seed, handed to both packages.
Tolerances, and why:
- gelu (erf and tanh forms), float32: 1e-6 of the largest output (torch
  and XLA evaluate erf and tanh with different polynomials; the gap
  measured 7.4e-8 of the largest);
- layer_norm in float32: 1e-5 of the largest output (summation order of
  the mean and variance; measured 1.7e-7);
- layer_norm in bf16: the JAX function takes the mean and variance in
  bf16, torch in float32, so the two differ by a bf16 rounding of the
  output and more near 0, where the bf16 mean's cancellation shows. The
  gap measured 0.0625 at a largest output of 8.44 (one bf16 ulp there,
  2^-7.1 of the largest); it is held to 2^-6 of the largest;
- CrossEntropyLoss, float32: 1e-6 relative;
- dropout draws another mask than JAX, so its checks are its own: over
  100,000 elements at p = 0.1 the keep share is within 0.006 of 0.9 (six
  standard deviations, sqrt(0.9 x 0.1 / 1e5) = 0.00095), and every kept
  element is exactly x / 0.9 in float32 (the JAX package's
  ``x / keep``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt

from paddle_tpu_torch.nn import CrossEntropyLoss, Dropout, LayerNorm
from paddle_tpu_torch.nn import functional as F

GELU_TOL = 1e-6
LN_TOL = 1e-5
LN_BF16_TOL = 2.0 ** -6
CE_RTOL = 1e-6
KEEP_BOUND = 0.006


def _x(shape=(4, 33, 96), seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 3 + 1).astype(np.float32)


def _close(got, ref, tol):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_matches_jax(approximate):
    x = _x()
    ref = pt.nn.functional.gelu(pt.to_tensor(x), approximate=approximate)
    got = F.gelu(torch.from_numpy(x), approximate=approximate)
    _close(got.numpy(), ref.numpy(), GELU_TOL)
    exact = F.gelu(torch.from_numpy(x), approximate=not approximate)
    assert not torch.equal(got, exact)          # the two forms differ


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("affine", ["both", "none", "weight", "bias"])
def test_layer_norm_matches_jax(dtype, affine):
    x = _x()
    rng = np.random.default_rng(1)
    w = rng.standard_normal(96).astype(np.float32) \
        if affine in ("both", "weight") else None
    b = rng.standard_normal(96).astype(np.float32) \
        if affine in ("both", "bias") else None

    def jax_t(a):
        return None if a is None else pt.to_tensor(a).astype(dtype)

    def port_t(a):
        return None if a is None else torch.from_numpy(a).to(
            getattr(torch, dtype))

    ref = pt.nn.functional.layer_norm(jax_t(x), 96, jax_t(w), jax_t(b),
                                      1e-5).astype("float32")
    got = F.layer_norm(port_t(x), 96, port_t(w), port_t(b), 1e-5)
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), ref.numpy(),
           LN_TOL if dtype == "float32" else LN_BF16_TOL)


@pytest.mark.parametrize("weight_attr,bias_attr", [(None, None),
                                                   (False, None),
                                                   (None, False),
                                                   (False, False)])
def test_layer_norm_layer_matches_jax(weight_attr, bias_attr):
    x = _x((2, 5, 3, 8))
    jl = pt.nn.LayerNorm([3, 8], weight_attr=weight_attr,
                         bias_attr=bias_attr)
    tl = LayerNorm([3, 8], weight_attr=weight_attr, bias_attr=bias_attr,
                   device="cpu")
    assert (tl.weight is None) == (weight_attr is False)
    assert (tl.bias is None) == (bias_attr is False)
    if tl.weight is not None:
        assert torch.equal(tl.weight, torch.ones(3, 8))
    if tl.bias is not None:
        assert torch.equal(tl.bias, torch.zeros(3, 8))
    assert len(list(tl.parameters())) == len(list(jl.parameters()))
    _close(tl(torch.from_numpy(x)).detach().numpy(),
           jl(pt.to_tensor(x)).numpy(), LN_TOL)


def test_layer_norm_param_attr_raises():
    for kw in ({"weight_attr": object()}, {"bias_attr": object()}):
        with pytest.raises(NotImplementedError, match="ParamAttr"):
            LayerNorm(8, **kw)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_loss_matches_jax(reduction):
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((64, 50)).astype(np.float32) * 2
    labels = rng.integers(0, 50, 64).astype(np.int64)
    labels[::7] = -100                          # ignored rows
    ref = pt.nn.CrossEntropyLoss(reduction=reduction)(
        pt.to_tensor(logits), pt.to_tensor(labels))
    got = CrossEntropyLoss(reduction=reduction)(torch.from_numpy(logits),
                                                torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.numpy()),
                               rtol=CE_RTOL, atol=0)
    smooth = CrossEntropyLoss(label_smoothing=0.1)(
        torch.from_numpy(logits), torch.from_numpy(labels))
    jsmooth = pt.nn.CrossEntropyLoss(label_smoothing=0.1)(
        pt.to_tensor(logits), pt.to_tensor(labels))
    np.testing.assert_allclose(smooth.item(), float(jsmooth.numpy()),
                               rtol=CE_RTOL)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_dropout_keep_share_and_scale():
    x = torch.from_numpy(_x((100, 1000)))
    y = F.dropout(x, p=0.1, generator=_gen())
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) <= KEEP_BOUND
    # every kept element exactly x / keep, as the JAX package computes it
    assert torch.equal(y[kept], x[kept] / 0.9)
    down = F.dropout(x, p=0.1, mode="downscale_in_infer", generator=_gen())
    assert torch.equal(down != 0, kept)         # same seed, same mask
    assert torch.equal(down[kept], x[kept])


def test_dropout_identity_and_inference_scale():
    x = torch.from_numpy(_x((8, 16)))
    assert F.dropout(x, p=0.3, training=False) is x
    assert F.dropout(x, p=0.0, generator=_gen()) is x
    assert torch.equal(F.dropout(x, p=0.3, training=False,
                                 mode="downscale_in_infer"), x * 0.7)
    jref = pt.nn.functional.dropout(pt.to_tensor(x.numpy()), p=0.3,
                                    training=False,
                                    mode="downscale_in_infer")
    np.testing.assert_allclose((x * 0.7).numpy(), np.asarray(jref.numpy()),
                               rtol=1e-7)
    layer = Dropout(0.3, generator=_gen()).eval()
    assert layer(x) is x


def test_dropout_axis_shares_the_mask_across_other_axes():
    x = torch.from_numpy(_x((6, 50, 40)))
    y = F.dropout(x, p=0.5, axis=[0, 2], generator=_gen(4))
    kept = y != 0
    # one draw per (batch, column): the mask is constant along axis 1
    assert torch.equal(kept, kept[:, :1, :].expand_as(kept))
    assert 0.3 < kept.float().mean().item() < 0.7
    y1 = F.dropout(x, p=0.5, axis=1, generator=_gen(4))
    k1 = y1 != 0
    assert torch.equal(k1, k1[:1, :, :1].expand_as(k1))


def test_dropout_is_deterministic_per_generator_and_leaves_global_rng():
    x = torch.from_numpy(_x((64, 64)))
    before = torch.get_rng_state()
    a = F.dropout(x, p=0.2, generator=_gen(5))
    b = F.dropout(x, p=0.2, generator=_gen(5))
    c = F.dropout(x, p=0.2, generator=_gen(6))
    layer = Dropout(0.2, generator=_gen(5))
    d = layer(x)
    assert torch.equal(a, b) and torch.equal(a, d)
    assert not torch.equal(a, c)
    assert not torch.equal(layer(x), d)         # the layer's generator moved
    assert torch.equal(before, torch.get_rng_state())
    with pytest.raises(ValueError, match="generator"):
        F.dropout(x, p=0.2)
    with pytest.raises(ValueError, match="mode"):
        F.dropout(x, p=0.2, mode="scale", generator=_gen())


def test_relu_matches_jax():
    x = _x()
    ref = pt.nn.functional.relu(pt.to_tensor(x)).numpy()
    got = F.relu(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), ref)
    from paddle_tpu_torch.nn import GELU, ReLU
    assert torch.equal(ReLU()(torch.from_numpy(x)), got)
    assert torch.equal(GELU(True)(torch.from_numpy(x)),
                       F.gelu(torch.from_numpy(x), True))


def test_containers_follow_the_reference():
    """Sequential's (name, layer) form names its sublayers as the JAX
    container does; indexing, slicing, LayerList, LayerDict and
    ParameterList keep the reference's behaviour."""
    import paddle_tpu_torch as ptt
    tlay = [("stem", Dropout(0.0)), ("head", Dropout(0.0))]
    jlay = [("stem", pt.nn.Dropout(0.0)), ("head", pt.nn.Dropout(0.0))]
    seq, jseq = ptt.nn.Sequential(tlay), pt.nn.Sequential(jlay)
    assert [n for n, _ in seq.named_children()] == \
        list(jseq._sub_layers) == ["stem", "head"]
    assert len(seq) == 2 and seq[1] is tlay[1][1]
    assert isinstance(seq[0:1], ptt.nn.Sequential) and len(seq[0:1]) == 1
    pos = ptt.nn.Sequential(Dropout(0.0), Dropout(0.0))
    assert [n for n, _ in pos.named_children()] == ["0", "1"]
    x = torch.ones(3)
    assert torch.equal(seq(x), x)
    ll = ptt.nn.LayerList([Dropout(0.0)])
    ll.append(Dropout(0.0)).extend([Dropout(0.0)])
    ll.insert(0, Dropout(0.5))
    assert len(ll) == 4 and ll[0].p == 0.5 and ll[-1] is ll[3]
    ld = ptt.nn.LayerDict({"a": Dropout(0.0)})
    ld["b"] = Dropout(0.0)
    assert list(ld) == ["a", "b"] and "a" in ld
    ld.pop("a")
    assert list(ld.keys()) == ["b"]
    pl = ptt.nn.ParameterList([torch.nn.Parameter(torch.zeros(2))])
    pl.append(torch.nn.Parameter(torch.ones(3)))
    assert len(pl) == 2 and [p.numel() for p in pl] == [2, 3]
    holder = torch.nn.Module()
    holder.params = pl
    assert len(list(holder.parameters())) == 2
