"""The port's dense attention functionals and RMSNorm take the JAX
package's arguments and return its forms.

The same numpy arrays (float32, [B, S, H, D]) go through
``paddle_tpu.nn.functional.flash_attention`` /
``scaled_dot_product_attention`` (on the CPU the JAX package takes its
XLA path) and through the port's functionals (on the CPU their plain
versions), called with the same positional and keyword arguments. The
outputs are held to 1e-5: both compute softmax(q k^T / sqrt(D)) v in
float32 and differ in summation order only. Every argument the port does
not implement raises NotImplementedError rather than being ignored.
"""
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn.functional as jF

from paddle_tpu_torch.nn.layer.norm import RMSNorm
from paddle_tpu_torch.nn.functional import (flash_attention,
                                            scaled_dot_product_attention)

ATOL = 1e-5


def _qkv(seed, shape=(2, 24, 3, 16)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _both(fn_jax, fn_torch, arrays, *args, **kwargs):
    ref = fn_jax(*(pt.to_tensor(a) for a in arrays), *args, **kwargs)
    got = fn_torch(*(torch.from_numpy(a) for a in arrays), *args, **kwargs)
    return ref, got


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("args,kwargs", [
    ((), {}),                                         # full attention
    ((0.0, True), {}),                                # positional causal
    ((), {"causal": True}),
    ((0.1, True), {"training": False}),               # dropout off
    ((), {"dropout": 0.5, "causal": True, "training": False}),
    ((0.0, False, True), {}),                         # return_softmax
    ((), {"causal": True, "fixed_seed_offset": None, "rng_name": "x",
          "name": "attn"}),
])
def test_flash_attention_matches_the_reference(args, kwargs):
    arrays = _qkv(len(args) + 3 * len(kwargs))
    ref, got = _both(jF.flash_attention, flash_attention, arrays, *args,
                     **kwargs)
    assert isinstance(got, tuple) and len(got) == 2 and got[1] is None
    assert isinstance(ref, tuple) and ref[1] is None
    assert tuple(got[0].shape) == tuple(ref[0].shape) == arrays[0].shape
    _close(got[0], ref[0])


@pytest.mark.parametrize("args,kwargs", [
    ((), {}),
    ((None, 0.0, True), {}),                          # positional causal
    ((), {"is_causal": True}),
    ((None, 0.3, True, False), {}),                   # dropout off
    ((), {"dropout_p": 0.3, "is_causal": False, "training": False,
          "name": "sdpa"}),
])
def test_scaled_dot_product_attention_matches_the_reference(args, kwargs):
    arrays = _qkv(7 + len(args) + 3 * len(kwargs))
    ref, got = _both(jF.scaled_dot_product_attention,
                     scaled_dot_product_attention, arrays, *args, **kwargs)
    assert isinstance(got, torch.Tensor)
    _close(got, ref)


def test_the_two_functionals_agree_causal():
    """The flash path and the plain path give one function (the Llama
    model's use_flash_attention switch)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(11))
    out, _ = flash_attention(q, k, v, 0.0, True)
    ref = scaled_dot_product_attention(q, k, v, None, 0.0, True)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


def test_scale_is_a_trailing_keyword_only():
    q, k, v = (torch.from_numpy(a) for a in _qkv(12))
    out, _ = flash_attention(q, k, v, causal=True, scale=0.5)
    ref = scaled_dot_product_attention(q, k, v, is_causal=True, scale=0.5)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)
    default, _ = flash_attention(q, k, v, causal=True)
    assert not torch.allclose(out, default)
    for fn in (flash_attention, scaled_dot_product_attention):
        assert inspect.signature(fn).parameters["scale"].kind \
            is inspect.Parameter.KEYWORD_ONLY


@pytest.mark.parametrize("fn", [flash_attention,
                                scaled_dot_product_attention])
def test_signatures_follow_the_reference(fn):
    """The reference's parameters, in its order and with its defaults,
    followed only by the port's keyword-only additions."""
    ref = inspect.signature(getattr(jF, fn.__name__)).parameters
    got = inspect.signature(fn).parameters
    names = list(got)
    assert names[:len(ref)] == list(ref)
    for n, p in ref.items():
        assert got[n].default == p.default, n
    assert all(got[n].kind is inspect.Parameter.KEYWORD_ONLY
               for n in names[len(ref):])


def test_unported_arguments_raise():
    q, k, v = (torch.from_numpy(a) for a in _qkv(13))
    with pytest.raises(NotImplementedError, match="dropout"):
        flash_attention(q, k, v, 0.1, True)
    with pytest.raises(NotImplementedError, match="dropout"):
        scaled_dot_product_attention(q, k, v, dropout_p=0.1)
    with pytest.raises(NotImplementedError, match="attn_mask"):
        scaled_dot_product_attention(q, k, v, torch.ones(24, 24,
                                                         dtype=torch.bool))


def test_rms_norm_signature_and_default_epsilon_follow_the_reference():
    ref = inspect.signature(pt.nn.RMSNorm.__init__).parameters
    got = inspect.signature(RMSNorm.__init__).parameters
    assert list(got)[:len(ref)] == list(ref)
    for n, p in ref.items():
        assert got[n].default == p.default, n
    assert got["device"].kind is inspect.Parameter.KEYWORD_ONLY
    assert got["dtype"].kind is inspect.Parameter.KEYWORD_ONLY
    assert RMSNorm(8).eps == pt.nn.RMSNorm(8)._epsilon == 1e-6


@pytest.mark.parametrize("args,kwargs", [((), {}), ((1e-5,), {}),
                                         ((1e-5, None, "norm"), {}),
                                         ((), {"epsilon": 1e-3})])
def test_rms_norm_matches_the_reference(args, kwargs):
    x = np.random.default_rng(14).standard_normal((3, 5, 8)) \
        .astype(np.float32)
    ref = pt.nn.RMSNorm(8, *args, **kwargs)(pt.to_tensor(x))
    got = RMSNorm(8, *args, **kwargs)(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), ref.numpy(),
                               atol=1e-6, rtol=0)


def test_rms_norm_weight_attr_raises():
    with pytest.raises(NotImplementedError, match="weight_attr"):
        RMSNorm(8, 1e-6, pt.ParamAttr(name="w"))
    with pytest.raises(NotImplementedError, match="weight_attr"):
        RMSNorm(8, weight_attr=False)
