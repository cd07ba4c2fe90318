"""The port's RMSNorm kernel module against the JAX package's Pallas
RMSNorm.

On the CPU the port's wrappers run their plain PyTorch versions and the
JAX side runs its Pallas kernels (``_rms_fwd``, ``_rms_bwd``,
``rms_norm_jax``) in interpret mode, as tests/test_kernels.py runs them.
Both get the same numpy arrays at rows 64-256 and h 128-256.

Tolerances: float32 within 1e-5 of the largest magnitude of the reference
(the sides differ in summation order, and rsqrt may differ by an ulp);
bfloat16 within one bf16 ulp (|a - b| <= 2^-7 |b|, plus 1e-5 of the
largest for values that cancel near zero): both compute in float32 from
the same inputs and round once to bf16, so a float32 difference of an ulp
can move the result to the neighbouring bf16 value.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddle_tpu.kernels.pallas.rms_norm import (_rms_bwd, _rms_fwd,
                                                rms_norm_jax)

from paddle_tpu_torch.kernels.rms_norm import (RMSNorm2d, rms_norm,
                                               rms_norm_bwd,
                                               rms_norm_bwd_plain,
                                               rms_norm_fwd,
                                               rms_norm_fwd_plain)

EPS = 1e-6
BF16_RTOL = 2.0 ** -7
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(a):
    """A JAX or torch array as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, ref, dtype):
    got, ref = _np(got), _np(ref)
    top = np.abs(ref).max()
    if dtype == "bfloat16":
        np.testing.assert_array_less(np.abs(got - ref),
                                     BF16_RTOL * np.abs(ref) + 1e-5 * top
                                     + 1e-30)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * top)


def _arrays(seed, n, h):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, h)).astype(np.float32),
            (1.0 + 0.5 * rng.standard_normal(h)).astype(np.float32),
            rng.standard_normal((n, h)).astype(np.float32))


def _both(a, dtype):
    return jnp.asarray(a, _JNP[dtype]), torch.tensor(a, dtype=_TORCH[dtype])


@pytest.mark.parametrize("n,h", [(64, 128), (256, 256), (96, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_pallas(n, h, dtype):
    x, w, _ = _arrays(n + h, n, h)
    jx, tx = _both(x, dtype)
    jw, tw = _both(w, "float32")
    jout, jrstd = _rms_fwd(jx, jw, EPS)
    out, rstd = rms_norm_fwd_plain(tx, tw, EPS)
    assert out.dtype == _TORCH[dtype] and rstd.dtype == torch.float32
    assert tuple(rstd.shape) == (n,)
    _close(out, jout, dtype)
    _close(rstd, jrstd[:, 0], "float32")


@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_matches_pallas(dtype, w_dtype):
    """dx and dw from the same rstd (JAX's) on both sides; dw is cast to
    w's dtype as the custom VJP casts it."""
    n, h = 128, 256
    x, w, g = _arrays(7, n, h)
    jx, tx = _both(x, dtype)
    jw, tw = _both(w, w_dtype)
    jg, tg = _both(g, dtype)
    _, jrstd = _rms_fwd(jx, jw, EPS)
    jdx, jdw = _rms_bwd(jx, jw, jrstd, jg, EPS)
    rstd = torch.tensor(_np(jrstd)[:, 0])
    dx, dw = rms_norm_bwd_plain(tx, tw, rstd, tg)
    assert dx.dtype == _TORCH[dtype] and dw.dtype == _TORCH[w_dtype]
    _close(dx, jdx, dtype)
    _close(dw, jnp.asarray(jdw).astype(_JNP[w_dtype]), w_dtype)


@pytest.mark.parametrize("shape", [(2, 64, 128), (256, 256)])
def test_autograd_matches_rms_norm_jax(shape):
    """The Function's forward and gradients against jax.vjp of
    rms_norm_jax (the custom VJP over the Pallas kernels)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (1.0 + 0.5 * rng.standard_normal(shape[-1])).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    jout, vjp = jax.vjp(lambda a, b: rms_norm_jax(a, b, EPS),
                        jnp.asarray(x, jnp.float32),
                        jnp.asarray(w, jnp.float32))
    jdx, jdw = vjp(jnp.asarray(g, jnp.float32))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = rms_norm(tx, tw, EPS)
    out.backward(torch.from_numpy(g))
    assert out.shape == tx.shape
    _close(out, jout, "float32")
    _close(tx.grad, jdx, "float32")
    _close(tw.grad, jdw, "float32")


def test_cpu_wrappers_are_the_plain_versions():
    """On CPU tensors the wrappers return the plain versions' results and
    launch nothing."""
    x, w, g = (torch.from_numpy(a) for a in _arrays(5, 64, 128))
    before = (rms_norm_fwd.launches, rms_norm_bwd.launches)
    out, rstd = rms_norm_fwd(x, w, EPS)
    ref, rref = rms_norm_fwd_plain(x, w, EPS)
    assert torch.equal(out, ref) and torch.equal(rstd, rref)
    dx, dw = rms_norm_bwd(x, w, rstd, g)
    rdx, rdw = rms_norm_bwd_plain(x, w, rstd, g)
    assert torch.equal(dx, rdx) and torch.equal(dw, rdw)
    assert (rms_norm_fwd.launches, rms_norm_bwd.launches) == before


def test_plain_backward_agrees_with_autograd_of_the_plain_forward():
    """The plain backward is `_rms_bwd`'s formula from the saved rstd;
    it agrees with autograd of the plain forward in float32."""
    x, w, g = (torch.from_numpy(a).double() for a in _arrays(9, 64, 128))
    x.requires_grad_()
    w.requires_grad_()
    xf = x.float()
    out, rstd = rms_norm_fwd_plain(xf, w.float(), EPS)
    dx, dw = rms_norm_bwd_plain(xf.detach(), w.float().detach(),
                                rstd.detach(), g.float())
    out.backward(g.float())
    _close(dx, x.grad, "float32")
    _close(dw, w.grad, "float32")


def test_wrappers_refuse_other_devices():
    x = torch.empty(4, 128, device="meta")
    w = torch.empty(128, device="meta")
    with pytest.raises(RuntimeError, match="no RMSNorm kernel"):
        rms_norm_fwd(x, w, EPS)
    with pytest.raises(RuntimeError, match="no RMSNorm kernel"):
        rms_norm_bwd(x, w, torch.empty(4, device="meta"), x)
    with pytest.raises(RuntimeError, match="no RMSNorm kernel"):
        RMSNorm2d.apply(x, w, EPS)
