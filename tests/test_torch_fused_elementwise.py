"""The port's RoPE and causal softmax kernel module against the JAX
package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions and the
JAX side runs ``rope_pallas`` and ``masked_softmax_upper_tri_pallas`` in
interpret mode, as tests/test_fused_elementwise.py runs them. Both get the
same numpy arrays: B 2, S 128-256, H 2-4, D 128.

Tolerances: float32 within 1e-5 of the largest magnitude of the reference
(the softmax sums run in another order; RoPE is the same products and
sums); bfloat16 within one bf16 ulp (|a - b| <= 2^-7 |b|, plus 1e-5 of
the largest), since both sides compute in float32 and round once.

The JAX backward multiplies p = 0 by g across a whole row, so a NaN in g
above the diagonal makes the JAX row NaN; the port never reads that half
(a reference hazard it does not copy), so the parity tests keep g finite
there and a separate test poisons it.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddle_tpu.kernels.pallas.fused_elementwise import (
    masked_softmax_upper_tri_pallas, rope_pallas)

from paddle_tpu_torch.kernels.fused_elementwise import (
    CausalSoftmax, Rope, causal_softmax_bwd, causal_softmax_bwd_plain,
    causal_softmax_fwd, causal_softmax_fwd_plain, masked_softmax_supported,
    masked_softmax_upper_tri, rope, rope_plain, rope_supported)

BF16_RTOL = 2.0 ** -7
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(a):
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


def _both(a, dtype):
    return jnp.asarray(a, _JNP[dtype]), torch.tensor(a, dtype=_TORCH[dtype])


def _tables(rng, s, d, real=True):
    """cos/sin [s, d] float32: the Llama tables, or random ones whose two
    halves differ (which catches a kernel that reads c1 for c2)."""
    if real:
        inv = 1.0 / (10000.0 ** (np.arange(0, d, 2) / d))
        emb = np.concatenate([np.outer(np.arange(s), inv)] * 2, -1)
        return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)
    return (rng.standard_normal((s, d)).astype(np.float32),
            rng.standard_normal((s, d)).astype(np.float32))


# -- RoPE ------------------------------------------------------------------------

@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("b,s,h", [(2, 128, 2), (2, 256, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_forward_matches_pallas(dtype, b, s, h, real):
    rng = np.random.default_rng(s + h + real)
    x = rng.standard_normal((b, s, h, 128)).astype(np.float32)
    cos, sin = _tables(rng, s, 128, real)
    jx, tx = _both(x, dtype)
    ref = rope_pallas(jx, jnp.asarray(cos), jnp.asarray(sin))
    out = rope_plain(tx, torch.tensor(cos), torch.tensor(sin))
    assert out.dtype == _TORCH[dtype]
    _close(out, ref, dtype)


@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_backward_matches_pallas(dtype, real):
    """The backward direction against the VJP of rope_pallas (its custom
    VJP runs the same Pallas kernel with the untransposed sign)."""
    b, s, h = 2, 128, 2
    rng = np.random.default_rng(11 + real)
    x = rng.standard_normal((b, s, h, 128)).astype(np.float32)
    g = rng.standard_normal((b, s, h, 128)).astype(np.float32)
    cos, sin = _tables(rng, s, 128, real)
    jx, _ = _both(x, dtype)
    jg, tg = _both(g, dtype)
    _, vjp = jax.vjp(lambda a: rope_pallas(a, jnp.asarray(cos),
                                           jnp.asarray(sin)), jx)
    ref, = vjp(jg)
    out = rope_plain(tg, torch.tensor(cos), torch.tensor(sin),
                     backward=True)
    _close(out, ref, dtype)


def test_rope_one_row_table_broadcasts():
    """A [1, D] table pairs every position with row 0: as rope_pallas with
    that row repeated S times."""
    b, s, h = 2, 128, 2
    rng = np.random.default_rng(4)
    x = rng.standard_normal((b, s, h, 128)).astype(np.float32)
    cos, sin = _tables(rng, 1, 128, real=False)
    ref = rope_pallas(jnp.asarray(x), jnp.asarray(np.repeat(cos, s, 0)),
                      jnp.asarray(np.repeat(sin, s, 0)))
    out = rope(torch.tensor(x), torch.tensor(cos), torch.tensor(sin))
    _close(out, ref, "float32")


def test_rope_autograd_matches_pallas():
    b, s, h = 2, 128, 4
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, s, h, 128)).astype(np.float32)
    g = rng.standard_normal((b, s, h, 128)).astype(np.float32)
    cos, sin = _tables(rng, s, 128, real=False)
    jout, vjp = jax.vjp(lambda a: rope_pallas(a, jnp.asarray(cos),
                                              jnp.asarray(sin)),
                        jnp.asarray(x))
    jdx, = vjp(jnp.asarray(g))
    tx = torch.tensor(x, requires_grad=True)
    tc = torch.tensor(cos, requires_grad=True)
    ts = torch.tensor(sin, requires_grad=True)
    out = Rope.apply(tx, tc, ts)
    out.backward(torch.tensor(g))
    _close(out, jout, "float32")
    _close(tx.grad, jdx, "float32")
    # the tables are buffers: no gradient, as in the JAX custom VJP
    assert tc.grad is None and ts.grad is None


def test_rope_routing_condition():
    assert rope_supported(torch.empty(2, 4, 2, 128))
    assert rope_supported(torch.empty(1, 1, 1, 256))
    assert not rope_supported(torch.empty(2, 4, 2, 64))
    assert not rope_supported(torch.empty(8, 2, 128))


# -- causal softmax ----------------------------------------------------------------

@pytest.mark.parametrize("n,s", [(3, 128), (2, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_forward_matches_pallas(dtype, n, s):
    rng = np.random.default_rng(n * s)
    x = (3.0 * rng.standard_normal((n, s, s))).astype(np.float32)
    jx, tx = _both(x, dtype)
    ref = masked_softmax_upper_tri_pallas(jx)
    out = causal_softmax_fwd_plain(tx)
    assert out.dtype == _TORCH[dtype]
    _close(out, ref, dtype)
    assert not np.triu(_np(out), 1).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_backward_matches_pallas(dtype):
    n, s = 2, 256
    rng = np.random.default_rng(21)
    x = (3.0 * rng.standard_normal((n, s, s))).astype(np.float32)
    g = rng.standard_normal((n, s, s)).astype(np.float32)
    jx, _ = _both(x, dtype)
    jg, tg = _both(g, dtype)
    jp, vjp = jax.vjp(masked_softmax_upper_tri_pallas, jx)
    ref, = vjp(jg)
    p = torch.tensor(_np(jp), dtype=_TORCH[dtype])
    out = causal_softmax_bwd_plain(p, tg)
    assert out.dtype == _TORCH[dtype]
    _close(out, ref, dtype)


def test_softmax_autograd_matches_pallas():
    """masked_softmax_upper_tri on [B, H, S, S] (folded to [N, S, S])
    against jax.vjp of the JAX entry over the kernels."""
    shape = (2, 2, 128, 128)
    rng = np.random.default_rng(8)
    x = (2.0 * rng.standard_normal(shape)).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    jout, vjp = jax.vjp(masked_softmax_upper_tri_pallas, jnp.asarray(x))
    jdx, = vjp(jnp.asarray(g))
    tx = torch.tensor(x, requires_grad=True)
    out = masked_softmax_upper_tri(tx)
    out.backward(torch.tensor(g))
    assert out.shape == shape
    _close(out, jout, "float32")
    _close(tx.grad, jdx, "float32")


def test_softmax_masked_half_is_never_read():
    """NaN and inf above the diagonal, in x (forward) and in g (backward),
    change nothing: the port reads columns <= row only. The JAX forward
    drops the masked half by a select too; the JAX backward gives NaN rows
    (0 * NaN), a hazard of the reference the port does not copy."""
    n, s = 2, 128
    rng = np.random.default_rng(13)
    x = rng.standard_normal((n, s, s)).astype(np.float32)
    g = rng.standard_normal((n, s, s)).astype(np.float32)
    upper = np.triu(np.ones((s, s), bool), 1)
    xp, gp = x.copy(), g.copy()
    xp[:, upper] = np.nan
    xp[0, 0, 1] = np.inf
    gp[:, upper] = np.nan
    clean = causal_softmax_fwd_plain(torch.tensor(x))
    poisoned = causal_softmax_fwd_plain(torch.tensor(xp))
    assert torch.equal(clean, poisoned)
    _close(poisoned, masked_softmax_upper_tri_pallas(jnp.asarray(xp)),
           "float32")
    dx = causal_softmax_bwd_plain(clean, torch.tensor(g))
    dxp = causal_softmax_bwd_plain(clean, torch.tensor(gp))
    assert torch.isfinite(dxp).all() and torch.equal(dx, dxp)
    _, vjp = jax.vjp(masked_softmax_upper_tri_pallas, jnp.asarray(x))
    jdxp, = vjp(jnp.asarray(gp))
    assert np.isnan(_np(jdxp)).all(axis=-1)[:, :-1].all()


def test_softmax_cpu_wrappers_are_the_plain_versions():
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.standard_normal((2, 128, 128)).astype(np.float32))
    g = torch.tensor(rng.standard_normal((2, 128, 128)).astype(np.float32))
    before = (causal_softmax_fwd.launches, causal_softmax_bwd.launches,
              rope.launches)
    p = causal_softmax_fwd(x)
    assert torch.equal(p, causal_softmax_fwd_plain(x))
    assert torch.equal(causal_softmax_bwd(p, g),
                       causal_softmax_bwd_plain(p, g))
    xr = torch.tensor(rng.standard_normal((1, 128, 2, 128))
                      .astype(np.float32))
    c, sn = (torch.tensor(t) for t in _tables(rng, 128, 128, real=False))
    assert torch.equal(rope(xr, c, sn), rope_plain(xr, c, sn))
    assert (causal_softmax_fwd.launches, causal_softmax_bwd.launches,
            rope.launches) == before


def test_softmax_routing_condition():
    assert masked_softmax_supported(torch.empty(2, 128, 128))
    assert masked_softmax_supported(torch.empty(256, 256))
    assert not masked_softmax_supported(torch.empty(2, 96, 96))
    assert not masked_softmax_supported(torch.empty(2, 128, 256))


def test_wrappers_refuse_other_devices():
    x = torch.empty(1, 128, 128, device="meta")
    with pytest.raises(RuntimeError, match="no causal softmax kernel"):
        causal_softmax_fwd(x)
    with pytest.raises(RuntimeError, match="no causal softmax kernel"):
        causal_softmax_bwd(x, x)
    with pytest.raises(RuntimeError, match="no causal softmax kernel"):
        CausalSoftmax.apply(x)
    xr = torch.empty(1, 4, 2, 128, device="meta")
    t = torch.empty(4, 128, device="meta")
    with pytest.raises(RuntimeError, match="no RoPE kernel"):
        rope(xr, t, t)
