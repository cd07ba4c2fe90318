"""The port's FlashMask attention (per-column start rows) against the JAX
package.

On the CPU the port's wrappers run their plain PyTorch versions (in chunks
of B*H) and the JAX side runs its Pallas kernels (``_sm_fwd``,
``_sm_bwd``, ``flash_sparse_mask_attention``) in interpret mode, as
tests/test_varlen_flash.py does. Both get the same numpy arrays in
float32, at B 2, S 256, H 2, D 64. o and lse are held to 1e-5 and
gradients to 1e-4 of each one's largest magnitude: the sides differ in
summation order only.

Random start rows (``rng.integers(1, S + 1)``, as the JAX test draws them)
leave some rows seeing no column: the kernels give those zeros, and so
does the port. JAX's entry point ``flash_attention_with_sparse_mask``
takes a dense-bias fallback on the CPU that gives such a row near-uniform
attention, so the entry points are compared on document masks, where
every row sees itself.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as pt
from paddle_tpu.kernels.pallas.flash_sparse_mask import (
    _sm_bwd, _sm_fwd, flash_sparse_mask_attention)
from paddle_tpu.nn.functional.extras import (
    flash_attention_with_sparse_mask as jax_sparse_mask)
from paddle_tpu.nn.functional.extras import (
    flash_attn_qkvpacked as jax_qkvpacked)

from paddle_tpu_torch.kernels.flash_sparse_mask import (
    TILE, flash_sparse_mask_bwd, flash_sparse_mask_bwd_plain,
    flash_sparse_mask_fwd, flash_sparse_mask_fwd_plain,
    sparse_mask_supported, tile_max)
from paddle_tpu_torch.nn.functional import (flash_attention_with_sparse_mask,
                                            flash_attn_qkvpacked)

B, S, H, D = 2, 256, 2, 64
SCALE = float(1.0 / np.sqrt(D))
ATOL = 1e-5
GRAD_ATOL = 1e-4


def _arrays(seed, s=S):
    """q, k, v and a cotangent dO, [B, s, H, D] float32."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, s, H, D)).astype(np.float32)
            for _ in range(4)]


def _random_start(seed, s=S):
    rng = np.random.default_rng(seed + 100)
    return rng.integers(1, s + 1, (B, H, s)).astype(np.int32)


def _doc_start(lens):
    """Documents as start rows: column c of a document ending at row e
    gets start e, so row r sees c iff c <= r < e (with causal)."""
    ends = np.cumsum(lens)
    return np.repeat(ends, lens).astype(np.int32)             # [S]


def _bh(a):
    b, s, h, d = a.shape
    return jnp.asarray(a).swapaxes(1, 2).reshape(b * h, s, d)


def _from_bh(a, b=B, h=H):
    a = np.asarray(a)
    return a.reshape(b, h, a.shape[1], a.shape[2]).swapaxes(1, 2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, atol, what):
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=0,
                               err_msg=what)


START_KINDS = ("random", "documents")


def _start(kind, seed):
    if kind == "random":
        return _random_start(seed)
    doc = _doc_start([100, 37, 119])
    return np.broadcast_to(doc, (B, H, S)).copy()


@pytest.mark.parametrize("kind", START_KINDS)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_forward_matches_jax_kernel(kind, causal):
    q, k, v, _ = _arrays(1 + causal)
    start = _start(kind, 1 + causal).reshape(B * H, S)
    jo, jlse = _sm_fwd(_bh(q), _bh(k), _bh(v), jnp.asarray(start), causal,
                       SCALE)
    o, lse = flash_sparse_mask_fwd(_t(q), _t(k), _t(v), _t(start), causal,
                                   SCALE)
    assert o.dtype == torch.float32 and tuple(o.shape) == (B, S, H, D)
    assert tuple(lse.shape) == (B * H, S)
    _close(o.numpy(), _from_bh(jo), ATOL, "o")
    _close(lse.numpy(), jlse, ATOL, "lse")


@pytest.mark.parametrize("kind", START_KINDS)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_jax_kernel(kind, causal):
    q, k, v, do = _arrays(3 + causal)
    start = _start(kind, 3 + causal).reshape(B * H, S)
    js = jnp.asarray(start)
    jq, jk, jv, jdo = (_bh(a) for a in (q, k, v, do))
    jo, jlse = _sm_fwd(jq, jk, jv, js, causal, SCALE)
    ref = _sm_bwd(jq, jk, jv, jo, jlse, jdo, js, causal, SCALE)
    got = flash_sparse_mask_bwd(_t(q), _t(k), _t(v), _t(_from_bh(jo)),
                                _t(jlse), _t(do), _t(start), causal, SCALE)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        r = _from_bh(r)
        top = np.abs(r).max()
        assert top > 0
        _close(g.numpy() / top, r / top, GRAD_ATOL, name)


def test_plain_versions_chunk_over_heads():
    """The plain versions run B*H in chunks (a [B*H, S, S] float32 score
    tensor does not fit at training sizes): chunk 1 gives the same."""
    q, k, v, do = (_t(a) for a in _arrays(5))
    start = _t(_random_start(5).reshape(B * H, S))
    o, lse = flash_sparse_mask_fwd_plain(q, k, v, start, True, SCALE)
    o1, lse1 = flash_sparse_mask_fwd_plain(q, k, v, start, True, SCALE,
                                           chunk=1)
    torch.testing.assert_close(o1, o, rtol=0, atol=1e-6)
    torch.testing.assert_close(lse1, lse, rtol=0, atol=1e-6)
    got = flash_sparse_mask_bwd_plain(q, k, v, o, lse, do, start, True,
                                      SCALE)
    got1 = flash_sparse_mask_bwd_plain(q, k, v, o, lse, do, start, True,
                                       SCALE, chunk=3)
    for g, g1 in zip(got, got1):
        torch.testing.assert_close(g1, g, rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_matches_jax_grad(causal):
    """flash_attention_with_sparse_mask differentiated by torch.autograd
    against jax.grad of the JAX kernel entry, random start rows [B, H, S],
    random cotangent."""
    q, k, v, g = _arrays(7 + causal)
    start = _random_start(7 + causal)
    js = jnp.asarray(start)

    def jloss(a, b, c):
        return jnp.sum(flash_sparse_mask_attention(a, b, c, js,
                                                   causal=causal) * g)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                              for a in (q, k, v)))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = flash_attention_with_sparse_mask(tq, tk, tv, _t(start),
                                           is_causal=causal)
    (out * _t(g)).sum().backward()
    for name, t, r in zip(("dq", "dk", "dv"), (tq, tk, tv), jg):
        r = np.asarray(r)
        top = np.abs(r).max()
        _close(t.grad.numpy() / top, r / top, GRAD_ATOL, name)


@pytest.mark.parametrize("shape", ["bhs", "b1s", "s"])
def test_entry_point_matches_jax_entry_point(shape):
    """Document start rows with causal (every row sees itself, so no row
    is keyless) in each shape the JAX entry accepts."""
    q, k, v, _ = _arrays(9)
    doc = _doc_start([60, 150, 46])
    start = {"bhs": np.broadcast_to(doc, (B, H, S)).copy(),
             "b1s": np.broadcast_to(doc, (B, 1, S)).copy(),
             "s": doc}[shape]
    ref = jax_sparse_mask(pt.to_tensor(q), pt.to_tensor(k), pt.to_tensor(v),
                          pt.to_tensor(start), is_causal=True)
    out = flash_attention_with_sparse_mask(_t(q), _t(k), _t(v), _t(start),
                                           is_causal=True)
    _close(out.numpy(), ref.numpy(), ATOL, shape)


def test_rows_that_see_nothing_get_zeros():
    """Without causal, row r sees column c iff r < start[c]: start rows of
    at most 100 leave rows 100.. keyless; the kernels (and the port) give
    them 0 and zero gradients."""
    q, k, v, g = _arrays(10)
    start = np.minimum(_random_start(10), 100).astype(np.int32)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = flash_attention_with_sparse_mask(tq, tk, tv, _t(start),
                                           is_causal=False)
    (out * _t(g)).sum().backward()
    assert not out[:, 100:].any()
    assert not tq.grad[:, 100:].any()
    jo = flash_sparse_mask_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                     jnp.asarray(start), causal=False)
    _close(out.detach().numpy(), jo, ATOL, "o")


def test_qkvpacked_matches_jax_entry_point():
    rng = np.random.default_rng(12)
    qkv = rng.standard_normal((B, 128, 3, H, D)).astype(np.float32)
    ref, ref_sm = jax_qkvpacked(pt.to_tensor(qkv), causal=True)
    out, sm = flash_attn_qkvpacked(_t(qkv), causal=True)
    assert sm is None and ref_sm is None
    _close(out.numpy(), ref.numpy(), ATOL, "flash_attn_qkvpacked")


def test_dropout_in_training_raises():
    q = torch.zeros(1, 8, H, D)
    with pytest.raises(NotImplementedError):
        flash_attention_with_sparse_mask(q, q, q, torch.full((8,), 8),
                                         dropout_p=0.1)
    with pytest.raises(NotImplementedError):
        flash_attn_qkvpacked(torch.zeros(1, 8, 3, H, D), dropout=0.1)
    out = flash_attention_with_sparse_mask(q, q, q, torch.full((8,), 8),
                                           dropout_p=0.1, training=False)
    assert tuple(out.shape) == (1, 8, H, D)


@pytest.mark.parametrize("s", [256, 1000])
def test_tile_max_is_the_largest_start_of_each_tile(s):
    start = _random_start(13, s).reshape(B * H, s)
    got = tile_max(_t(start)).numpy()
    n = -(-s // TILE)
    assert got.shape == (B * H, n) and got.dtype == np.int32
    for t in range(n):
        np.testing.assert_array_equal(
            got[:, t], start[:, t * TILE:(t + 1) * TILE].max(1))


def test_cpu_wrappers_take_the_plain_versions():
    q, k, v, do = (_t(a) for a in _arrays(14))
    start = _t(_random_start(14).reshape(B * H, S))
    before = (flash_sparse_mask_fwd.launches, flash_sparse_mask_bwd.launches)
    o, lse = flash_sparse_mask_fwd(q, k, v, start, True, SCALE)
    ro, rlse = flash_sparse_mask_fwd_plain(q, k, v, start, True, SCALE)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    got = flash_sparse_mask_bwd(q, k, v, o, lse, do, start, True, SCALE)
    ref = flash_sparse_mask_bwd_plain(q, k, v, o, lse, do, start, True,
                                      SCALE)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert (flash_sparse_mask_fwd.launches,
            flash_sparse_mask_bwd.launches) == before
    assert sparse_mask_supported(1000, 128)
    assert not sparse_mask_supported(1024, 96)
