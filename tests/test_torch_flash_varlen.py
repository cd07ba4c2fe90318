"""The port's packed (varlen) attention against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions (one
document at a time) and the JAX side runs its Pallas kernels
(``_varlen_fwd``, ``_varlen_bwd``, ``flash_varlen_attention``) in interpret
mode, as tests/test_varlen_flash.py does. Both get the same numpy arrays
in float32, at H 2, D 64, with documents whose lengths are not multiples
of 128 (the JAX kernels need 128-divisible totals; the port's take any).
o and lse are held to 1e-5 and gradients to 1e-4 of each one's largest
magnitude: the sides differ in summation order only (tiled online softmax
against one softmax per document).

JAX's entry point ``flash_attn_unpadded`` takes its dense XLA fallback on
the CPU, which gives a keyless row (a q document whose k document is
empty) near-uniform attention where the kernels give zeros; the port
follows the kernels, so the entry points are compared only on inputs
without a keyless row.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as pt
from paddle_tpu.kernels.pallas.flash_varlen import (
    _varlen_bwd, _varlen_fwd, flash_varlen_attention)
from paddle_tpu.kernels.pallas.flash_varlen import (
    segments_from_cu as jax_segments)
from paddle_tpu.nn.functional.extras import (
    flash_attn_varlen_qkvpacked as jax_qkvpacked)
from paddle_tpu.nn.functional.flash_attention import (
    flash_attn_unpadded as jax_unpadded)

from paddle_tpu_torch.kernels.flash_varlen import (
    BQ, KEYLESS_LSE, dkv_block, flash_varlen_bwd, flash_varlen_bwd_plain,
    flash_varlen_fwd, flash_varlen_fwd_plain, segments_from_cu,
    varlen_supported, varlen_tile_ranges)
from paddle_tpu_torch.nn.functional import (flash_attn_unpadded,
                                            flash_attn_varlen_qkvpacked)

H, D = 2, 64
SCALE = float(1.0 / np.sqrt(D))
ATOL = 1e-5
GRAD_ATOL = 1e-4

# (q document lengths, k document lengths): one pack, and an unequal pack
# whose second k document is empty (its q rows are keyless)
PACKS = {"same_pack": ((100, 37, 250, 125), None),
         "unequal_keyless": ((100, 37, 250, 125), (60, 0, 200, 124))}


def _cu(lens):
    return np.cumsum([0] + list(lens)).astype(np.int32)


def _arrays(seed, tq, tk):
    """q [tq, H, D], k and v [tk, H, D] and a cotangent dO [tq, H, D]."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, H, D)).astype(np.float32)
            for n in (tq, tk, tk, tq)]


def _case(pack, seed):
    lq, lk = PACKS[pack]
    lk = lq if lk is None else lk
    cu_q, cu_k = _cu(lq), _cu(lk)
    q, k, v, do = _arrays(seed, int(cu_q[-1]), int(cu_k[-1]))
    return q, k, v, do, cu_q, cu_k


def _jax_segs(cu, total):
    s, p = jax_segments(jnp.asarray(cu), total)
    return s, p


def _t(a):
    return torch.from_numpy(np.array(a))


def _torch_segs(cu, total):
    return segments_from_cu(torch.from_numpy(cu), total)


def _close(got, ref, atol, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0, err_msg=what)


@pytest.mark.parametrize("cu,total", [
    ([0, 3, 3, 5, 6, 6], 6),          # an empty document inside, one at the end
    ([0, 100, 137, 387, 512], 512),
    ([0, 0, 5], 5),                   # an empty first document
    ([0, 2, 9], 6),                   # a boundary past the total
    ([0, -1, 4], 6),                  # a negative boundary (JAX wraps it)
    ([0, 4], 6),                      # tokens past the last boundary
])
def test_segments_from_cu_matches_jax(cu, total):
    cu = np.array(cu, np.int32)
    js, jp = _jax_segs(cu, total)
    seg, pos = _torch_segs(cu, total)
    assert seg.dtype == pos.dtype == torch.int32
    assert seg.tolist() == np.asarray(js).tolist()
    assert pos.tolist() == np.asarray(jp).tolist()


def test_segments_of_the_issue_example():
    seg, pos = segments_from_cu(torch.tensor([0, 3, 3, 5, 6, 6]), 6)
    assert seg.tolist() == [0, 0, 0, 2, 2, 3]
    assert pos.tolist() == [0, 1, 2, 0, 1, 0]


@pytest.mark.parametrize("pack", sorted(PACKS))
@pytest.mark.parametrize("causal", [True, False])
def test_plain_forward_matches_jax_kernel(pack, causal):
    q, k, v, _, cu_q, cu_k = _case(pack, 1 + causal)
    tq, tk = q.shape[0], k.shape[0]
    jsq, jpq = _jax_segs(cu_q, tq)
    jsk, jpk = _jax_segs(cu_k, tk)
    jo, jlse = _varlen_fwd(*(jnp.asarray(a).swapaxes(0, 1) for a in
                             (q, k, v)), jsq, jpq, jsk, jpk, causal, SCALE,
                           False)
    sq, pq = _torch_segs(cu_q, tq)
    sk, pk = _torch_segs(cu_k, tk)
    o, lse = flash_varlen_fwd(_t(q), _t(k), _t(v), sq, pq, sk, pk, causal,
                              SCALE)
    assert o.dtype == torch.float32 and tuple(o.shape) == (tq, H, D)
    assert tuple(lse.shape) == (H, tq)
    _close(o.numpy(), np.asarray(jo).swapaxes(0, 1), ATOL, "o")
    _close(lse.numpy(), jlse, ATOL, "lse")
    if pack == "unequal_keyless":
        rows = slice(int(cu_q[1]), int(cu_q[2]))   # the empty k document's
        assert not o[rows].any()
        assert (lse[:, rows] == KEYLESS_LSE).all()


@pytest.mark.parametrize("pack", sorted(PACKS))
@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_jax_kernel(pack, causal):
    q, k, v, do, cu_q, cu_k = _case(pack, 3 + causal)
    tq, tk = q.shape[0], k.shape[0]
    jsq, jpq = _jax_segs(cu_q, tq)
    jsk, jpk = _jax_segs(cu_k, tk)
    jq, jk, jv, jdo = (jnp.asarray(a).swapaxes(0, 1) for a in (q, k, v, do))
    jo, jlse = _varlen_fwd(jq, jk, jv, jsq, jpq, jsk, jpk, causal, SCALE,
                           False)
    ref = _varlen_bwd(jq, jk, jv, jo, jlse, jdo, jsq, jpq, jsk, jpk, causal,
                      SCALE, False)
    sq, pq = _torch_segs(cu_q, tq)
    sk, pk = _torch_segs(cu_k, tk)
    got = flash_varlen_bwd(_t(q), _t(k), _t(v),
                           _t(np.asarray(jo).swapaxes(0, 1)), _t(jlse),
                           _t(do), sq, pq, sk, pk, causal, SCALE)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        r = np.asarray(r).swapaxes(0, 1)
        top = np.abs(r).max()
        assert top > 0
        _close(g.numpy() / top, r / top, GRAD_ATOL, name)
    if pack == "unequal_keyless":
        rows = slice(int(cu_q[1]), int(cu_q[2]))
        assert not got[0][rows].any()            # keyless rows: dq = 0


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_matches_jax_grad(causal):
    """flash_attn_unpadded differentiated by torch.autograd (its backward
    is the varlen backward) against jax.grad of the JAX kernel entry, on
    one pack, with a random cotangent."""
    q, k, v, g, cu_q, _ = _case("same_pack", 5 + causal)
    jcu = jnp.asarray(cu_q)

    def jloss(a, b, c):
        o = flash_varlen_attention(a, b, c, jcu, jcu, scale=SCALE,
                                   causal=causal, same_pack=True)
        return jnp.sum(o * g)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                              for a in (q, k, v)))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    cu = torch.from_numpy(cu_q)
    out = flash_attn_unpadded(tq, tk, tv, cu, cu, 250, 250, SCALE,
                              causal=causal)
    (out * _t(g)).sum().backward()
    for name, t, r in zip(("dq", "dk", "dv"), (tq, tk, tv), jg):
        r = np.asarray(r)
        top = np.abs(r).max()
        _close(t.grad.numpy() / top, r / top, GRAD_ATOL, name)


@pytest.mark.parametrize("causal", [True, False])
def test_entry_point_matches_jax_entry_point(causal):
    """No keyless row: the JAX entry's dense CPU fallback and the port's
    entry compute the same function."""
    q, k, v, _, cu_q, _ = _case("same_pack", 7 + causal)
    ref = jax_unpadded(pt.to_tensor(q), pt.to_tensor(k), pt.to_tensor(v),
                       pt.to_tensor(cu_q), pt.to_tensor(cu_q), 250, 250,
                       SCALE, causal=causal)
    out = flash_attn_unpadded(_t(q), _t(k), _t(v), torch.from_numpy(cu_q),
                              torch.from_numpy(cu_q), 250, 250, SCALE,
                              causal=causal)
    _close(out.numpy(), ref.numpy(), ATOL, "flash_attn_unpadded")


def test_qkvpacked_matches_jax_entry_point():
    """flash_attn_varlen_qkvpacked hands the slices of [total, 3, H, D] to
    the kernels in place; against the JAX entry (scale defaulted)."""
    rng = np.random.default_rng(9)
    cu = _cu((100, 37, 250, 125))
    qkv = rng.standard_normal((512, 3, H, D)).astype(np.float32)
    ref = jax_qkvpacked(pt.to_tensor(qkv), pt.to_tensor(cu),
                        pt.to_tensor(cu), 250, 250, causal=True)
    out = flash_attn_varlen_qkvpacked(_t(qkv), torch.from_numpy(cu),
                                      torch.from_numpy(cu), 250, 250,
                                      causal=True)
    _close(out.numpy(), ref.numpy(), ATOL, "flash_attn_varlen_qkvpacked")


def test_dropout_in_training_raises():
    q = torch.zeros(8, H, D)
    cu = torch.tensor([0, 8])
    with pytest.raises(NotImplementedError):
        flash_attn_unpadded(q, q, q, cu, cu, 8, 8, SCALE, dropout=0.1)
    with pytest.raises(NotImplementedError):
        flash_attn_varlen_qkvpacked(torch.zeros(8, 3, H, D), cu, cu, 8, 8,
                                    dropout=0.1)
    # outside training, dropout is off and the call runs
    out = flash_attn_unpadded(q, q, q, cu, cu, 8, 8, SCALE, dropout=0.1,
                              training=False)
    assert tuple(out.shape) == (8, H, D)


def _live(seg_q, pos_q, seg_k, pos_k, causal):
    live = seg_q[:, None] == seg_k[None, :]
    if causal:
        live &= pos_q[:, None] >= pos_k[None, :]
    return live


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tile_ranges_cover_every_live_pair(causal, seed):
    """The kernels visit only the ranges varlen_tile_ranges gives them: on
    random packs (empty documents, unequal packs, totals no tile divides)
    every live pair must lie inside its q tile's key range and its k
    tile's q-row range, and the forward's causal range must stop at the
    last live key of the tile."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 9))
    lq = rng.integers(0, 300, n)
    lk = lq if seed == 0 else rng.integers(0, 300, n)
    cu_q, cu_k = _cu(lq), _cu(lk)
    tq, tk = int(cu_q[-1]), int(cu_k[-1])
    sq, pq = _torch_segs(cu_q, tq)
    sk, pk = _torch_segs(cu_k, tk)
    live = _live(sq, pq, sk, pk, causal).numpy()
    for d in (64, 256):
        rq = varlen_tile_ranges(sq, pq, sk, pk, BQ, causal, True).numpy()
        rk = varlen_tile_ranges(sk, pk, sq, pq, dkv_block(d), causal,
                                False).numpy()
        assert rq.shape == (-(-tq // BQ), 2)
        assert rk.shape == (-(-tk // dkv_block(d)), 2)
        rows, cols = np.nonzero(live)
        lo, hi = rq[rows // BQ].T
        assert ((lo <= cols) & (cols < hi)).all()
        lo, hi = rk[cols // dkv_block(d)].T
        assert ((lo <= rows) & (rows < hi)).all()
        if causal and seed == 0:
            # one pack: the range ends at the tile's last live key
            for t, (lo, hi) in enumerate(rq):
                tile = live[t * BQ:(t + 1) * BQ]
                if tile.any():
                    assert hi == np.nonzero(tile.any(0))[0].max() + 1
        assert (rq >= 0).all() and (rq <= tk).all()
        assert (rk >= 0).all() and (rk <= tq).all()


def test_cpu_wrappers_take_the_plain_versions():
    q, k, v, do, cu_q, cu_k = _case("unequal_keyless", 11)
    sq, pq = _torch_segs(cu_q, q.shape[0])
    sk, pk = _torch_segs(cu_k, k.shape[0])
    args = (_t(q), _t(k), _t(v))
    before = (flash_varlen_fwd.launches, flash_varlen_bwd.launches)
    o, lse = flash_varlen_fwd(*args, sq, pq, sk, pk, True, SCALE)
    ro, rlse = flash_varlen_fwd_plain(*args, sq, pq, sk, pk, True, SCALE)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    got = flash_varlen_bwd(*args, o, lse, _t(do), sq, pq, sk, pk, True, SCALE)
    ref = flash_varlen_bwd_plain(*args, o, lse, _t(do), sq, pq, sk, pk, True,
                                 SCALE)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    # no kernel ran on the CPU
    assert (flash_varlen_fwd.launches, flash_varlen_bwd.launches) == before


def test_the_port_takes_any_total():
    assert varlen_supported(1000, 37, 128)
    assert not varlen_supported(1024, 1024, 96)
    q, k, v, _ = _arrays(13, 1000, 1000)
    cu = torch.tensor([0, 1, 500, 999, 1000])
    out = flash_attn_unpadded(_t(q), _t(k), _t(v), cu, cu, 499, 499, SCALE,
                              causal=True)
    assert tuple(out.shape) == (1000, H, D) and torch.isfinite(out).all()
    # the one-token documents attend to themselves only
    np.testing.assert_allclose(out[0].numpy(), v[0], rtol=1e-6)
    np.testing.assert_allclose(out[999].numpy(), v[999], rtol=1e-6)
