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

The card's tensor-core forward (route "wgmma": bf16 at D 64 and 128)
multiplies bf16 operands into float32 sums over 64-key tiles of the
document range, runs the online softmax in the exp2 domain with the pair
test as a select, carries p into p.v as a bf16 hi + lo pair, and guards
V against non-finite values on the tiles that are not wholly live. A
test-local emulation of that arithmetic (``_masked_wgmma_emulation``, also
used by tests/test_torch_flash_sparse_mask.py) is held here to the JAX
kernel in interpret mode by chip_smoke.py's bf16 rule, 2^-7 |ref| + 1e-4
for o (JAX's o rounded to bf16) and 1e-4 for the float32 lse: the two
differ by the bf16 rounding of o and, in float32, by summation order. The
arithmetic it avoids (p rounded once to bf16, the exp2-domain lse of a
keyless row, p = 0 times a NaN V) is shown to miss.

The card's tensor-core backward (the same route rule over q, k, v and
dO) is emulated the same way (``_masked_wgmma_bwd_emulation``): dq over
the q tiles' 64-key tiles, dk and dv over the 64-key tiles' 64-row tiles
of the policy's row range, p and ds by the pair test as a select unless a
tile is wholly live, P and dS into their products as hi + lo, and the
guard on the B operands of those products (K for dq; Q and dO for dk/dv).
It is held to JAX's ``_varlen_bwd`` in interpret mode by chip_smoke.py's
bf16 gradient rule, 2^-7 |ref| + 1e-3 max|ref|, against JAX's gradients
rounded to bf16; P and dS rounded once to bf16 are shown to miss it.

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
from paddle_tpu_torch.kernels.flash_attention import (masked_bwd_route,
                                                      masked_fwd_route)
from paddle_tpu_torch.nn.functional import (flash_attn_unpadded,
                                            flash_attn_varlen_qkvpacked)
from torch_threads import one_thread  # noqa: F401  (autouse)

H, D = 2, 64
SCALE = float(1.0 / np.sqrt(D))
ATOL = 1e-5
GRAD_ATOL = 1e-4

# (q document lengths, k document lengths): one pack, and an unequal pack
# whose second k document is empty (its q rows are keyless)
PACKS = {"same_pack": ((100, 37, 250, 125), None),
         "unequal_keyless": ((100, 37, 250, 125), (60, 0, 200, 124))}
# the tensor-core emulation's packs: 64-row q tiles span documents in
# each; an empty document; unequal packs with a keyless document
WGMMA_PACKS = dict(PACKS, empty_doc=((100, 0, 37, 250, 125), None))


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
    routed = (dict(flash_varlen_fwd.route_launches),
              dict(flash_varlen_bwd.route_launches))
    o, lse = flash_varlen_fwd(*args, sq, pq, sk, pk, True, SCALE)
    ro, rlse = flash_varlen_fwd_plain(*args, sq, pq, sk, pk, True, SCALE)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    got = flash_varlen_bwd(*args, o, lse, _t(do), sq, pq, sk, pk, True, SCALE)
    ref = flash_varlen_bwd_plain(*args, o, lse, _t(do), sq, pq, sk, pk, True,
                                 SCALE)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    # no kernel ran on the CPU, on any route
    assert (flash_varlen_fwd.launches, flash_varlen_bwd.launches) == before
    assert (flash_varlen_fwd.route_launches,
            flash_varlen_bwd.route_launches) == routed


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


# -- the tensor-core forward's arithmetic --------------------------------------

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
WG = 64                          # rows of a q tile and keys of a key tile


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _tile_is_full(live, q0, q1, k0, hi):
    """The kernel's wholly-live rule: every one of the tile's 64 columns
    is below the range's end and live for the q tile's first and last
    rows (a column's live rows form one interval under both policies)."""
    if k0 + WG > hi:
        return False
    cols = live[[q0, q1 - 1], k0:k0 + WG]
    return bool(cols.all())


def _masked_wgmma_emulation(q, k, v, live, ranges, scale, dead=None,
                            split=True, keyless_rule=True, guard=True):
    """The tensor-core masked forward's arithmetic, one head, on float32
    tensors that hold bf16 values: q [Sq, D], k and v [Sk, D], live [Sq,
    Sk] bool, ranges[t] the keys [lo, hi) of q tile t, dead(t, k0) True for
    a key tile the policy skips. Per q tile of 64 rows, key tiles of 64
    from lo: x = (q k^T) (scale log2e); a tile that is not wholly live
    takes the pair test as a select (masked columns stay out of the max,
    p = 0), and (guard) its V rows that hold a non-finite value are zeroed,
    every row with a live pair on one ending NaN; m starts at -1e30; p
    enters p.v as hi + lo (or, split False, rounded once); o = bf16(acc /
    max(l, 1e-30)); lse = (m + log2 l) ln 2, or (keyless_rule) -1e30 +
    log(1e-30) for a row whose m is still -1e30. Returns (o, lse, number
    of wholly live tiles, number of others)."""
    sq, d = q.shape
    sl2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    o = torch.zeros(sq, d)
    lse = torch.zeros(sq)
    n_full = n_part = 0
    for t, (lo, hi) in enumerate(ranges):
        q0, q1 = t * WG, min(t * WG + WG, sq)
        m = torch.full((q1 - q0,), -1e30)
        l = torch.zeros(q1 - q0)
        acc = torch.zeros(q1 - q0, d)
        nan_row = torch.zeros(q1 - q0, dtype=torch.bool)
        for k0 in range(lo, hi, WG):
            if dead is not None and dead(t, k0):
                continue
            k1 = min(k0 + WG, hi)
            x = torch.matmul(q[q0:q1], k[k0:k1].T) * sl2
            vt = v[k0:k1].clone()
            if _tile_is_full(live, q0, q1, k0, hi):
                n_full += 1
                lt = torch.ones(q1 - q0, k1 - k0, dtype=torch.bool)
            else:
                n_part += 1
                lt = live[q0:q1, k0:k1]
                bad = ~torch.isfinite(vt).all(1)
                if guard and bad.any():
                    vt[bad] = 0.0
                    nan_row |= (lt & bad[None, :]).any(1)
            m_new = torch.maximum(m, torch.where(lt, x, -torch.inf).amax(1))
            alpha = torch.exp2(m - m_new)
            p = torch.where(lt, torch.exp2(x - m_new[:, None]), 0.0)
            l = l * alpha + p.sum(1)
            hi_p = _bf16(p)
            parts = (hi_p, _bf16(p - hi_p)) if split else (hi_p,)
            acc = acc * alpha[:, None] + sum(torch.matmul(a, vt)
                                             for a in parts)
            m = m_new
        lc = l.clamp_min(1e-30)
        out = acc / lc[:, None]
        out[nan_row] = float("nan")
        o[q0:q1] = _bf16(out)
        lse[q0:q1] = (m + torch.log2(lc)) * LN2
        if keyless_rule:
            lse[q0:q1] = torch.where(m == -1e30, m + torch.log(lc),
                                     lse[q0:q1])
    return o, lse, n_full, n_part


def _fwd_ratio(out, ref):
    """The largest ratio of an element's error to chip_smoke.py's bf16
    rule for o, 2^-7 |ref| + 1e-4."""
    return ((out - ref).abs() / (2.0 ** -7 * ref.abs() + 1e-4)).max().item()


def _varlen_emulation(q, k, v, sq, pq, sk, pk, causal, **kw):
    """The emulation over the heads of [T, H, D] q, k, v -> (o [T, H, D],
    lse [H, T], wholly live tiles, other tiles)."""
    live = _live(sq, pq, sk, pk, causal)
    ranges = varlen_tile_ranges(sq, pq, sk, pk, WG, causal, True).tolist()
    outs = [_masked_wgmma_emulation(q[:, i], k[:, i], v[:, i], live, ranges,
                                    SCALE_W, **kw)
            for i in range(q.shape[1])]
    return (torch.stack([x[0] for x in outs], 1),
            torch.stack([x[1] for x in outs]),
            sum(x[2] for x in outs), sum(x[3] for x in outs))


D_W = 128
SCALE_W = float(1.0 / np.sqrt(D_W))


def _bf16_case(pack, seed):
    """bf16-valued float32 q, k, v [T, 2, 128] of a WGMMA_PACKS pack, with
    both sides' segments."""
    lq, lk = WGMMA_PACKS[pack]
    lk = lq if lk is None else lk
    cu_q, cu_k = _cu(lq), _cu(lk)
    rng = np.random.default_rng(seed)
    q, k, v = (_bf16(torch.from_numpy(rng.standard_normal((n, H, D_W))
                                      .astype(np.float32)))
               for n in (int(cu_q[-1]), int(cu_k[-1]), int(cu_k[-1])))
    return q, k, v, cu_q, cu_k


@pytest.mark.parametrize("pack", sorted(WGMMA_PACKS))
@pytest.mark.parametrize("causal", [True, False])
def test_wgmma_arithmetic_matches_jax_kernel(pack, causal):
    """The emulation against JAX's _varlen_fwd in interpret mode: o within
    2^-7 |ref| + 1e-4 of JAX's o rounded to bf16, lse within 1e-4, keyless
    rows 0 with lse KEYLESS_LSE, and both kinds of tile met. p rounded
    once to bf16 misses the rule for o."""
    q, k, v, cu_q, cu_k = _bf16_case(pack, 20 + causal)
    tq, tk = q.shape[0], k.shape[0]
    jsq, jpq = _jax_segs(cu_q, tq)
    jsk, jpk = _jax_segs(cu_k, tk)
    jo, jlse = _varlen_fwd(*(jnp.asarray(a.numpy()).swapaxes(0, 1)
                             for a in (q, k, v)), jsq, jpq, jsk, jpk, causal,
                           SCALE_W, False)
    ref = _bf16(_t(np.asarray(jo).swapaxes(0, 1)))
    rlse = _t(jlse)
    segs = (*_torch_segs(cu_q, tq), *_torch_segs(cu_k, tk))
    o, lse, n_full, n_part = _varlen_emulation(q, k, v, *segs, causal)
    assert n_full > 0 and n_part > 0
    ratio = _fwd_ratio(o, ref)
    assert ratio <= 1.0, f"o: {ratio} x the bf16 rule"
    assert (lse - rlse).abs().max().item() <= 1e-4
    lq, lk = WGMMA_PACKS[pack]
    if lk is not None:
        rows = slice(int(cu_q[1]), int(cu_q[2]))     # the keyless document
        assert not o[rows].any() and (lse[:, rows] == KEYLESS_LSE).all()
    once = _varlen_emulation(q, k, v, *segs, causal, split=False)[0]
    assert _fwd_ratio(once, ref) > 1.0


def test_wgmma_keyless_rows_need_the_natural_log_rule():
    """In the exp2 domain a keyless row's (-1e30 + log2 1e-30) ln 2 is
    -6.9e29, far outside 1e-4 of the kernels' -1e30 + log(1e-30)."""
    q, k, v, cu_q, cu_k = _bf16_case("unequal_keyless", 23)
    segs = (*_torch_segs(cu_q, q.shape[0]), *_torch_segs(cu_k, k.shape[0]))
    _, lse, _, _ = _varlen_emulation(q, k, v, *segs, False,
                                     keyless_rule=False)
    rows = slice(int(cu_q[1]), int(cu_q[2]))
    assert (lse[:, rows] - KEYLESS_LSE).abs().min().item() > 1e28


@pytest.mark.parametrize("causal", [True, False])
def test_wgmma_nan_guard_keeps_documents_apart(causal):
    """NaN in one document's K and V: with the guard every other
    document's o is bit-equal to the clean run's and the poisoned
    document's rows are NaN; without it (p = 0 times NaN on the tensor
    cores) the NaN reaches the other documents sharing its q tiles."""
    q, k, v, cu_q, _ = _bf16_case("same_pack", 24 + causal)
    segs = (*_torch_segs(cu_q, q.shape[0]),) * 2
    clean = _varlen_emulation(q, k, v, *segs, causal)[0]
    a, b = int(cu_q[2]), int(cu_q[3])             # the third document
    kp, vp = k.clone(), v.clone()
    kp[a:b] = float("nan")
    vp[a:b] = float("nan")
    keep = torch.ones(q.shape[0], dtype=torch.bool)
    keep[a:b] = False
    guarded = _varlen_emulation(q, kp, vp, *segs, causal)[0]
    assert torch.isfinite(guarded[keep]).all()
    assert torch.equal(guarded[keep], clean[keep])
    assert torch.isnan(guarded[~keep]).all()
    unguarded = _varlen_emulation(q, kp, vp, *segs, causal, guard=False)[0]
    assert torch.isnan(unguarded[keep]).any()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seed", range(4))
def test_wholly_live_rule_is_exact(causal, seed):
    """Brute force over random packs (empty documents, unequal packs,
    totals no tile divides): the kernel's rule from the first and last
    rows says a tile is wholly live iff every pair in it is live."""
    rng = np.random.default_rng(40 + seed)
    n = int(rng.integers(3, 10))
    lq = rng.integers(0, 200, n)
    lk = lq if seed % 2 == 0 else rng.integers(0, 200, n)
    cu_q, cu_k = _cu(lq), _cu(lk)
    tq, tk = int(cu_q[-1]), int(cu_k[-1])
    sq, pq = _torch_segs(cu_q, tq)
    sk, pk = _torch_segs(cu_k, tk)
    live = _live(sq, pq, sk, pk, causal)
    ranges = varlen_tile_ranges(sq, pq, sk, pk, WG, causal, True).tolist()
    seen = set()
    for t, (lo, hi) in enumerate(ranges):
        q0, q1 = t * WG, min(t * WG + WG, tq)
        for k0 in range(lo, hi, WG):
            full = _tile_is_full(live, q0, q1, k0, hi)
            brute = k0 + WG <= hi and bool(live[q0:q1, k0:k0 + WG].all())
            assert full == brute
            seen.add(full)
    assert seen == {True, False} or tq < 2 * WG


@pytest.mark.parametrize("dtype,d,ptrs,strides,route", [
    (torch.bfloat16, 64, (0, 16, 32), (128, 64), "wgmma"),
    (torch.bfloat16, 128, (0, 256, 512), (384, 128), "wgmma"),   # qkv pack
    (torch.bfloat16, 256, (0, 0, 0), (256, 256), "cuda_core"),
    (torch.bfloat16, 128, (0, 8, 0), (128, 128), "cuda_core"),
    (torch.bfloat16, 128, (0, 0, 0), (396, 132), "cuda_core"),
    (torch.bfloat16, 64, (0, 0, 0), (68, 64), "cuda_core"),
    (torch.float32, 64, (0, 0, 0), (64, 64), "cuda_core"),
    (torch.float32, 128, (0, 0, 0), (128, 128), "cuda_core"),
])
def test_masked_fwd_route(dtype, d, ptrs, strides, route):
    """The tensor cores take bf16 at D 64 and 128 with q, k and v 16-byte
    aligned and every stride a multiple of 8 elements (a packed [T, 3, H,
    D] qkv's row stride 3 H D included); float32, D 256, a misaligned
    pointer or a stride off the 8-element grid keep the CUDA cores."""
    assert masked_fwd_route(dtype, d, ptrs, strides) == route



# -- the tensor-core backward's arithmetic -------------------------------------

def _masked_wgmma_bwd_emulation(q, k, v, o, lse, do, live, q_ranges,
                                k_ranges, scale, dead=None, split=True,
                                guard=True):
    """The tensor-core masked backward's arithmetic, one head, on float32
    tensors that hold bf16 values: q, o, do [Sq, D], k, v [Sk, D], lse
    [Sq] float32, live [Sq, Sk] bool, q_ranges[t] the keys [lo, hi) of q
    tile t, k_ranges[t] the q rows [lo, hi) of the 64-key tile t, dead(t,
    k0) True for a key tile the policy skips. delta = rowsum(do o); p =
    exp2((q k^T) (scale log2e) - lse log2e), ds = p (dp - delta) scale,
    both replaced by 0 where a pair is masked unless the tile is wholly
    live. The dq pass: per q tile, key tiles of 64 from lo, dq += ds k; on
    a tile that is not wholly live (guard) K's non-finite rows are zeroed
    first and every row with a live pair on one ends NaN. The dk/dv pass:
    per 64-key tile, row tiles of 64 from lo, dv += p^T do and dk += ds^T
    q; on a tile that is not wholly live a row non-finite in q or do is
    zeroed in both and every key with a live pair on it ends NaN. P and dS
    enter their products as hi + lo (or, split False, rounded once).
    Returns (dq, dk, dv) rounded to bf16."""
    sq, d = q.shape
    sk = k.shape[0]
    sl2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    l2 = lse * torch.tensor(LOG2E, dtype=torch.float32)
    delta = (do * o).sum(1)

    def parts(x):
        hi_ = _bf16(x)
        return (hi_, _bf16(x - hi_)) if split else (hi_,)

    def select(full, lt, x):
        return x if full else torch.where(lt, x, 0.0)

    dq = torch.zeros(sq, d)
    nan_q = torch.zeros(sq, dtype=torch.bool)
    for t, (lo, hi) in enumerate(q_ranges):
        q0, q1 = t * WG, min(t * WG + WG, sq)
        for k0 in range(lo, hi, WG):
            if dead is not None and dead(t, k0):
                continue
            k1 = min(k0 + WG, hi)
            kt = k[k0:k1].clone()
            lt = live[q0:q1, k0:k1]
            full = _tile_is_full(live, q0, q1, k0, hi)
            if guard and not full:
                bad = ~torch.isfinite(kt).all(1)
                kt[bad] = 0.0
                nan_q[q0:q1] |= (lt & bad[None, :]).any(1)
            p = torch.exp2(torch.matmul(q[q0:q1], kt.T) * sl2
                           - l2[q0:q1, None])
            dp = torch.matmul(do[q0:q1], v[k0:k1].T)
            ds = select(full, lt, p * (dp - delta[q0:q1, None]) * scale)
            dq[q0:q1] += sum(torch.matmul(a, kt) for a in parts(ds))
    dq[nan_q] = float("nan")

    dk, dv = torch.zeros(sk, d), torch.zeros(sk, d)
    nan_k = torch.zeros(sk, dtype=torch.bool)
    for t, (lo, hi) in enumerate(k_ranges):
        k0, k1 = t * WG, min(t * WG + WG, sk)
        for r0 in range(lo, hi, WG):
            r1 = min(r0 + WG, hi)
            qt, dot = q[r0:r1].clone(), do[r0:r1].clone()
            lt = live[r0:r1, k0:k1].T                   # [keys, rows]
            full = _tile_is_full(live, r0, r1, k0, sk)
            if guard and not full:
                bad = ~(torch.isfinite(qt).all(1)
                        & torch.isfinite(dot).all(1))
                qt[bad] = 0.0
                dot[bad] = 0.0
                nan_k[k0:k1] |= (lt & bad[None, :]).any(1)
            p = torch.exp2(torch.matmul(k[k0:k1], qt.T) * sl2
                           - l2[None, r0:r1])
            dpt = torch.matmul(v[k0:k1], dot.T)
            ds = select(full, lt, p * (dpt - delta[None, r0:r1]) * scale)
            p = select(full, lt, p)
            dv[k0:k1] += sum(torch.matmul(a, dot) for a in parts(p))
            dk[k0:k1] += sum(torch.matmul(a, qt) for a in parts(ds))
    dk[nan_k] = float("nan")
    dv[nan_k] = float("nan")
    return _bf16(dq), _bf16(dk), _bf16(dv)


def _bwd_ratio(out, ref):
    """The largest ratio of an element's error to chip_smoke.py's bf16
    gradient rule, 2^-7 |ref| + 1e-3 max|ref|."""
    lim = 2.0 ** -7 * ref.abs() + 1e-3 * ref.abs().max()
    return ((out - ref).abs() / lim).max().item()


def _varlen_bwd_emulation(q, k, v, o, lse, do, sq, pq, sk, pk, causal,
                          scale, **kw):
    """The backward emulation over the heads of [T, H, D] q, k, v, o, do
    and lse [H, T] -> (dq, dk, dv) [T, H, D]."""
    live = _live(sq, pq, sk, pk, causal)
    rq = varlen_tile_ranges(sq, pq, sk, pk, WG, causal, True).tolist()
    rk = varlen_tile_ranges(sk, pk, sq, pq, WG, causal, False).tolist()
    outs = [_masked_wgmma_bwd_emulation(
        q[:, i], k[:, i], v[:, i], o[:, i], lse[i], do[:, i], live, rq, rk,
        scale, **kw) for i in range(q.shape[1])]
    return [torch.stack([x[j] for x in outs], 1) for j in range(3)]


def _bf16_bwd_case(pack, seed, d):
    """bf16-valued float32 q, k, v and dO [T, 2, d] of a WGMMA_PACKS pack,
    JAX's forward o (rounded to bf16, as the card forward writes it) and
    lse, JAX's gradients from _varlen_bwd (interpret mode) rounded to
    bf16, and both sides' segments."""
    lq, lk = WGMMA_PACKS[pack]
    lk = lq if lk is None else lk
    cu_q, cu_k = _cu(lq), _cu(lk)
    tq, tk = int(cu_q[-1]), int(cu_k[-1])
    rng = np.random.default_rng(seed)
    q, k, v, do = (_bf16(torch.from_numpy(rng.standard_normal((n, H, d))
                                          .astype(np.float32)))
                   for n in (tq, tk, tk, tq))
    return q, k, v, do, cu_q, cu_k


def _jax_bwd(q, k, v, do, cu_q, cu_k, causal, scale):
    tq, tk = q.shape[0], k.shape[0]
    jsq, jpq = _jax_segs(cu_q, tq)
    jsk, jpk = _jax_segs(cu_k, tk)
    jq, jk, jv, jdo = (jnp.asarray(a.numpy()).swapaxes(0, 1)
                       for a in (q, k, v, do))
    jo, jlse = _varlen_fwd(jq, jk, jv, jsq, jpq, jsk, jpk, causal, scale,
                           False)
    o = _bf16(_t(np.asarray(jo)))                        # [H, T, D]
    ref = _varlen_bwd(jq, jk, jv, jnp.asarray(o.numpy()), jlse, jdo, jsq,
                      jpq, jsk, jpk, causal, scale, False)
    return (o.transpose(0, 1), _t(jlse),
            [_bf16(_t(np.asarray(r).swapaxes(0, 1))) for r in ref])


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("pack", sorted(WGMMA_PACKS))
@pytest.mark.parametrize("causal", [True, False])
def test_wgmma_bwd_arithmetic_matches_jax_kernel(pack, causal, d):
    """The backward emulation against JAX's _varlen_bwd in interpret mode
    on the same o (bf16) and lse: dq, dk and dv within 2^-7 |ref| + 1e-3
    max|ref| of JAX's gradients rounded to bf16 (0.44-0.76 of it at these
    seeds), keyless rows' dq 0. P and dS rounded once to bf16 miss that
    rule on at least one gradient (1.10-3.24 of it)."""
    scale = float(1.0 / np.sqrt(d))
    q, k, v, do, cu_q, cu_k = _bf16_bwd_case(pack, 60 + causal + d, d)
    o, lse, ref = _jax_bwd(q, k, v, do, cu_q, cu_k, causal, scale)
    segs = (*_torch_segs(cu_q, q.shape[0]), *_torch_segs(cu_k, k.shape[0]))
    got = _varlen_bwd_emulation(q, k, v, o, lse, do, *segs, causal, scale)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        ratio = _bwd_ratio(g, r)
        assert ratio <= 1.0, f"{name}: {ratio} x the bf16 rule"
    lq, lk = WGMMA_PACKS[pack]
    if lk is not None:
        assert not got[0][int(cu_q[1]):int(cu_q[2])].any()
    once = _varlen_bwd_emulation(q, k, v, o, lse, do, *segs, causal, scale,
                                 split=False)
    assert max(_bwd_ratio(g, r) for g, r in zip(once, ref)) > 1.0


@pytest.mark.parametrize("where", ["q", "k", "v", "do"])
def test_wgmma_bwd_nan_guard_keeps_documents_apart(where):
    """NaN in the third document's q, k, v or dO (its rows share q and key
    tiles with the second and fourth), causal: with the guard every other
    document's dq, dk and dv are bit-equal to the clean run's. Without it
    the NaN reaches them through the products whose B operand holds the
    poisoned rows (0 times NaN): K in dq, Q and dO in dk/dv. V enters only
    dP, whose masked pairs are replaced, so it leaks neither way."""
    q, k, v, do, cu_q, _ = _bf16_bwd_case("same_pack", 70, D_W)
    segs = (*_torch_segs(cu_q, q.shape[0]),) * 2
    o = _varlen_emulation(q, k, v, *segs, True)[0]
    lse = _varlen_emulation(q, k, v, *segs, True)[1]
    clean = _varlen_bwd_emulation(q, k, v, o, lse, do, *segs, True,
                                  SCALE_W)
    a, b = int(cu_q[2]), int(cu_q[3])
    xs = {"q": q.clone(), "k": k.clone(), "v": v.clone(), "do": do.clone()}
    xs[where][a:b] = float("nan")
    keep = torch.ones(q.shape[0], dtype=torch.bool)
    keep[a:b] = False
    args = (xs["q"], xs["k"], xs["v"], o, lse, xs["do"], *segs, True,
            SCALE_W)
    guarded = _varlen_bwd_emulation(*args)
    for g, c in zip(guarded, clean):
        assert torch.isfinite(g[keep]).all()
        assert torch.equal(g[keep], c[keep])
    unguarded = _varlen_bwd_emulation(*args, guard=False)
    leaked = any(torch.isnan(g[keep]).any() for g in unguarded)
    assert leaked == (where != "v")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seed", range(4))
def test_wholly_live_rule_is_exact_for_k_tiles(causal, seed):
    """The dk/dv side of the rule, by brute force over random packs: a
    64-key tile and a 64-row tile of its row range are wholly live (every
    key below the total and live for the row tile's first and last rows)
    iff every pair in them is live."""
    rng = np.random.default_rng(50 + seed)
    n = int(rng.integers(3, 10))
    lq = rng.integers(0, 200, n)
    lk = lq if seed % 2 == 0 else rng.integers(0, 200, n)
    cu_q, cu_k = _cu(lq), _cu(lk)
    tq, tk = int(cu_q[-1]), int(cu_k[-1])
    sq, pq = _torch_segs(cu_q, tq)
    sk, pk = _torch_segs(cu_k, tk)
    live = _live(sq, pq, sk, pk, causal)
    ranges = varlen_tile_ranges(sk, pk, sq, pq, WG, causal, False).tolist()
    seen = set()
    for t, (lo, hi) in enumerate(ranges):
        k0 = t * WG
        for r0 in range(lo, hi, WG):
            r1 = min(r0 + WG, hi)
            full = _tile_is_full(live, r0, r1, k0, tk)
            brute = k0 + WG <= tk and bool(live[r0:r1, k0:k0 + WG].all())
            assert full == brute
            seen.add(full)
    if seed % 2 == 0:                   # one pack: both kinds of tile met
        assert seen == {True, False}


@pytest.mark.parametrize("dtype,d,ptrs,strides,route", [
    (torch.bfloat16, 64, (0, 16, 32, 48), (128, 64, 128, 64), "wgmma"),
    # a dO read in place from a wider tensor: row stride 2 H D
    (torch.bfloat16, 128, (0, 256, 512, 4096), (384, 128, 512, 128),
     "wgmma"),
    (torch.bfloat16, 128, (0, 0, 0, 8), (128, 128, 128, 128), "cuda_core"),
    (torch.bfloat16, 128, (0, 0, 0, 0), (128, 128, 132, 128), "cuda_core"),
    (torch.bfloat16, 64, (0, 0, 0, 0), (64, 64, 64, 68), "cuda_core"),
    (torch.bfloat16, 256, (0, 0, 0, 0), (256, 256, 256, 256), "cuda_core"),
    (torch.float32, 64, (0, 0, 0, 0), (64, 64, 64, 64), "cuda_core"),
    (torch.float32, 128, (0, 0, 0, 0), (128, 128, 128, 128), "cuda_core"),
])
def test_masked_bwd_route(dtype, d, ptrs, strides, route):
    """The backward's rule is the forward's over q, k, v and dO: bf16 at
    D 64 and 128 with all four 16-byte aligned and every stride (dO's
    included) a multiple of 8 elements; a misaligned dO or one whose
    stride is off the grid keeps the CUDA-core pair, as do float32 and D
    256."""
    assert masked_bwd_route is masked_fwd_route
    assert masked_bwd_route(dtype, d, ptrs, strides) == route
