"""The port's FlashMask attention (per-column start rows) against the JAX
package.

On the CPU the port's wrappers run their plain PyTorch versions (in chunks
of B*H) and the JAX side runs its Pallas kernels (``_sm_fwd``,
``_sm_bwd``, ``flash_sparse_mask_attention``) in interpret mode, as
tests/test_varlen_flash.py does. Both get the same numpy arrays in
float32, at B 2, S 256, H 2, D 64. o and lse are held to 1e-5 and
gradients to 1e-4 of each one's largest magnitude: the sides differ in
summation order only.

The card's tensor-core forward (bf16 at D 64 and 128) is emulated by
tests/test_torch_flash_varlen.py's ``_masked_wgmma_emulation`` under this
policy (key tiles of 64 from column 0 up to the diagonal when causal,
a tile skipped when both of its 32-column tile maxima are at or before
the q tile's first row) and held here to ``_sm_fwd`` in interpret mode by
the same bf16 rule, 2^-7 |ref| + 1e-4 for o and 1e-4 for the lse. The
tensor-core backward is emulated by the same file's
``_masked_wgmma_bwd_emulation`` under this policy (the dq pass over the
forward's key tiles; the dk/dv pass over 64-row tiles from the k tile's
diagonal, or 0, up to its largest start) and held to ``_sm_bwd`` by
chip_smoke.py's bf16 gradient rule, 2^-7 |ref| + 1e-3 max|ref|.

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
from test_torch_flash_varlen import (
    KEYLESS_LSE, WG, _bf16, _bwd_ratio, _fwd_ratio,
    _masked_wgmma_bwd_emulation, _masked_wgmma_emulation, _tile_is_full)

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
    routed = (dict(flash_sparse_mask_fwd.route_launches),
              dict(flash_sparse_mask_bwd.route_launches))
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
    assert (flash_sparse_mask_fwd.route_launches,
            flash_sparse_mask_bwd.route_launches) == routed
    assert sparse_mask_supported(1000, 128)
    assert not sparse_mask_supported(1024, 96)


# -- the tensor-core forward's arithmetic --------------------------------------

def _sm_live(start, causal):
    """start int32 [S] of one head -> live [S(rows), S(cols)]."""
    s = start.shape[0]
    rows = torch.arange(s)[:, None]
    live = rows < start[None, :]
    if causal:
        live &= rows >= torch.arange(s)[None, :]
    return live


def _sm_emulation(q, k, v, start, causal, scale, **kw):
    """The emulation over the B*H heads of [B, S, H, D] q, k, v with start
    rows [B*H, S]: key ranges [0, min(q1, S)) causal, [0, S) otherwise, a
    64-key tile dead when both of its 32-column tile maxima are at or
    before the q tile's first row. -> (o [B, S, H, D], lse [B*H, S],
    wholly live tiles, other tiles)."""
    b, s, h, d = q.shape
    tm = tile_max(start)
    outs = []
    for i in range(b * h):
        ranges = [(0, min(q0 + WG, s) if causal else s)
                  for q0 in range(0, s, WG)]

        def dead(t, k0, i=i):
            parts = tm[i, k0 // TILE:(k0 + WG) // TILE]
            return bool((t * WG >= parts).all())

        outs.append(_masked_wgmma_emulation(
            q[i // h, :, i % h], k[i // h, :, i % h], v[i // h, :, i % h],
            _sm_live(start[i], causal), ranges, scale, dead=dead, **kw))
    o = torch.stack([x[0] for x in outs]).reshape(b, h, s, d).transpose(1, 2)
    return (o, torch.stack([x[1] for x in outs]), sum(x[2] for x in outs),
            sum(x[3] for x in outs))


D_W = 128
SCALE_W = float(1.0 / np.sqrt(D_W))


def _bf16_arrays(seed, d=D_W):
    rng = np.random.default_rng(seed)
    return [_bf16(torch.from_numpy(rng.standard_normal((B, S, H, d))
                                   .astype(np.float32))) for _ in range(3)]


@pytest.mark.parametrize("kind", START_KINDS + ("capped",))
@pytest.mark.parametrize("causal", [True, False])
def test_wgmma_arithmetic_matches_jax_kernel(kind, causal):
    """The emulation against JAX's _sm_fwd in interpret mode: o within
    2^-7 |ref| + 1e-4 of JAX's o rounded to bf16, lse within 1e-4, rows
    that see no column 0 with lse KEYLESS_LSE ("capped": start rows of at
    most 100, so without causal rows from 100 on are keyless). p rounded
    once to bf16 misses the rule for o."""
    q, k, v = _bf16_arrays(30 + causal)
    start = _start("random" if kind == "capped" else kind, 30 + causal)
    if kind == "capped":
        start = np.minimum(start, 100)
    start = start.reshape(B * H, S).astype(np.int32)
    jo, jlse = _sm_fwd(*(_bh(a.numpy()) for a in (q, k, v)),
                       jnp.asarray(start), causal, SCALE_W)
    ref = _bf16(_t(_from_bh(jo)))
    rlse = _t(jlse)
    o, lse, n_full, n_part = _sm_emulation(q, k, v, _t(start), causal,
                                           SCALE_W)
    assert n_part > 0
    if kind == "documents" and not causal:
        assert n_full > 0                  # the documents' own tiles
    ratio = _fwd_ratio(o, ref)
    assert ratio <= 1.0, f"o: {ratio} x the bf16 rule"
    assert (lse - rlse).abs().max().item() <= 1e-4
    if kind == "capped" and not causal:
        assert not o[:, 100:].any() and (lse[:, 100:] == KEYLESS_LSE).all()
    once = _sm_emulation(q, k, v, _t(start), causal, SCALE_W,
                         split=False)[0]
    assert _fwd_ratio(once, ref) > 1.0


def test_wgmma_nan_guard_keeps_documents_apart():
    """NaN in the second document's K and V (columns 100:137, which share
    q and key tiles with the first and third): with the guard every other
    row's o is bit-equal to the clean run's; without it the NaN spreads."""
    q, k, v = _bf16_arrays(33)
    start = _t(_start("documents", 0).reshape(B * H, S))
    clean = _sm_emulation(q, k, v, start, True, SCALE_W)[0]
    kp, vp = k.clone(), v.clone()
    kp[:, 100:137] = float("nan")
    vp[:, 100:137] = float("nan")
    keep = torch.ones(S, dtype=torch.bool)
    keep[100:137] = False
    guarded = _sm_emulation(q, kp, vp, start, True, SCALE_W)[0]
    assert torch.isfinite(guarded[:, keep]).all()
    assert torch.equal(guarded[:, keep], clean[:, keep])
    unguarded = _sm_emulation(q, kp, vp, start, True, SCALE_W,
                              guard=False)[0]
    assert torch.isnan(unguarded[:, keep]).any()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", START_KINDS)
@pytest.mark.parametrize("s", [256, 200])
def test_wholly_live_rule_and_dead_tiles_are_exact(causal, kind, s):
    """Brute force: the first-and-last-row rule says a 64-key tile is
    wholly live iff every pair in it is; a tile the tile maxima call dead
    holds no live pair."""
    if kind == "random":
        start = _random_start(34, s).reshape(B * H, s)
    else:
        doc = _doc_start([60, 37, s - 97])
        start = np.broadcast_to(doc, (B * H, s)).copy()
    tm = tile_max(_t(start))
    for i in range(B * H):
        live = _sm_live(_t(start[i]), causal)
        for q0 in range(0, s, WG):
            q1, hi = min(q0 + WG, s), min(q0 + WG, s) if causal else s
            for k0 in range(0, hi, WG):
                brute = k0 + WG <= hi and bool(live[q0:q1,
                                                    k0:k0 + WG].all())
                assert _tile_is_full(live, q0, q1, k0, hi) == brute
                if bool((q0 >= tm[i, k0 // TILE:(k0 + WG) // TILE]).all()):
                    assert not live[q0:q1, k0:k0 + WG].any()



# -- the tensor-core backward's arithmetic -------------------------------------

def _sm_k_ranges(tm, s, causal):
    """The dk/dv kernel's q-row range of each 64-key tile of one head:
    from the tile's first key (causal) or 0 to its largest start."""
    out = []
    for k0 in range(0, s, WG):
        k1 = min(k0 + WG, s)
        top = int(tm[k0 // TILE:-(-k1 // TILE)].max())
        out.append((k0 if causal else 0, min(top, s)))
    return out


def _sm_bwd_emulation(q, k, v, o, lse, do, start, causal, scale, **kw):
    """The backward emulation over the B*H heads of [B, S, H, D] q, k, v,
    o, do with lse and start rows [B*H, S]: the forward's key ranges and
    dead tiles for dq, _sm_k_ranges for dk/dv -> (dq, dk, dv) [B, S, H,
    D]."""
    b, s, h, d = q.shape
    tm = tile_max(start)
    outs = []
    for i in range(b * h):
        q_ranges = [(0, min(q0 + WG, s) if causal else s)
                    for q0 in range(0, s, WG)]

        def dead(t, k0, i=i):
            parts = tm[i, k0 // TILE:(k0 + WG) // TILE]
            return bool((t * WG >= parts).all())

        x = [a[i // h, :, i % h] for a in (q, k, v, o)]
        outs.append(_masked_wgmma_bwd_emulation(
            *x, lse[i], do[i // h, :, i % h], _sm_live(start[i], causal),
            q_ranges, _sm_k_ranges(tm[i], s, causal), scale, dead=dead,
            **kw))
    return [torch.stack([x[j] for x in outs]).reshape(b, h, s, d)
            .transpose(1, 2) for j in range(3)]


BWD_HEADS = 4          # as the dense backward's emulation test


def _bwd_case(kind, seed, d):
    """bf16-valued float32 q, k, v and dO [B, S, 4, d] and start rows
    [B*4, S] of a START_KINDS kind or "capped" (random, at most 100)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (_bf16(torch.from_numpy(a)) for a in rng.standard_normal(
        (4, B, S, BWD_HEADS, d)).astype(np.float32))
    if kind == "documents":
        start = np.broadcast_to(_doc_start([100, 37, 119]),
                                (B * BWD_HEADS, S))
    else:
        start = rng.integers(1, S + 1, (B * BWD_HEADS, S))
        if kind == "capped":
            start = np.minimum(start, 100)
    return q, k, v, do, np.ascontiguousarray(start, dtype=np.int32)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kind", START_KINDS + ("capped",))
@pytest.mark.parametrize("causal", [True, False])
def test_wgmma_bwd_arithmetic_matches_jax_kernel(kind, causal, d):
    """The backward emulation against JAX's _sm_bwd in interpret mode on
    the same o (JAX's, rounded to bf16) and lse, at 4 heads: dq, dk and dv
    within 2^-7 |ref| + 1e-3 max|ref| of JAX's gradients rounded to bf16
    (0.48-0.71 of it at these seeds); rows that see no column ("capped"
    without causal) get dq 0. P and dS rounded once to bf16 miss that rule
    on at least one gradient (1.04-1.83 of it at these seeds)."""
    q, k, v, do, start = _bwd_case(kind, 80 + causal + d, d)
    scale = float(1.0 / np.sqrt(d))
    js = jnp.asarray(start)
    jq, jk, jv, jdo = (_bh(a.numpy()) for a in (q, k, v, do))
    jo, jlse = _sm_fwd(jq, jk, jv, js, causal, scale)
    o = _bf16(_t(np.asarray(jo)))
    ref = [_bf16(_t(_from_bh(r, B, BWD_HEADS))) for r in
           _sm_bwd(jq, jk, jv, jnp.asarray(o.numpy()), jlse, jdo, js,
                   causal, scale)]
    o = _t(_from_bh(o.numpy(), B, BWD_HEADS))
    lse = _t(jlse)
    got = _sm_bwd_emulation(q, k, v, o, lse, do, _t(start), causal, scale)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        ratio = _bwd_ratio(g, r)
        assert ratio <= 1.0, f"{name}: {ratio} x the bf16 rule"
    if kind == "capped" and not causal:
        assert not got[0][:, 100:].any()
    once = _sm_bwd_emulation(q, k, v, o, lse, do, _t(start), causal, scale,
                             split=False)
    assert max(_bwd_ratio(g, r) for g, r in zip(once, ref)) > 1.0


@pytest.mark.parametrize("where", ["q", "k", "v", "do"])
def test_wgmma_bwd_nan_guard_keeps_documents_apart(where):
    """NaN in the second document's rows (100:137, sharing q and key tiles
    with the first and third) of q, k, v or dO, causal: with the guard
    every other row's dq, dk and dv are bit-equal to the clean run's;
    without it q, k and dO leak (0 times NaN in a product's B operand), V
    does not (it enters only dP, whose masked pairs are replaced)."""
    q, k, v = _bf16_arrays(90)
    do = _bf16_arrays(91)[0]
    start = _t(_start("documents", 0).reshape(B * H, S))
    o, lse = _sm_emulation(q, k, v, start, True, SCALE_W)[:2]
    clean = _sm_bwd_emulation(q, k, v, o, lse, do, start, True, SCALE_W)
    xs = {"q": q.clone(), "k": k.clone(), "v": v.clone(), "do": do.clone()}
    xs[where][:, 100:137] = float("nan")
    keep = torch.ones(S, dtype=torch.bool)
    keep[100:137] = False
    args = (xs["q"], xs["k"], xs["v"], o, lse, xs["do"], start, True,
            SCALE_W)
    guarded = _sm_bwd_emulation(*args)
    for g, c in zip(guarded, clean):
        assert torch.isfinite(g[:, keep]).all()
        assert torch.equal(g[:, keep], c[:, keep])
    unguarded = _sm_bwd_emulation(*args, guard=False)
    leaked = any(torch.isnan(g[:, keep]).any() for g in unguarded)
    assert leaked == (where != "v")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", START_KINDS)
@pytest.mark.parametrize("s", [256, 200])
def test_wholly_live_rule_is_exact_for_k_tiles(causal, kind, s):
    """The dk/dv side, by brute force: a 64-key tile and a 64-row tile of
    its row range are wholly live (each key below S and live for the row
    tile's first and last rows) iff every pair in them is live; the row
    range holds every live pair of the key tile."""
    if kind == "random":
        start = _random_start(35, s).reshape(B * H, s)
    else:
        doc = _doc_start([60, 37, s - 97])
        start = np.broadcast_to(doc, (B * H, s)).copy()
    tm = tile_max(_t(start))
    for i in range(B * H):
        live = _sm_live(_t(start[i]), causal)
        for t, (lo, hi) in enumerate(_sm_k_ranges(tm[i], s, causal)):
            k0 = t * WG
            rows = torch.nonzero(live[:, k0:k0 + WG].any(1))[:, 0]
            assert rows.numel() == 0 or (lo <= rows.min()
                                         and rows.max() < hi)
            for r0 in range(lo, hi, WG):
                r1 = min(r0 + WG, hi)
                brute = k0 + WG <= s and bool(live[r0:r1,
                                                   k0:k0 + WG].all())
                assert _tile_is_full(live, r0, r1, k0, s) == brute
