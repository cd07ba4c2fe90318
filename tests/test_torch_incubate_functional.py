"""The port's incubate functionals against the JAX package's entry points.

Every ported entry of ``paddle_tpu_torch.incubate.nn.functional`` and
``paddle_tpu_torch.incubate`` gets the same numpy arrays as its JAX
counterpart on the CPU, forward and gradients (through the JAX package's
tape autograd and torch.autograd). On the CPU the JAX entries compute in
jnp (their Pallas routes are for the TPU); the port's kernel routes run
the kernels' plain versions, which compute in float32. So in float32 both
agree to rounding, held to 1e-5 of the largest magnitude (1e-4 for
gradients summed over a row or a product). At bfloat16 the JAX CPU entry
computes RoPE in bf16 (the tables are cast to x's dtype) while the port's
kernel route, like the TPU kernel, computes in float32: that case is held
against ``rope_pallas`` (interpret mode) in tests/test_torch_fused_
elementwise.py, not against the CPU entry.

The last test runs the chip phase's composite (residual RMSNorm, q/k/v
projections, RoPE, causal scores, the masked softmax, the weighted sum of
v) at a tiny width through both packages.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as pt
import paddle_tpu.incubate as jinc
import paddle_tpu.incubate.nn.functional as JF

import paddle_tpu_torch.incubate as tinc
import paddle_tpu_torch.incubate.nn.functional as TF
from paddle_tpu_torch.kernels.fused_elementwise import (causal_softmax_bwd,
                                                        causal_softmax_fwd,
                                                        rope)
from paddle_tpu_torch.kernels.rms_norm import rms_norm_bwd, rms_norm_fwd

ATOL = 1e-5
GRAD_ATOL = 1e-4
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    if hasattr(a, "_data"):
        a = a._data
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, ref, atol=ATOL):
    got, ref = _np(got), _np(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=atol * max(np.abs(ref).max(), 1e-30))


def _pair(a, dtype="float32", grad=True):
    """The same numpy array as a JAX tensor and a torch tensor."""
    j = pt.to_tensor(jnp.asarray(a, _JNP[dtype]), stop_gradient=not grad)
    t = torch.tensor(a, dtype=_TORCH[dtype], requires_grad=grad)
    return j, t


def _backward(jout, tout, g):
    """Seed both sides with the cotangent g (numpy)."""
    (jout * pt.to_tensor(jnp.asarray(g, jout._data.dtype))).sum().backward()
    tout.backward(torch.tensor(g, dtype=tout.dtype))


# -- fused_rms_norm ----------------------------------------------------------------

@pytest.mark.parametrize("h", [256, 96])
@pytest.mark.parametrize("residual,bias", [(False, False), (True, False),
                                           (True, True), (False, True)])
def test_fused_rms_norm_matches_jax(h, residual, bias):
    """h 256 takes the port's kernel route, h 96 the plain one (the JAX
    package routes the same way on its accelerator)."""
    rng = np.random.default_rng(h + 2 * residual + bias)
    x = rng.standard_normal((2, 64, h)).astype(np.float32)
    r = rng.standard_normal((2, 64, h)).astype(np.float32)
    w = (1 + 0.3 * rng.standard_normal(h)).astype(np.float32)
    b = rng.standard_normal(h).astype(np.float32)
    g = rng.standard_normal((2, 64, h)).astype(np.float32)
    jx, tx = _pair(x)
    jw, tw = _pair(w)
    jr, tr = _pair(r) if residual else (None, None)
    jb, tb = _pair(b) if bias else (None, None)
    jres = JF.fused_rms_norm(jx, jw, jb, 1e-5, residual=jr)
    tres = TF.fused_rms_norm(tx, tw, tb, 1e-5, residual=tr)
    if residual:
        (jout, jsum), (tout, tsum) = jres, tres
        _close(tsum, jsum)
    else:
        jout, tout = jres, tres
    _close(tout, jout)
    _backward(jout, tout, g)
    for jt, tt in ((jx, tx), (jw, tw), (jr, tr), (jb, tb)):
        if jt is not None:
            _close(tt.grad, jt.grad, GRAD_ATOL)


def test_fused_rms_norm_bias_promotes_as_jax():
    """bf16 x with a float32 bias: the bias add follows dtype promotion
    (float32) on both sides; the norm itself stays in x's dtype."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 128)).astype(np.float32)
    w = np.ones(128, np.float32)
    b = rng.standard_normal(128).astype(np.float32)
    jout = JF.fused_rms_norm(_pair(x, "bfloat16")[0], _pair(w)[0],
                             _pair(b)[0])
    tout = TF.fused_rms_norm(_pair(x, "bfloat16")[1], _pair(w)[1],
                             _pair(b)[1])
    assert str(jout._data.dtype) == str(tout.dtype).split(".")[-1]
    assert tout.dtype == torch.float32
    _close(tout, jout, 2.0 ** -7)
    plain = TF.fused_rms_norm(_pair(x, "bfloat16")[1], _pair(w)[1])
    assert plain.dtype == torch.bfloat16


def test_begin_norm_axis_other_than_last_raises():
    x = torch.zeros(2, 4, 128)
    w = torch.ones(128)
    for axis in (-1, 2):
        TF.fused_rms_norm(x, w, begin_norm_axis=axis)
        TF.fused_layer_norm(x, w, None, begin_norm_axis=axis)
    for axis in (0, 1, -2):
        with pytest.raises(NotImplementedError, match="begin_norm_axis"):
            TF.fused_rms_norm(x, w, begin_norm_axis=axis)
        with pytest.raises(NotImplementedError, match="begin_norm_axis"):
            TF.fused_layer_norm(x, w, None, begin_norm_axis=axis)


# -- fused_rotary_position_embedding ---------------------------------------------------

def _tables(rng, rows, d, four_d=False):
    cos = rng.standard_normal((rows, d)).astype(np.float32)
    sin = rng.standard_normal((rows, d)).astype(np.float32)
    if four_d:
        return cos[None, :, None, :], sin[None, :, None, :]
    return cos, sin


def _rope_both(q, k, v, tables=None, pos=None, neox=True):
    """Run both entry points on the same arrays; return their outputs and
    the (jax, torch) leaves."""
    leaves = [_pair(a) if a is not None else (None, None) for a in (q, k, v)]
    kw = {"use_neox_rotary_style": neox}
    jkw, tkw = dict(kw), dict(kw)
    if tables is not None:
        cos, sin = tables
        jkw.update(cos=pt.to_tensor(jnp.asarray(cos)),
                   sin=pt.to_tensor(jnp.asarray(sin)))
        tkw.update(cos=torch.tensor(cos), sin=torch.tensor(sin))
    if pos is not None:
        jkw["position_ids"] = pt.to_tensor(jnp.asarray(pos, jnp.int32))
        tkw["position_ids"] = torch.tensor(pos)
    jouts = JF.fused_rotary_position_embedding(*[j for j, _ in leaves],
                                               **jkw)
    touts = TF.fused_rotary_position_embedding(*[t for _, t in leaves],
                                               **tkw)
    return jouts, touts, leaves


def _check_rope(jouts, touts, leaves, rng):
    assert len(touts) == 3
    for jo, to, (jl, tl) in zip(jouts, touts, leaves):
        if jl is None:
            assert to is None and jo is None
            continue
        _close(to, jo)
        _backward(jo, to, rng.standard_normal(tuple(to.shape))
                  .astype(np.float32))
        _close(tl.grad, jl.grad)


@pytest.mark.parametrize("four_d", [False, True])
@pytest.mark.parametrize("with_v", [False, True])
def test_rope_rotate_half_kernel_route_matches_jax(four_d, with_v):
    """Rotate-half on 4-D inputs with D 128, no position_ids: the port's
    kernel route (the JAX package's Pallas route on its accelerator)."""
    b, s, h, d = 2, 128, 2, 128
    rng = np.random.default_rng(10 + four_d + 2 * with_v)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    before = rope.launches
    jouts, touts, leaves = _rope_both(q, k, v if with_v else None,
                                      _tables(rng, s, d, four_d), neox=False)
    _check_rope(jouts, touts, leaves, rng)
    assert rope.launches == before            # the CPU runs the plain version


@pytest.mark.parametrize("neox,d", [(True, 128), (True, 64), (False, 64)])
def test_rope_composed_routes_match_jax(neox, d):
    """Every-two pairing, and rotate-half with D below 128: jnp forms in
    the JAX package, plain torch in the port."""
    b, s, h = 2, 64, 2
    rng = np.random.default_rng(d + neox)
    q, k = (rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(2))
    jouts, touts, leaves = _rope_both(q, k, None, _tables(rng, s, d),
                                      neox=neox)
    _check_rope(jouts, touts, leaves, rng)


@pytest.mark.parametrize("neox", [True, False])
def test_rope_position_ids_match_jax(neox):
    """position_ids gather table rows from a table longer than S."""
    b, s, h, d = 2, 64, 2, 128
    rng = np.random.default_rng(20 + neox)
    q, k = (rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(2))
    pos = rng.integers(0, 3 * s, (b, s)).astype(np.int64)
    jouts, touts, leaves = _rope_both(q, k, None, _tables(rng, 3 * s, d),
                                      pos=pos, neox=neox)
    _check_rope(jouts, touts, leaves, rng)


@pytest.mark.parametrize("neox", [True, False])
@pytest.mark.parametrize("with_pos", [False, True])
def test_rope_default_tables_match_jax(neox, with_pos):
    b, s, h, d = 2, 32, 2, 128
    rng = np.random.default_rng(30 + neox + 2 * with_pos)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    pos = rng.integers(0, 100, (b, s)) if with_pos else None
    jouts, touts, leaves = _rope_both(q, None, None, pos=pos, neox=neox)
    _check_rope(jouts, touts, leaves, rng)


def test_rope_tables_of_the_wrong_length():
    """Without position_ids a table needs S rows (or one, which
    broadcasts): the port raises for any other count, where the JAX jnp
    form fails to broadcast and its TPU kernel would pair rows modulo the
    table. With position_ids an id past the table raises on both sides."""
    b, s, h, d = 2, 32, 2, 128
    rng = np.random.default_rng(40)
    q = torch.tensor(rng.standard_normal((b, s, h, d)).astype(np.float32))
    for neox in (True, False):
        cos, sin = (torch.tensor(t) for t in _tables(rng, 2 * s, d))
        with pytest.raises(ValueError, match="rows for a sequence"):
            TF.fused_rotary_position_embedding(q, sin=sin, cos=cos,
                                               use_neox_rotary_style=neox)
        one = TF.fused_rotary_position_embedding(
            q, sin=sin[:1], cos=cos[:1], use_neox_rotary_style=neox)[0]
        rep = TF.fused_rotary_position_embedding(
            q, sin=sin[:1].expand(s, d), cos=cos[:1].expand(s, d),
            use_neox_rotary_style=neox)[0]
        torch.testing.assert_close(one, rep, rtol=0, atol=0)
    pos = np.full((b, s), 2 * s)
    cos, sin = _tables(rng, 2 * s, d)
    with pytest.raises(ValueError, match="exceeds"):
        TF.fused_rotary_position_embedding(
            q, sin=torch.tensor(sin), cos=torch.tensor(cos),
            position_ids=torch.tensor(pos))
    with pytest.raises(ValueError, match="exceeds"):
        JF.fused_rotary_position_embedding(
            pt.to_tensor(q.numpy()), sin=pt.to_tensor(sin),
            cos=pt.to_tensor(cos), position_ids=pt.to_tensor(pos))


# -- the masked softmaxes ----------------------------------------------------------------

@pytest.mark.parametrize("s", [128, 96])
def test_softmax_mask_fuse_upper_triangle_matches_jax(s):
    """S 128 takes the port's kernel route, S 96 the plain one."""
    rng = np.random.default_rng(s)
    x = (2 * rng.standard_normal((2, 2, s, s))).astype(np.float32)
    g = rng.standard_normal((2, 2, s, s)).astype(np.float32)
    jx, tx = _pair(x)
    before = (causal_softmax_fwd.launches, causal_softmax_bwd.launches)
    jout = jinc.softmax_mask_fuse_upper_triangle(jx)
    tout = tinc.softmax_mask_fuse_upper_triangle(tx)
    _close(tout, jout)
    _backward(jout, tout, g)
    _close(tx.grad, jx.grad)
    assert (causal_softmax_fwd.launches,
            causal_softmax_bwd.launches) == before


def test_softmax_mask_fuse_upper_triangle_bf16_matches_jax():
    """In bf16 both sides take -1e30 above the diagonal, the softmax in
    float32 and one rounding: equal within one bf16 ulp."""
    rng = np.random.default_rng(3)
    x = (2 * rng.standard_normal((2, 128, 128))).astype(np.float32)
    jout = jinc.softmax_mask_fuse_upper_triangle(_pair(x, "bfloat16")[0])
    tout = tinc.softmax_mask_fuse_upper_triangle(_pair(x, "bfloat16")[1])
    assert tout.dtype == torch.bfloat16
    got, ref = _np(tout), _np(jout)
    assert (np.abs(got - ref) <= 2.0 ** -7 * np.abs(ref) + 1e-6).all()


def test_softmax_mask_fuse_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 2, 16, 16)).astype(np.float32)
    m = np.where(rng.random((2, 1, 16, 16)) < 0.3, -1e4, 0.0) \
        .astype(np.float32)
    g = rng.standard_normal((2, 2, 16, 16)).astype(np.float32)
    jx, tx = _pair(x)
    jout = jinc.softmax_mask_fuse(jx, pt.to_tensor(m))
    tout = tinc.softmax_mask_fuse(tx, torch.tensor(m))
    _close(tout, jout)
    _backward(jout, tout, g)
    _close(tx.grad, jx.grad)


# -- the jnp siblings ---------------------------------------------------------------------

@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("affine", [True, False])
def test_fused_layer_norm_matches_jax(residual, affine):
    rng = np.random.default_rng(5 + residual + 2 * affine)
    x, r, g = (rng.standard_normal((3, 8, 48)).astype(np.float32)
               for _ in range(3))
    w = (1 + 0.2 * rng.standard_normal(48)).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    jx, tx = _pair(x)
    jr, tr = _pair(r) if residual else (None, None)
    jw, tw = _pair(w) if affine else (None, None)
    jb, tb = _pair(b) if affine else (None, None)
    jres = JF.fused_layer_norm(jx, jw, jb, 1e-5, residual=jr)
    tres = TF.fused_layer_norm(tx, tw, tb, 1e-5, residual=tr)
    if residual:
        (jout, jsum), (tout, tsum) = jres, tres
        _close(tsum, jsum)
    else:
        jout, tout = jres, tres
    _close(tout, jout)
    _backward(jout, tout, g)
    for jt, tt in ((jx, tx), (jr, tr), (jw, tw), (jb, tb)):
        if jt is not None:
            _close(tt.grad, jt.grad, GRAD_ATOL)


@pytest.mark.parametrize("split", [False, True])
def test_swiglu_matches_jax(split):
    rng = np.random.default_rng(6 + split)
    x = rng.standard_normal((4, 64 if split else 32)).astype(np.float32)
    y = rng.standard_normal((4, 32)).astype(np.float32)
    g = rng.standard_normal((4, 32)).astype(np.float32)
    jx, tx = _pair(x)
    jy, ty = _pair(y)
    jout = JF.swiglu(jx) if split else JF.swiglu(jx, jy)
    tout = TF.swiglu(tx) if split else TF.swiglu(tx, ty)
    _close(tout, jout)
    _backward(jout, tout, g)
    _close(tx.grad, jx.grad)
    if not split:
        _close(ty.grad, jy.grad)


@pytest.mark.parametrize("tx_,ty_,bias", [(False, False, True),
                                          (True, False, False),
                                          (False, True, True),
                                          (True, True, True)])
def test_fused_matmul_bias_matches_jax(tx_, ty_, bias):
    rng = np.random.default_rng(7 + tx_ + 2 * ty_)
    a = rng.standard_normal((16, 8) if tx_ else (8, 16)).astype(np.float32)
    b = rng.standard_normal((12, 16) if ty_ else (16, 12)).astype(np.float32)
    c = rng.standard_normal(12).astype(np.float32)
    g = rng.standard_normal((8, 12)).astype(np.float32)
    ja, ta = _pair(a)
    jb, tb = _pair(b)
    jc, tc = _pair(c) if bias else (None, None)
    jout = JF.fused_matmul_bias(ja, jb, jc, transpose_x=tx_,
                                transpose_y=ty_)
    tout = TF.fused_matmul_bias(ta, tb, tc, transpose_x=tx_,
                                transpose_y=ty_)
    _close(tout, jout)
    _backward(jout, tout, g)
    for jt, tt in ((ja, ta), (jb, tb), (jc, tc)):
        if jt is not None:
            _close(tt.grad, jt.grad)


@pytest.mark.parametrize("transpose_weight", [False, True])
def test_fused_linear_matches_jax(transpose_weight):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w = rng.standard_normal((24, 16) if transpose_weight else (16, 24)) \
        .astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    jout = JF.fused_linear(_pair(x)[0], _pair(w)[0], _pair(b)[0],
                           transpose_weight=transpose_weight)
    tout = TF.fused_linear(_pair(x)[1], _pair(w)[1], _pair(b)[1],
                           transpose_weight=transpose_weight)
    _close(tout, jout)


@pytest.mark.parametrize("p,training,mode", [
    (0.5, False, "upscale_in_train"), (0.0, True, "upscale_in_train"),
    (0.3, False, "downscale_in_infer")])
def test_dropout_entries_without_dropout_match_jax(p, training, mode):
    rng = np.random.default_rng(11)
    x, y, r = (rng.standard_normal((4, 32)).astype(np.float32)
               for _ in range(3))
    b = rng.standard_normal(32).astype(np.float32)
    jout = JF.fused_dropout_add(_pair(x)[0], _pair(y)[0], p=p,
                                training=training, mode=mode)
    tout = TF.fused_dropout_add(_pair(x)[1], _pair(y)[1], p=p,
                                training=training, mode=mode)
    _close(tout, jout)
    w = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    jout = JF.fused_bias_dropout_residual_layer_norm(
        _pair(x)[0], _pair(r)[0], _pair(b)[0], _pair(w)[0], _pair(b)[0],
        dropout_rate=p, training=training)
    tout = TF.fused_bias_dropout_residual_layer_norm(
        _pair(x)[1], _pair(r)[1], _pair(b)[1], _pair(w)[1], _pair(b)[1],
        dropout_rate=p, training=training)
    _close(tout, jout)


def test_dropout_in_training_raises():
    x = torch.zeros(2, 8)
    with pytest.raises(NotImplementedError, match="dropout"):
        TF.fused_dropout_add(x, x)
    with pytest.raises(NotImplementedError, match="dropout"):
        TF.fused_bias_dropout_residual_layer_norm(x, x)


# -- the chip phase's composite at a tiny width -------------------------------------------

def test_rowwise_composite_matches_jax():
    """x + residual -> fused_rms_norm -> q, k, v projections -> RoPE on q
    and k -> causal scores q k^T / sqrt(D) -> softmax_mask_fuse_upper_
    triangle -> p v -> a weighted sum, forward and backward, float32, with
    the port's three kernel routes taken (h 256, D 128, S 128)."""
    b, s, heads, d = 2, 128, 2, 128
    hid = heads * d
    rng = np.random.default_rng(50)
    x, r = (rng.standard_normal((b, s, hid)).astype(np.float32)
            for _ in range(2))
    w = (1 + 0.2 * rng.standard_normal(hid)).astype(np.float32)
    wq, wk, wv = ((rng.standard_normal((hid, hid)) / np.sqrt(hid))
                  .astype(np.float32) for _ in range(3))
    gout = rng.standard_normal((b, heads, s, d)).astype(np.float32)
    inv = 1.0 / (10000.0 ** (np.arange(0, d, 2) / d))
    emb = np.concatenate([np.outer(np.arange(s), inv)] * 2, -1)
    cos, sin = np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)

    def run(lib, tensor, matmul, heads_first, tables, F, inc):
        leaves = [tensor(a) for a in (x, r, w, wq, wk, wv)]
        xx, rr, ww, q_w, k_w, v_w = leaves
        normed, _ = F.fused_rms_norm(xx, ww, None, 1e-5, residual=rr)
        q, k, v = (matmul(normed, m).reshape([b, s, heads, d])
                   for m in (q_w, k_w, v_w))
        q, k, _ = F.fused_rotary_position_embedding(
            q, k, None, sin=tables[1], cos=tables[0],
            use_neox_rotary_style=False)
        scores = matmul(heads_first(q), heads_first(k, True)) \
            * (1.0 / np.sqrt(d))
        p = inc.softmax_mask_fuse_upper_triangle(scores)
        out = matmul(p, heads_first(v))
        loss = (out * tensor(gout, False)).sum()
        loss.backward()
        return loss, [t.grad for t in leaves]

    jloss, jgrads = run(
        "jax", lambda a, g=True: pt.to_tensor(jnp.asarray(a),
                                              stop_gradient=not g),
        pt.matmul,
        lambda t, kt=False: pt.transpose(t, [0, 2, 3, 1] if kt
                                         else [0, 2, 1, 3]),
        (pt.to_tensor(cos), pt.to_tensor(sin)), JF, jinc)
    launches = (rms_norm_fwd.launches, rms_norm_bwd.launches, rope.launches,
                causal_softmax_fwd.launches, causal_softmax_bwd.launches)
    tloss, tgrads = run(
        "torch", lambda a, g=True: torch.tensor(a, requires_grad=g),
        torch.matmul,
        lambda t, kt=False: t.permute(0, 2, 3, 1) if kt
        else t.permute(0, 2, 1, 3),
        (torch.tensor(cos), torch.tensor(sin)), TF, tinc)
    assert launches == (rms_norm_fwd.launches, rms_norm_bwd.launches,
                        rope.launches, causal_softmax_fwd.launches,
                        causal_softmax_bwd.launches)
    np.testing.assert_allclose(float(tloss.detach()), float(_np(jloss)),
                               rtol=1e-5)
    for tg, jg in zip(tgrads, jgrads):
        _close(tg, jg, GRAD_ATOL)
