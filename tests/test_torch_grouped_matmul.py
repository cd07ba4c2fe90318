"""The port's grouped matmul against the JAX package, on the CPU.

The same seeded numpy routing and operands go through the JAX package's
grouped_matmul with its Pallas kernels (``impl="kernel"``, interpret mode
on the CPU, as tests/test_grouped_matmul.py runs them) and through the
port's ``grouped_matmul``, which on CPU tensors takes the plain versions
of its CUDA kernels. Both use the same explicit bm; padding rows are
unspecified in both, so only the rows ``dest`` points at are compared.

Tolerances, and why:
- the routing metadata is integer arithmetic: equal bit for bit;
- float32 outputs and gradients: 1e-5 of each tensor's largest element
  (both sum K products in float32, in different orders);
- bfloat16 outputs: one bf16 ulp of the value (2^-7 |ref|) plus 1e-5 of
  the largest: both round the same float32 sums to bf16, which may land
  on either side of a rounding boundary.

The CUDA kernels are held against the plain versions on the card by
tests/test_torch_cuda_kernels.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu  # noqa: F401  (x64 on, as in the JAX package's tests)
from paddle_tpu.kernels.pallas import grouped_matmul as jgm

from paddle_tpu_torch.kernels.grouped_matmul import (
    DEFAULT_BM, aligned_group_size, default_block_m, grouped_bias_grad,
    grouped_matmul, grouped_matmul_dw, grouped_matmul_fwd, grouped_metadata)

REL_TOL = 1e-5
BF16_RTOL = 2.0 ** -7
E, K, N = 4, 16, 32

SKEWS = {
    "balanced": np.arange(48) % E,
    "skewed": np.concatenate([np.zeros(40), [1, 2, 3]]),
    "one_expert": np.full(24, 2),
    "random": np.random.default_rng(5).integers(0, E, 37),
}


def _ids(skew):
    return np.asarray(SKEWS[skew], np.int32)


def _operands(ids, bm, dtype=np.float32, seed=0, k=K, n=N):
    """(jax metadata, torch metadata, buf, w, b) as numpy float32: buf is
    the sorted buffer of random token rows, zero on padding rows."""
    rng = np.random.default_rng(seed)
    jmd = jgm.grouped_metadata(jnp.asarray(ids), E, bm)
    tmd = grouped_metadata(torch.from_numpy(ids), E, bm)
    x = rng.standard_normal((ids.size, k)).astype(np.float32)
    row_src = np.asarray(jmd["row_src"])
    buf = np.where((row_src >= 0)[:, None], x[np.clip(row_src, 0, None)],
                   0).astype(np.float32)
    w = rng.standard_normal((E, k, n)).astype(np.float32)
    b = rng.standard_normal((E, n)).astype(np.float32)
    return jmd, tmd, buf, w, b


def _dest(jmd):
    return np.asarray(jmd["dest"])


@pytest.mark.parametrize("bm", [8, 16])
@pytest.mark.parametrize("skew", list(SKEWS))
def test_metadata_bit_identical(skew, bm):
    ids = _ids(skew)
    jmd = jgm.grouped_metadata(jnp.asarray(ids), E, bm)
    tmd = grouped_metadata(torch.from_numpy(ids), E, bm)
    for key in ("counts", "offsets", "dest", "row_src", "row_valid"):
        ref = np.asarray(jmd[key])
        got = tmd[key].numpy()
        assert got.shape == ref.shape, key
        if key != "row_valid":
            assert tmd[key].dtype == torch.int32, key
        np.testing.assert_array_equal(got, ref, err_msg=key)
    assert aligned_group_size(ids.size, E, bm) == \
        jgm.aligned_group_size(ids.size, E, bm)


def test_block_m_is_the_kernel_tile():
    assert default_block_m() == DEFAULT_BM == 128
    ids = torch.from_numpy(_ids("random"))
    md = grouped_metadata(ids, E, default_block_m())
    assert md["row_src"].shape[0] % 128 == 0
    assert (md["offsets"] % 128 == 0).all()


def _jax_fwd(buf, w, b, jmd, bm, dtype):
    out = jgm.grouped_matmul(
        jnp.asarray(buf, dtype), jnp.asarray(w, dtype),
        None if b is None else jnp.asarray(b, dtype),
        group_offsets=jmd["offsets"], group_counts=jmd["counts"], bm=bm,
        bn=16, impl="kernel")
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("skew", ["skewed", "random"])
def test_forward_matches_jax_kernel_f32(skew, bias):
    bm = 8
    jmd, tmd, buf, w, b = _operands(_ids(skew), bm)
    b = b if bias else None
    ref = _jax_fwd(buf, w, b, jmd, bm, jnp.float32)
    before = grouped_matmul_fwd.launches
    out = grouped_matmul(torch.from_numpy(buf), torch.from_numpy(w),
                         None if b is None else torch.from_numpy(b),
                         group_offsets=tmd["offsets"],
                         group_counts=tmd["counts"], bm=bm)
    assert grouped_matmul_fwd.launches == before    # the CPU: plain path
    assert out.dtype == torch.float32
    d = _dest(jmd)
    np.testing.assert_allclose(out.numpy()[d], ref[d], rtol=0,
                               atol=REL_TOL * np.abs(ref[d]).max())


@pytest.mark.parametrize("bias", [True, False])
def test_forward_matches_jax_kernel_bf16(bias):
    bm = 16
    jmd, tmd, buf, w, b = _operands(_ids("random"), bm, seed=3)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    # both sides get the same bf16-rounded operands
    buf, w, b = (bf(a).float().numpy() for a in (buf, w, b))
    b = b if bias else None
    ref = _jax_fwd(buf, w, b, jmd, bm, jnp.bfloat16)
    out = grouped_matmul(bf(buf), bf(w), None if b is None else bf(b),
                         group_offsets=tmd["offsets"],
                         group_counts=tmd["counts"], bm=bm)
    assert out.dtype == torch.bfloat16
    d = _dest(jmd)
    got = out.float().numpy()[d]
    lim = BF16_RTOL * np.abs(ref[d]) + REL_TOL * np.abs(ref[d]).max()
    assert (np.abs(got - ref[d]) <= lim).all()


def _jax_grads(buf, w, b, jmd, bm, g):
    dest = jmd["dest"]

    def loss(buf, w, b):
        o = jgm.grouped_matmul(buf, w, b, group_offsets=jmd["offsets"],
                               group_counts=jmd["counts"], bm=bm, bn=16,
                               impl="kernel")
        return jnp.sum(o[dest].astype(jnp.float32) * g)

    return [np.asarray(a) for a in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(buf), jnp.asarray(w), jnp.asarray(b))]


def _port_grads(buf, w, b, tmd, bm, g, poison=None):
    tb = torch.from_numpy(buf if poison is None else poison) \
        .requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tbias = torch.from_numpy(b).requires_grad_()
    o = grouped_matmul(tb, tw, tbias, group_offsets=tmd["offsets"],
                       group_counts=tmd["counts"], bm=bm)
    (o[tmd["dest"].long()] * torch.from_numpy(g)).sum().backward()
    return o.detach().numpy(), [t.grad.numpy() for t in (tb, tw, tbias)]


@pytest.mark.parametrize("skew", ["skewed", "one_expert", "random"])
def test_gradients_match_jax_custom_vjp(skew):
    """dx, dw and db against jax.grad through the JAX package's custom
    VJP (its dx and dw kernels in interpret mode)."""
    bm = 8
    ids = _ids(skew)
    jmd, tmd, buf, w, b = _operands(ids, bm, seed=7)
    g = np.random.default_rng(8).standard_normal((ids.size, N)) \
        .astype(np.float32)
    ref = _jax_grads(buf, w, b, jmd, bm, g)
    _, got = _port_grads(buf, w, b, tmd, bm, g)
    valid = np.asarray(jmd["row_valid"])
    for name, r, t in zip(("dx", "dw", "db"), ref, got):
        if name == "dx":                    # padding rows are unspecified
            r, t = r[valid], t[valid]
        np.testing.assert_allclose(t, r, rtol=0,
                                   atol=REL_TOL * np.abs(r).max(),
                                   err_msg=name)


def test_nan_in_dead_tiles_and_padding_never_reaches_outputs_or_grads():
    """Every row that is not a route's (padding inside the last live tile
    and whole dead tiles past the groups) is NaN: the routed rows' outputs
    and every gradient must still equal the clean run's
    (tests/test_grouped_matmul.py:143,174 for the JAX kernels)."""
    bm = 8
    ids = np.concatenate([np.zeros(11), np.full(3, 1),
                          np.full(19, 3)]).astype(np.int32)   # expert 2 empty
    jmd, tmd, buf, w, b = _operands(ids, bm, seed=9)
    valid = np.asarray(jmd["row_valid"])
    poison = buf.copy()
    poison[~valid] = np.nan
    g = np.random.default_rng(10).standard_normal((ids.size, N)) \
        .astype(np.float32)
    out_c, grads_c = _port_grads(buf, w, b, tmd, bm, g)
    out_p, grads_p = _port_grads(buf, w, b, tmd, bm, g, poison=poison)
    d = _dest(jmd)
    np.testing.assert_array_equal(out_p[d], out_c[d])
    dx_c, dx_p = grads_c[0], grads_p[0]
    np.testing.assert_array_equal(dx_p[valid], dx_c[valid])
    for name, c, p in zip(("dw", "db"), grads_c[1:], grads_p[1:]):
        assert np.isfinite(p).all(), name
        np.testing.assert_array_equal(p, c, err_msg=name)
    # the weight-gradient function itself: NaN in padding rows of dy too
    x = torch.from_numpy(poison)
    dy = torch.from_numpy(np.where(valid[:, None], 1.0, np.nan)
                          .astype(np.float32).repeat(N, 1))
    dw = grouped_matmul_dw(x, dy, tmd["offsets"], tmd["counts"], bm, E)
    db = grouped_bias_grad(dy, tmd["offsets"], tmd["counts"], E)
    assert torch.isfinite(dw).all() and torch.isfinite(db).all()
    assert (dw[2] == 0).all() and (db[2] == 0).all()     # the empty expert


def test_transposed_forward_is_the_input_gradient():
    """dx = dy . w[e]^T: the forward's plain version read through the
    transpose equals JAX's forward kernel against swapaxes(w)."""
    bm = 8
    ids = _ids("random")
    jmd, tmd, _, w, _ = _operands(ids, bm, seed=11)
    rng = np.random.default_rng(12)
    dy = rng.standard_normal((np.asarray(jmd["row_src"]).size, N)) \
        .astype(np.float32)
    ref = _jax_fwd(dy, np.swapaxes(w, 1, 2).copy(), None, jmd, bm,
                   jnp.float32)
    out = grouped_matmul_fwd(torch.from_numpy(dy), torch.from_numpy(w), None,
                             tmd["offsets"], tmd["counts"], bm,
                             transpose_w=True)
    d = _dest(jmd)
    np.testing.assert_allclose(out.numpy()[d], ref[d], rtol=0,
                               atol=REL_TOL * np.abs(ref[d]).max())


def test_grad_dtypes_match_primals():
    bm = 8
    ids = _ids("random")
    _, tmd, buf, w, b = _operands(ids, bm)
    ts = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
          for a in (buf, w, b)]
    o = grouped_matmul(*ts, group_offsets=tmd["offsets"],
                       group_counts=tmd["counts"], bm=bm)
    (o.float() ** 2).sum().backward()
    assert all(t.grad.dtype == torch.bfloat16 for t in ts)


def test_layout_errors_raise():
    ids = torch.from_numpy(_ids("random"))
    md = grouped_metadata(ids, E, 8)
    x = torch.zeros(md["row_src"].shape[0], K)
    w = torch.zeros(E, K, N)
    with pytest.raises(ValueError, match="multiple of bm"):
        grouped_matmul(x[:-1], w, group_offsets=md["offsets"],
                       group_counts=md["counts"], bm=8)
    with pytest.raises(ValueError, match="do not match"):
        grouped_matmul(x, torch.zeros(E, K + 1, N),
                       group_offsets=md["offsets"],
                       group_counts=md["counts"], bm=8)
    with pytest.raises(TypeError, match="share a dtype"):
        grouped_matmul(x, w.double(), group_offsets=md["offsets"],
                       group_counts=md["counts"], bm=8)
    with pytest.raises(ValueError, match="int32"):
        grouped_matmul_fwd(x, w, None, md["offsets"][:2], md["counts"], 8)
