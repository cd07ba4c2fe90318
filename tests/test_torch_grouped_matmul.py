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

The tensor-core forward's arithmetic (float32 x and w each split into
three exact bf16 pieces, six piece products a k16 step, a float32 partial
drained each 64-deep stage) is emulated here and held to the JAX kernel
in interpret mode against the float32 rule, 1e-6 |ref| + 1e-5 of the
largest output; so is the weight gradient's (x and dy split, the
contraction over a group's rows in 64-row stages). The CUDA kernels are
held against the plain versions on the card by
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
    DEFAULT_BM, GM_ROUTES, _ref_fwd, _row_experts, _tile_experts,
    aligned_group_size,
    default_block_m, gm_dw_route, gm_route, grouped_bias_grad,
    grouped_matmul, grouped_matmul_dw, grouped_matmul_fwd, grouped_metadata)
from paddle_tpu_torch.kernels.quant_matmul import split3_bf16
from torch_threads import one_thread  # noqa: F401  (autouse)

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


# -- the tensor-core forward's arithmetic -------------------------------------

# (x piece, w piece) of each product a k16 step, in the kernel's order:
# (hi, hi), (hi, mid), (mid, hi), (mid, mid), (hi, lo), (lo, hi)
SIX = ((0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (2, 0))
THREE = SIX[:3]


def _toward_zero(v):
    """float64 -> float32, rounded toward zero."""
    f = v.float()
    over = f.double().abs() > v.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


class _one_thread:
    """torch on one intra-op thread inside the block: the emulation is
    thousands of small ops, which threads only slow down when test
    workers share the cores."""

    def __enter__(self):
        self.n = torch.get_num_threads()
        torch.set_num_threads(1)

    def __exit__(self, *exc):
        torch.set_num_threads(self.n)


def _wgmma_emulation(x, w, offsets, counts, bm, drain=True,
                     rounding="nearest"):
    """The tensor-core kernel's sum on the CPU: x [Tp, K] and w [E, K, N]
    each split into hi, mid and lo (split3_bf16), each 128-row token tile
    that holds a route against its expert's w; each k16 step adds the six
    products in order, each product's 16 terms exact (float64), into a
    float32 partial that starts at zero each 64-deep stage and is then
    added to the float32 accumulator (drain False: straight into the
    accumulator). Each product's sum into its target rounds to nearest
    or, the model of a truncating adder, toward zero. float32 [Tp, N],
    zero on tiles without a route."""
    t_rows, k = x.shape
    texp = _tile_experts(offsets, t_rows, bm, w.shape[0]).long()
    _, valid = _row_experts(offsets, counts, t_rows, w.shape[0])
    live = valid.reshape(-1, bm).any(1).nonzero()[:, 0]
    out = torch.zeros(t_rows // bm, bm, w.shape[2])
    with _one_thread():
        xp = torch.stack([p.double().reshape(-1, bm, k)[live]
                          for p in split3_bf16(x)])          # [3, T, bm, K]
        wp = torch.stack([p.double()[texp[live]]
                          for p in split3_bf16(w)])          # [3, T, K, N]
        acc = torch.zeros(len(live), bm, w.shape[2])
        for k0 in range(0, k, 64):
            # every piece product of the stage's four k16 steps, exact
            prods = torch.einsum(
                "atmjc,btjcn->jabtmn",
                xp[..., k0:k0 + 64].unflatten(-1, (4, 16)),
                wp[:, :, k0:k0 + 64].unflatten(2, (4, 16)))
            tgt = torch.zeros_like(acc) if drain else acc
            for j in range(4):
                for a, b in SIX:
                    s = tgt.double() + prods[j, a, b]
                    tgt = (_toward_zero(s) if rounding == "toward_zero"
                           else s.float())
            acc = acc + tgt if drain else tgt
        out[live] = acc
    return out.reshape(t_rows, -1)


def _share(got, ref):
    """The largest error as a share of the float32 rule."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    lim = 1e-6 * np.abs(ref) + 1e-5 * np.abs(ref).max()
    return float((np.abs(got - ref) / lim).max())


def _moe_operands(k, n=128, seed=0):
    """300 routes over 4 experts (the last empty) at bm 128, unit normal
    x and w at 0.02, the MoE layer's scales."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, E - 1, 300).astype(np.int32)
    jmd = jgm.grouped_metadata(jnp.asarray(ids), E, 128)
    tmd = grouped_metadata(torch.from_numpy(ids), E, 128)
    row_src = np.asarray(jmd["row_src"])
    x = rng.standard_normal((ids.size, k)).astype(np.float32)
    buf = np.where((row_src >= 0)[:, None], x[np.clip(row_src, 0, None)],
                   0).astype(np.float32)
    w = (rng.standard_normal((E, k, n)) * 0.02).astype(np.float32)
    return jmd, tmd, buf, w


@pytest.mark.parametrize("k", [768, 3072])
def test_six_products_meet_the_float32_rule(k):
    """The kernel's sum (six piece products a k16 step, the partial drained
    each stage) against the JAX `_fwd_kernel` in interpret mode at the
    MoE layer's K: measured 0.067 (K 768) and 0.050 (K 3072) of the
    float32 rule, and 0.060 and 0.041 of it from the port's plain
    version. The pieces themselves, in float64 so that no summation
    enters: six products miss x w by the three dropped terms only (below
    2^-22 |x w| each; measured 0.006 of the rule), the three largest,
    (hi, hi), (hi, mid) and (mid, hi), by far more than the rule allows
    (measured 2.45 and 2.37): (mid, mid), (hi, lo) and (lo, hi) are each
    about 2^-16 |x w| and share the product's sign, so they do not
    cancel over K."""
    jmd, tmd, buf, w = _moe_operands(k, seed=k)
    tx, tw = torch.from_numpy(buf), torch.from_numpy(w)
    ref = np.asarray(jgm.grouped_matmul(
        jnp.asarray(buf), jnp.asarray(w), None,
        group_offsets=jmd["offsets"], group_counts=jmd["counts"], bm=128,
        bn=128, impl="kernel"))
    assert gm_route(torch.float32, k, w.shape[2], 128, False, (0, 0)) \
        == "wgmma"
    emu = _wgmma_emulation(tx, tw, tmd["offsets"], tmd["counts"],
                           128).numpy()
    d = _dest(jmd)
    share = _share(emu[d], ref[d])
    assert share < 0.3, share
    plain = _ref_fwd(tx, tw, None, tmd["offsets"], tmd["counts"], 128,
                     torch.float32).numpy()
    assert _share(emu[d], plain[d]) < 0.3
    # the pieces in float64, over the routed rows
    texp = _tile_experts(tmd["offsets"], buf.shape[0], 128, E).long()
    xp = [p.double() for p in split3_bf16(tx)]
    wp = [p.double() for p in split3_bf16(tw)]

    def rows(prod):
        return prod.reshape(buf.shape[0], -1).numpy()[d]

    def pieces(pairs):
        return rows(sum(torch.bmm(xp[a].reshape(-1, 128, k), wp[b][texp])
                        for a, b in pairs))
    with _one_thread():
        exact = rows(torch.bmm(tx.double().reshape(-1, 128, k),
                               tw.double()[texp]))
        assert _share(pieces(SIX), exact) < 0.02
        assert _share(pieces(THREE), exact) > 2.0


def test_a_truncating_adder_needs_the_drain():
    """Why the partial is drained each stage: with every product's sum
    rounded toward zero (the truncating model of the tensor cores' adder),
    the six products added straight into one accumulator over K 3072 miss
    the float32 rule (measured 2.49 of it here; a build of the kernel
    without the drain gives 2.5-2.6 on the card at K 3072, chip_smoke.py
    --grouped-cost), while a partial that restarts each 64-deep stage and
    is added in float32 stays inside it (measured 0.088; 0.17-0.27 on the
    card). Rounded to nearest, both would pass (0.11 and 0.052)."""
    k = 3072
    jmd, tmd, buf, w = _moe_operands(k, seed=5)
    tx, tw = torch.from_numpy(buf), torch.from_numpy(w)
    d = _dest(jmd)
    exact = _ref_fwd(tx.double(), tw.double(), None, tmd["offsets"],
                     tmd["counts"], 128, torch.float64).numpy()[d]
    shares = {(drain, r): _share(_wgmma_emulation(
        tx, tw, tmd["offsets"], tmd["counts"], 128, drain, r).numpy()[d],
        exact) for drain in (False, True)
        for r in ("nearest", "toward_zero")}
    assert shares[(False, "toward_zero")] > 1.0, shares
    assert shares[(True, "toward_zero")] < 0.3, shares
    assert shares[(False, "nearest")] < 0.3, shares
    assert shares[(True, "nearest")] < 0.3, shares


def test_split_cross_products_turn_inf_into_nan():
    """The hazard of splitting both operands: an inf goes whole into hi
    with mid = lo = 0, so where w is exact in bf16 (its mid and lo are
    0) the cross product (hi, mid) is inf x 0 = NaN and the sum is NaN
    where the float32 product is inf; likewise an inf weight meets x's
    zero pieces. (A whole row of inf gives NaN on both sides: inf -
    inf.) The kernel redoes a tile that holds a non-finite value in
    float32 FMAs (held on the card by tests/test_torch_cuda_kernels.py::
    test_grouped_wgmma_non_finite_as_plain)."""
    k = 64
    jmd, tmd, buf, w = _moe_operands(k, seed=3)
    w = torch.from_numpy(w).to(torch.bfloat16).float()     # exact in bf16
    x = torch.from_numpy(buf.copy())
    d = torch.from_numpy(_dest(jmd).copy()).long()
    x[d[0], 9] = float("inf")
    plain = _ref_fwd(x, w, None, tmd["offsets"], tmd["counts"], 128,
                     torch.float32)
    emu = _wgmma_emulation(x, w, tmd["offsets"], tmd["counts"], 128)
    assert torch.isinf(plain[d[0]]).all()
    assert torch.isnan(emu[d[0]]).all()
    w2 = w.clone()
    w2[int(_tile_experts(tmd["offsets"], x.shape[0], 128, E)[
        int(d[1]) // 128]), 5, 7] = float("-inf")
    x2 = torch.from_numpy(buf).to(torch.bfloat16).float()  # exact in bf16
    plain = _ref_fwd(x2, w2, None, tmd["offsets"], tmd["counts"], 128,
                     torch.float32)
    emu = _wgmma_emulation(x2, w2, tmd["offsets"], tmd["counts"], 128)
    assert torch.isinf(plain[d[1], 7]) and torch.isnan(emu[d[1], 7])


@pytest.mark.parametrize("dtype,k,n,bm,trans,ptrs,route", [
    (torch.float32, 768, 3072, 128, False, (0, 16), "wgmma"),
    (torch.float32, 3072, 768, 128, True, (0, 0), "wgmma"),
    (torch.bfloat16, 768, 3072, 256, False, (32, 4096), "wgmma"),
    (torch.float32, 768, 3072, 64, False, (0, 0), "cuda_core"),  # bm 64
    (torch.float32, 768, 3072, 64, True, (0, 0), "cuda_core"),
    (torch.float32, 96, 256, 128, False, (0, 0), "cuda_core"),  # K % 64
    (torch.bfloat16, 130, 256, 128, True, (0, 0), "cuda_core"),
    (torch.float32, 256, 100, 128, False, (0, 0), "cuda_core"),  # N % 8
    (torch.float32, 256, 100, 128, True, (0, 0), "wgmma"),  # reads along K
    (torch.float32, 256, 256, 128, False, (4, 0), "cuda_core"),  # x
    (torch.bfloat16, 256, 256, 128, True, (0, 8), "cuda_core"),  # w
    (torch.float16, 256, 256, 128, False, (0, 0), "cuda_core"),
])
def test_gm_route(dtype, k, n, bm, trans, ptrs, route):
    assert gm_route(dtype, k, n, bm, trans, ptrs) == route
    assert route in GM_ROUTES


def test_cpu_calls_count_no_route():
    """A CPU tensor takes the plain version: no launch, no route."""
    _, tmd, buf, w, _ = _operands(_ids("random"), 16)
    before = (grouped_matmul_fwd.launches,
              dict(grouped_matmul_fwd.route_launches))
    grouped_matmul_fwd(torch.from_numpy(buf), torch.from_numpy(w), None,
                       tmd["offsets"], tmd["counts"], 16)
    assert (grouped_matmul_fwd.launches,
            grouped_matmul_fwd.route_launches) == before


# -- the tensor-core weight gradient's arithmetic -------------------------------

def _dw_wgmma_emulation(x, dy, offsets, counts, num_expert, drain=True,
                        rounding="nearest"):
    """The tensor-core weight gradient's sum on the CPU: x [Tp, K] and dy
    [Tp, N] each split into hi, mid and lo (split3_bf16); each group's
    rows [offsets[e], offsets[e] + counts[e]) in 64-row stages (rows past
    the count zero, never read); each k16 step (16 rows) adds the six
    products x_a^T dy_b in order, each product's 16 terms exact
    (float64), into a float32 partial that starts at zero each stage and
    is then added to the float32 accumulator (drain False: straight into
    the accumulator). Each product's sum into its target rounds to
    nearest or, the model of a truncating adder, toward zero. float32
    [E, K, N], zero for an empty group."""
    k, n = x.shape[1], dy.shape[1]
    out = torch.zeros(num_expert, k, n)
    xs = [p.double() for p in split3_bf16(x)]
    ys = [p.double() for p in split3_bf16(dy)]
    with _one_thread():
        for e in range(num_expert):
            r0, c = int(offsets[e]), int(counts[e])
            stages = -(-c // 64)

            def rows(p):        # [stages, 4 k16 steps, 16 rows, columns]
                v = torch.zeros(stages * 64, p.shape[1], dtype=p.dtype)
                v[:c] = p[r0:r0 + c]
                return v.reshape(stages, 4, 16, p.shape[1])
            xp = torch.stack([rows(p) for p in xs])
            yp = torch.stack([rows(p) for p in ys])
            acc = torch.zeros(k, n)
            for st in range(stages):
                # every piece product of the stage's four k16 steps, exact
                prods = torch.einsum("ajrk,bjrn->jabkn", xp[:, st],
                                     yp[:, st])
                tgt = torch.zeros_like(acc) if drain else acc
                for j in range(4):
                    for a, b in SIX:
                        v = tgt.double() + prods[j, a, b]
                        tgt = (_toward_zero(v) if rounding == "toward_zero"
                               else v.float())
                acc = acc + tgt if drain else tgt
            out[e] = acc
    return out


# a group of 4,200 rows (65 stages and a partial one of 40 rows), an empty
# group, and groups of 300 and 1,000 rows (not multiples of 64)
DW_COUNTS = (4200, 0, 300, 1000)


def _dw_operands(seed, k=128, n=128):
    """(jax metadata, torch metadata, x, dy, w) as numpy float32 at bm 128
    for DW_COUNTS: x unit normal, dy at 0.02 (the MoE layer's scales), w
    for the JAX forward; padding rows zero in x and dy (the JAX dw kernel
    masks x's and multiplies dy's unmasked)."""
    rng = np.random.default_rng(seed)
    ids = np.repeat(np.arange(len(DW_COUNTS)), DW_COUNTS).astype(np.int32)
    ids = rng.permutation(ids)
    jmd = jgm.grouped_metadata(jnp.asarray(ids), E, 128)
    tmd = grouped_metadata(torch.from_numpy(ids), E, 128)
    live = (np.asarray(jmd["row_src"]) >= 0)[:, None]
    tp = live.shape[0]
    x = np.where(live, rng.standard_normal((tp, k)), 0).astype(np.float32)
    dy = np.where(live, rng.standard_normal((tp, n)) * 0.02,
                  0).astype(np.float32)
    w = (rng.standard_normal((E, k, n)) * 0.02).astype(np.float32)
    return jmd, tmd, x, dy, w


def _exact_dw(x, dy, tmd):
    """x^T dy over each group's rows in float64 (its products exact)."""
    out = np.zeros((E, x.shape[1], dy.shape[1]))
    for e, (r0, c) in enumerate(zip(tmd["offsets"].tolist(),
                                    tmd["counts"].tolist())):
        out[e] = x[r0:r0 + c].astype(np.float64).T @ dy[r0:r0 + c]
    return out


def test_dw_six_products_meet_the_float32_rule():
    """The tensor-core weight gradient's sum (x and dy split, six piece
    products a k16 step, the partial drained each 64-row stage) over a
    group of 4,200 rows, an empty group and groups of 300 and 1,000 rows,
    against the JAX `_dw_kernel` in interpret mode, reached through
    jax.vjp of grouped_matmul(impl="kernel"), and against the port's
    plain version: measured 0.037 of the float32 rule against each (the
    two float32 references agree bit for bit here), 0.027 against the
    float64 sum."""
    jmd, tmd, x, dy, w = _dw_operands(seed=1)
    assert tuple(np.asarray(jmd["counts"])) == DW_COUNTS

    def fwd(x, w):
        return jgm.grouped_matmul(x, w, None, group_offsets=jmd["offsets"],
                                  group_counts=jmd["counts"], bm=128,
                                  bn=128, impl="kernel")
    _, vjp = jax.vjp(fwd, jnp.asarray(x), jnp.asarray(w))
    ref = np.asarray(vjp(jnp.asarray(dy))[1])
    tx, tdy = torch.from_numpy(x), torch.from_numpy(dy)
    assert gm_dw_route(torch.float32, x.shape[1], dy.shape[1], (0, 0)) \
        == "wgmma"
    emu = _dw_wgmma_emulation(tx, tdy, tmd["offsets"], tmd["counts"],
                              E).numpy()
    assert (emu[1] == 0).all() and (ref[1] == 0).all()
    share = _share(emu, ref)
    assert share < 0.3, share
    plain = grouped_matmul_dw(tx, tdy, tmd["offsets"], tmd["counts"], 128,
                              E).numpy()
    assert _share(emu, plain) < 0.3
    assert _share(plain, ref) < 0.3


def test_dw_truncating_adder_needs_the_drain():
    """Why the weight gradient drains its partial each stage: with every
    product's sum rounded toward zero (the tensor cores' truncating
    adder), the six products added straight into one accumulator over the
    group of 4,200 rows miss the float32 rule (measured 3.85 of it),
    while a partial that restarts each 64-row stage and is added in
    float32 stays inside it (measured 0.084). Rounded to nearest, both
    pass (0.13 and 0.024)."""
    _, tmd, x, dy, _ = _dw_operands(seed=2)
    exact = _exact_dw(x, dy, tmd)
    tx, tdy = torch.from_numpy(x), torch.from_numpy(dy)
    shares = {(drain, r): _share(_dw_wgmma_emulation(
        tx, tdy, tmd["offsets"], tmd["counts"], E, drain, r).numpy(), exact)
        for drain in (False, True) for r in ("nearest", "toward_zero")}
    assert shares[(False, "toward_zero")] > 1.0, shares
    assert shares[(True, "toward_zero")] < 0.3, shares
    assert shares[(False, "nearest")] < 0.3, shares
    assert shares[(True, "nearest")] < 0.3, shares


def test_dw_split_cross_products_turn_inf_into_nan():
    """The weight gradient's hazard is the forward's: an inf in a live row
    of x goes whole into hi with mid = lo = 0, so where dy is exact in
    bf16 the cross product (hi, mid) is inf x 0 = NaN where the float32
    product is inf. The kernel redoes such a tile in float32 FMAs (held on
    the card by tests/test_torch_cuda_kernels.py::
    test_grouped_dw_wgmma_non_finite_as_plain)."""
    _, tmd, x, dy, _ = _dw_operands(seed=3, k=64, n=64)
    dy = torch.from_numpy(dy).to(torch.bfloat16).float()  # exact in bf16
    x = torch.from_numpy(x.copy())
    row = int(tmd["offsets"][2]) + 7                  # a row of group 2
    x[row, 5] = float("inf")
    plain = grouped_matmul_dw(x, dy, tmd["offsets"], tmd["counts"], 128, E)
    emu = _dw_wgmma_emulation(x, dy, tmd["offsets"], tmd["counts"], E)
    assert torch.isinf(plain[2, 5]).all()
    assert torch.isnan(emu[2, 5]).all()
    assert torch.isfinite(emu[[0, 3]]).all()


@pytest.mark.parametrize("dtype,k,n,ptrs,route", [
    (torch.float32, 768, 3072, (0, 16), "wgmma"),     # the MoE up product
    (torch.float32, 3072, 768, (0, 0), "wgmma"),      # and its down one
    (torch.bfloat16, 768, 3072, (32, 4096), "wgmma"),
    (torch.float32, 136, 264, (0, 0), "wgmma"),       # odd multiples of 8
    (torch.float32, 130, 256, (0, 0), "cuda_core"),   # K % 8
    (torch.bfloat16, 256, 100, (0, 0), "cuda_core"),  # N % 8
    (torch.float32, 256, 256, (4, 0), "cuda_core"),   # x off 16 bytes
    (torch.bfloat16, 256, 256, (0, 8), "cuda_core"),  # dy off 16 bytes
    (torch.float16, 256, 256, (0, 0), "cuda_core"),
    (torch.float64, 256, 256, (0, 0), "cuda_core"),
])
def test_gm_dw_route(dtype, k, n, ptrs, route):
    assert gm_dw_route(dtype, k, n, ptrs) == route
    assert route in GM_ROUTES


def test_dw_cpu_calls_count_no_route():
    """A CPU tensor takes the weight gradient's plain version: no launch,
    no route, at bm 128 and 64 alike."""
    before = (grouped_matmul_dw.launches,
              dict(grouped_matmul_dw.route_launches))
    for bm in (128, 64):
        _, tmd, buf, _, _ = _operands(_ids("random"), bm)
        x = torch.from_numpy(buf)
        grouped_matmul_dw(x, x[:, :8].contiguous(), tmd["offsets"],
                          tmd["counts"], bm, E)
    assert (grouped_matmul_dw.launches,
            grouped_matmul_dw.route_launches) == before
