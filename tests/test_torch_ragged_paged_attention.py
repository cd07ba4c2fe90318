"""The port's ragged paged attention against the JAX Pallas kernel.

On the CPU the port's wrapper runs its plain PyTorch version and the JAX
kernel runs in Pallas interpret mode, as the JAX package's own tests run
it. Both get the same numpy arrays. Tolerance: float32 atol = rtol = 1e-5;
the two sum the softmax in different orders (online over blocks in the
kernel, one pass over the gathered window in the plain version).

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda_kernels.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddle_tpu.kernels.pallas.ragged_paged_attention import (
    dense_gather_hbm_bytes as jax_dense_bytes)
from paddle_tpu.kernels.pallas.ragged_paged_attention import (
    ragged_hbm_bytes as jax_ragged_bytes)
from paddle_tpu.kernels.pallas.ragged_paged_attention import (
    ragged_paged_attention as jax_ragged)

from paddle_tpu_torch.kernels.ragged_paged_attention import (
    dense_gather_hbm_bytes, ragged_hbm_bytes, ragged_paged_attention,
    ragged_paged_attention_plain)

TOL = 1e-5


def _case(seed, nh, nkv, hd, bs, mb, lens):
    rng = np.random.default_rng(seed)
    S = len(lens)
    nb = S * mb + 1
    kp = rng.standard_normal((nb, bs, nkv, hd)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, nkv, hd)).astype(np.float32)
    q = rng.standard_normal((S, nh, hd)).astype(np.float32)
    perm = rng.permutation(nb - 1)[:S * mb] + 1      # distinct, no trash
    tables = perm.reshape(S, mb).astype(np.int32)
    return q, kp, vp, tables, np.asarray(lens, np.int32)


def _jax(q, kp, vp, tables, lens):
    return np.asarray(jax.jit(jax_ragged)(
        jnp.asarray(q, jnp.float32), jnp.asarray(kp, jnp.float32),
        jnp.asarray(vp, jnp.float32), jnp.asarray(tables, jnp.int32),
        jnp.asarray(lens, jnp.int32)))


def _port(q, kp, vp, tables, lens):
    t = torch.from_numpy
    return ragged_paged_attention(t(q), t(kp), t(vp), t(tables),
                                  t(lens)).numpy()


@pytest.mark.parametrize("nh,nkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("bs", [8, 16])
def test_matches_jax_kernel(nh, nkv, bs):
    mb = 4
    lens = np.random.default_rng(bs * 10 + nh).integers(0, mb * bs, 5)
    args = _case(nh * 100 + nkv * 10 + bs, nh, nkv, 16, bs, mb, lens)
    np.testing.assert_allclose(_port(*args), _jax(*args), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("bs", [8, 16])
def test_ragged_extremes(bs):
    """Position 0 (one token), the last lane of a block, the first lane
    of the next, and the last position of the window."""
    mb = 4
    lens = [0, bs - 1, bs, 2 * bs + 3, mb * bs - 1]
    args = _case(40 + bs, 4, 2, 16, bs, mb, lens)
    np.testing.assert_allclose(_port(*args), _jax(*args), atol=TOL,
                               rtol=TOL)


def test_poisoned_blocks_never_influence_output():
    """Every pool position past each slot's seq_len is NaN (whole blocks
    past the live one, the trash block, and the tail of the live block),
    and table entries past the live block point at garbage ids: the
    output stays finite and equals the run on the clean pool."""
    nh, nkv, hd, bs, mb = 4, 2, 16, 8, 4
    lens = np.asarray([3, 17, 20, 0], np.int32)
    q, kp, vp, _, _ = _case(7, nh, nkv, hd, bs, mb, lens)
    S = len(lens)
    tables = np.zeros((S, mb), np.int32)
    live_pos = set()
    nxt = 1
    for s in range(S):
        for j in range(lens[s] // bs + 1):
            tables[s, j] = nxt
            for lane in range(bs):
                if j * bs + lane <= lens[s]:
                    live_pos.add((nxt, lane))
            nxt += 1
        tables[s, lens[s] // bs + 1:] = 10_000 + s     # garbage ids
    clean = _port(q, kp, vp, np.where(tables < 10_000, tables, 0), lens)
    pk, pv = kp.copy(), vp.copy()
    for b in range(kp.shape[0]):
        for lane in range(bs):
            if (b, lane) not in live_pos:
                pk[b, lane] = np.nan
                pv[b, lane] = np.nan
    out = _port(q, pk, pv, tables, lens)
    assert np.isfinite(out).all(), "an out-of-window position was read"
    np.testing.assert_array_equal(out, clean)
    ref = _jax(q, kp, vp, np.where(tables < 10_000, tables, 0), lens)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


def test_bfloat16_plain_returns_input_dtype():
    args = _case(3, 4, 2, 16, 8, 4, [5, 30])
    q, kp, vp, tables, lens = (torch.from_numpy(a) for a in args)
    out = ragged_paged_attention(q.bfloat16(), kp.bfloat16(),
                                 vp.bfloat16(), tables, lens)
    assert out.dtype == torch.bfloat16
    ref = ragged_paged_attention_plain(q, kp, vp, tables, lens, 0.25)
    assert (out.float() - ref).abs().max() < 2e-2


def test_traffic_accounting_matches_jax():
    lens = [0, 9, 31, 64]
    live = [True, True, False, True]
    for kw in ({}, {"live": live}, {"scale_bytes": 4}):
        assert ragged_hbm_bytes(lens, 16, 8, 128, 2, **kw) == \
            jax_ragged_bytes(lens, 16, 8, 128, 2, **kw)
    assert dense_gather_hbm_bytes(4, 8, 16, 8, 128, 2) == \
        jax_dense_bytes(4, 8, 16, 8, 128, 2)


def test_wrapper_counts_only_kernel_launches():
    before = ragged_paged_attention.launches
    _port(*_case(9, 4, 2, 16, 8, 2, [3, 9]))
    assert ragged_paged_attention.launches == before

