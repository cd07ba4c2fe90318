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



# -- the clustered decode body's plan and arithmetic (csrc/ragged_decode.cuh)
#
# The kernel cuts each slot's window into `splits` runs of whole stages
# (decode_split), deals a run's stages of ts tokens to 4 warps in turn,
# keeps an online softmax per warp (one rescale a stage), merges the warps
# in order and then the cluster's ranks in rank order. The emulation below
# does the same in float32 with torch; against the JAX kernel in interpret
# mode it is held to the float32 tolerance above (summation order only).

from paddle_tpu_torch.kernels.ragged_paged_attention import (  # noqa: E402
    GROUP_SIZES, HEAD_DIMS, decode_split, decode_stage_tokens)

NEG = -1e30


def _merge(parts):
    """Online-softmax states (m [R], l [R], acc [R, hd]) merged in order."""
    m = torch.stack([p[0] for p in parts]).amax(0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for pm, pl_, pa in parts:
        f = torch.exp(pm - m)
        l = l + pl_ * f
        acc = acc + pa * f[:, None]
    return m, l, acc


def _decode_emulation(q, kw, vw, lens, scale, splits, ts, bs, mb,
                      ks=None, vs=None, warps=4):
    """The kernel's arithmetic in float32. kw, vw [S, W, nkv, hd]: each
    slot's window gathered through its table (int8 codes as float); ks, vs
    [S, W]: the row scales of an int8 pool, else None."""
    q = torch.as_tensor(q, dtype=torch.float32)
    kw = torch.as_tensor(kw, dtype=torch.float32)
    vw = torch.as_tensor(vw, dtype=torch.float32)
    S, nh, hd = q.shape
    nkv = kw.shape[2]
    nrep = nh // nkv
    out = torch.zeros(S, nh, hd)
    for s in range(S):
        runs = decode_split(int(lens[s]), mb, bs, splits, ts)
        for g in range(nkv):
            qs = q[s, g * nrep:(g + 1) * nrep] * scale
            ranks = []
            for a, b in runs:
                state = [(torch.full((nrep,), NEG), torch.zeros(nrep),
                          torch.zeros(nrep, hd)) for _ in range(warps)]
                for i, t0 in enumerate(range(a, b, ts)):
                    t1 = min(t0 + ts, b)
                    sc = qs @ kw[s, t0:t1, g].T                 # [R, T]
                    if ks is not None:
                        sc = sc * torch.as_tensor(ks[s, t0:t1])
                    m, l, acc = state[i % warps]
                    m_new = torch.maximum(m, sc.amax(1))
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(sc - m_new[:, None])
                    pv = p if vs is None else p * torch.as_tensor(vs[s, t0:t1])
                    state[i % warps] = (m_new, l * alpha + p.sum(1),
                                        acc * alpha[:, None]
                                        + pv @ vw[s, t0:t1, g])
                ranks.append(_merge(state))
            _, l, acc = _merge(ranks)
            out[s, g * nrep:(g + 1) * nrep] = acc / l[:, None]
    return out.numpy()


def _windows(kp, vp, tables):
    S, mb = tables.shape
    bs, nkv, hd = kp.shape[1:]
    return (kp[tables].reshape(S, mb * bs, nkv, hd),
            vp[tables].reshape(S, mb * bs, nkv, hd))


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("ts", [2, 16])
def test_decode_emulation_matches_jax_kernel(splits, ts):
    """Lengths at every page edge, one token (its other splits empty) and
    the whole table; at 8 splits more ranks than live pages."""
    nh, nkv, hd, bs, mb = 4, 2, 16, 8, 4
    lens = [0, 1, bs - 1, bs, 2 * bs - 1, 2 * bs, 3 * bs + 2, mb * bs - 1]
    q, kp, vp, tables, lens = _case(60 + splits, nh, nkv, hd, bs, mb, lens)
    kw, vw = _windows(kp, vp, tables)
    got = _decode_emulation(q, kw, vw, lens, hd ** -0.5, splits, ts, bs, mb)
    np.testing.assert_allclose(got, _jax(q, kp, vp, tables, lens), atol=TOL,
                               rtol=TOL)


def test_decode_emulation_one_token_window_many_empty_ranks():
    nh, nkv, hd, bs, mb = 8, 1, 16, 8, 4
    q, kp, vp, tables, lens = _case(81, nh, nkv, hd, bs, mb, [0, 0])
    kw, vw = _windows(kp, vp, tables)
    runs = decode_split(0, mb, bs, 8, 2)
    assert sum(b > a for a, b in runs) == 1
    got = _decode_emulation(q, kw, vw, lens, hd ** -0.5, 8, 2, bs, mb)
    np.testing.assert_allclose(got, _jax(q, kp, vp, tables, lens), atol=TOL,
                               rtol=TOL)
    # one token: the output is its V row, for every query head
    np.testing.assert_allclose(
        got[0], np.broadcast_to(vp[tables[0, 0], 0, 0], (nh, hd)), atol=TOL)


@pytest.mark.parametrize("splits", [1, 2, 5, 8])
@pytest.mark.parametrize("ts", [1, 4, 16])
@pytest.mark.parametrize("bs,mb", [(8, 4), (64, 32)])
def test_decode_split_covers_each_live_token_once(splits, ts, bs, mb):
    """The Python mirror of the kernel's plan: the runs, in rank order,
    tile the live window 0..min(seq_len, mb * bs - 1) exactly, start at
    whole stages, and reach no position (so no page, no table entry) past
    the live one; ranks beyond the window's stages get an empty run."""
    for seq_len in [0, 1, bs - 1, bs, bs + 1, 3 * bs, mb * bs - 1,
                    mb * bs + 5]:
        n = min(seq_len, mb * bs - 1) + 1
        runs = decode_split(seq_len, mb, bs, splits, ts)
        assert len(runs) == splits
        covered = [t for a, b in runs for t in range(a, b)]
        assert covered == list(range(n))
        assert all(a % ts == 0 and a <= b <= n for a, b in runs)
        pages = {t // bs for t in covered}
        assert max(pages) == (n - 1) // bs
        units = -(-n // ts)
        assert sum(b > a for a, b in runs) == min(splits, units)


def test_decode_stage_tokens_fit_the_kernel_layout():
    """TS of every instance the kernel builds: at most 32 tokens, whole
    warps of 16-byte copies a stage, about 2 KB of K a stage (at least one
    key a group), as csrc/ragged_decode.cuh's static_asserts demand."""
    for hd in HEAD_DIMS:
        for nrep in GROUP_SIZES:
            for item in (4, 2, 1):
                ts = decode_stage_tokens(hd, item, nrep)
                g = min(32, hd * item // 8, max(8, nrep * hd // 32))
                assert ts % (32 // g) == 0 and 1 <= ts <= 32
                assert (ts * hd * item // 16) % 32 == 0
                assert 1024 <= ts * hd * item <= 4096
    assert decode_stage_tokens(128, 2, 1) == 8      # the serve's bf16 pool
    assert decode_stage_tokens(128, 1, 1) == 16     # its int8 pool
