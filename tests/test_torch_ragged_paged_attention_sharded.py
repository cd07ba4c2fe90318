"""The port's split-context (sharded) ragged paged attention against the
JAX package, on the CPU.

The port's partials wrapper runs its plain PyTorch version on a CPU
tensor; the JAX partials kernel (`_pkernel`) runs in Pallas interpret
mode, once per shard, as the JAX package runs it off the TPU. Both merge
the shards by the lse rescale. Tolerance: float32 atol = rtol = 1e-5 (the
softmax is summed in other orders); one shard against the unsharded plain
version 1e-6 (the same sums, normalised once more).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddle_tpu.kernels.pallas import ragged_paged_attention as jrpa

from paddle_tpu_torch.kernels.ragged_paged_attention import (
    ragged_paged_attention_partials, ragged_paged_attention_plain,
    ragged_paged_attention_sharded)

TOL = 1e-5


def _case(seed, nh, nkv, hd, bs, mb, lens):
    rng = np.random.default_rng(seed)
    S = len(lens)
    nb = S * mb + 1
    kp = rng.standard_normal((nb, bs, nkv, hd)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, nkv, hd)).astype(np.float32)
    q = rng.standard_normal((S, nh, hd)).astype(np.float32)
    tables = (rng.permutation(nb - 1)[:S * mb] + 1).reshape(S, mb).astype(
        np.int32)
    return q, kp, vp, tables, np.asarray(lens, np.int32)


def _t(args):
    return [torch.from_numpy(a) for a in args]


# mb 6, bs 8: a slot of one token (every shard past the first is empty),
# one ending on a block edge, one mid-span, one at full span
LENS = [0, 7, 8, 23, 30, 47]


@pytest.mark.parametrize("shards", [1, 2, 3])
@pytest.mark.parametrize("nh,nkv", [(4, 4), (4, 2)])
def test_sharded_matches_jax(shards, nh, nkv):
    args = _case(shards * 10 + nh + nkv, nh, nkv, 16, 8, 6, LENS)
    ref = np.asarray(jax.jit(
        jrpa.ragged_paged_attention_sharded, static_argnums=(5,))(
        *(jnp.asarray(a) for a in args), shards))
    before = ragged_paged_attention_partials.launches
    out = ragged_paged_attention_sharded(*_t(args), shards).numpy()
    assert ragged_paged_attention_partials.launches == before
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shards", [2, 4])
def test_partials_match_jax_per_shard(shards):
    """Each shard's (o, lse) against JAX's `_ragged_partials_call` on the
    same sub-table; an empty shard gives o = 0 and lse ~ -1e30."""
    bs, mb = 8, 4
    args = _case(40 + shards, 4, 2, 16, bs, mb, [2, 9, 31])
    q, kp, vp, tables, lens = args
    o, lse = ragged_paged_attention_partials(*_t(args), shards)
    spb = -(-mb // shards)
    assert o.shape == (shards, 3, 4, 16) and lse.shape == (shards, 3, 4)
    for k in range(shards):
        lo, hi = k * spb, min((k + 1) * spb, mb)
        local = np.clip(lens + 1 - lo * bs, 0, (hi - lo) * bs) - 1
        jo, jl = jrpa._ragged_partials_call(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tables[:, lo:hi]), jnp.asarray(local, jnp.int32),
            16 ** -0.5)
        np.testing.assert_allclose(o[k].numpy(), np.asarray(jo), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(lse[k].numpy(), np.asarray(jl)[..., 0],
                                   atol=TOL, rtol=TOL)
        for s in np.where(local < 0)[0]:
            assert (o[k, s] == 0).all() and (lse[k, s] < -1e29).all()


def test_one_shard_is_the_unsharded_result():
    args = _t(_case(8, 4, 2, 16, 8, 6, LENS))
    one = ragged_paged_attention_sharded(*args, 1)
    plain = ragged_paged_attention_plain(*args, 16 ** -0.5)
    torch.testing.assert_close(one, plain, atol=1e-6, rtol=1e-6)


def test_shard_count_validation_matches_jax():
    args = _case(9, 4, 2, 16, 8, 3, [5, 17])
    for bad in (0, 4):
        with pytest.raises(ValueError):
            jrpa.ragged_paged_attention_sharded(
                *(jnp.asarray(a) for a in args), bad)
        with pytest.raises(ValueError):
            ragged_paged_attention_sharded(*_t(args), bad)


# -- the CUDA kernel's arithmetic, emulated on the CPU -------------------------
#
# The partials kernel is the decode body (csrc/ragged_decode.cuh) with the
# shard as the outer unit of its grid: each shard's live tokens, from the
# shard's first block, are cut into `splits` runs of whole stages of ts
# tokens (partials_split); a run's stages go to 4 warps in turn, each with
# an online softmax in the log2 domain (q pre-scaled by scale * log2 e, one
# exp2 a score); the warps merge in order, then the cluster's ranks in rank
# order, and the shard writes o = acc / max(L, 1e-30) and lse = M ln 2 +
# ln L (-1e30 + ln 1e-30 for an empty shard). The emulation below does the
# same in float32 with torch and is held, shard by shard, to JAX's
# `_ragged_partials_call` in interpret mode at the float32 tolerance above.

import functools  # noqa: E402

from paddle_tpu_torch.kernels.ragged_paged_attention import (  # noqa: E402
    decode_split, partials_split)

NEG = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def _merge2(parts):
    """Online-softmax states (m [R], l [R], acc [R, hd]), scores in the
    log2 domain, merged in order."""
    m = torch.stack([p[0] for p in parts]).amax(0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for pm, pl_, pa in parts:
        f = torch.exp2(pm - m)
        l = l + pl_ * f
        acc = acc + pa * f[:, None]
    return m, l, acc


def _partials_emulation(q, kw, vw, lens, scale, shards, splits, ts, bs, mb,
                        warps=4):
    """(o [K, S, nh, hd], lse [K, S, nh]) as the kernel computes them, in
    float32. kw, vw [S, W, nkv, hd]: each slot's window gathered through
    its whole table."""
    q = torch.as_tensor(q, dtype=torch.float32)
    kw = torch.as_tensor(kw, dtype=torch.float32)
    vw = torch.as_tensor(vw, dtype=torch.float32)
    S, nh, hd = q.shape
    nkv = kw.shape[2]
    nrep = nh // nkv
    spb = -(-mb // shards)
    qs = q * (torch.tensor(scale, dtype=torch.float32)
              * torch.tensor(LOG2E, dtype=torch.float32))
    plans = [partials_split(int(lens[s]), mb, bs, shards, splits, ts)
             for s in range(S)]
    K = len(plans[0])
    o = torch.zeros(K, S, nh, hd)
    lse = torch.zeros(K, S, nh)
    for s in range(S):
        for z, runs in enumerate(plans[s]):
            base = z * spb * bs
            for g in range(nkv):
                hs = slice(g * nrep, (g + 1) * nrep)
                ranks = []
                for a, b in runs:
                    state = [(torch.full((nrep,), NEG), torch.zeros(nrep),
                              torch.zeros(nrep, hd)) for _ in range(warps)]
                    for i, t0 in enumerate(range(a, b, ts)):
                        rows = slice(base + t0, base + min(t0 + ts, b))
                        sc = qs[s, hs] @ kw[s, rows, g].T       # [R, T]
                        m, l, acc = state[i % warps]
                        m_new = torch.maximum(m, sc.amax(1))
                        alpha = torch.exp2(m - m_new)
                        p = torch.exp2(sc - m_new[:, None])
                        state[i % warps] = (m_new, l * alpha + p.sum(1),
                                            acc * alpha[:, None]
                                            + p @ vw[s, rows, g])
                    ranks.append(_merge2(state))
                m, l, acc = _merge2(ranks)
                o[z, s, hs] = acc / l.clamp_min(1e-30)[:, None]
                lse[z, s, hs] = torch.where(
                    l > 0, m * LN2 + torch.log(l.clamp_min(1e-30)),
                    torch.tensor(NEG, dtype=torch.float32)
                    + torch.log(torch.tensor(1e-30, dtype=torch.float32)))
    return o.numpy(), lse.numpy()


# bs 4, mb 8: lengths at every page edge, a one-token slot, the whole table
EMU_BS, EMU_MB = 4, 8
EMU_LENS = [0] + [x for p in range(1, EMU_MB) for x in
                  (p * EMU_BS - 1, p * EMU_BS)] + [EMU_MB * EMU_BS - 1]


@functools.lru_cache(maxsize=None)
def _emu_case_and_jax(shards):
    """The emulation's inputs and JAX's per-shard (o, lse) on them."""
    args = _case(90, 4, 2, 16, EMU_BS, EMU_MB, EMU_LENS)
    q, kp, vp, tables, lens = args
    spb = -(-EMU_MB // shards)
    outs = []
    for lo in range(0, EMU_MB, spb):
        hi = min(lo + spb, EMU_MB)
        local = np.clip(lens + 1 - lo * EMU_BS, 0,
                        (hi - lo) * EMU_BS) - 1
        jo, jl = jrpa._ragged_partials_call(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tables[:, lo:hi]), jnp.asarray(local, jnp.int32),
            16 ** -0.5)
        outs.append((np.asarray(jo), np.asarray(jl)[..., 0]))
    return args, outs


@pytest.mark.parametrize("shards", [1, 2, 3, 8])
@pytest.mark.parametrize("splits", [1, 2, 8])
@pytest.mark.parametrize("ts", [2, 16])
def test_partials_emulation_matches_jax(shards, splits, ts):
    """Shards of 8, 4, 3 (the last of 2: mb % spb != 0) and 1 blocks; at 8
    splits more ranks than a shard's stages; empty shards at every
    length short of the last shard."""
    (q, kp, vp, tables, lens), ref = _emu_case_and_jax(shards)
    S = len(lens)
    kw = kp[tables].reshape(S, EMU_MB * EMU_BS, 2, 16)
    vw = vp[tables].reshape(S, EMU_MB * EMU_BS, 2, 16)
    o, lse = _partials_emulation(q, kw, vw, lens, 16 ** -0.5, shards,
                                 splits, ts, EMU_BS, EMU_MB)
    assert o.shape[0] == len(ref) == -(-EMU_MB // -(-EMU_MB // shards))
    for z, (jo, jl) in enumerate(ref):
        np.testing.assert_allclose(o[z], jo, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(lse[z], jl, atol=TOL, rtol=TOL)
    spb = -(-EMU_MB // shards)
    empty = np.asarray(lens)[None, :] < (np.arange(len(ref)) * spb
                                         * EMU_BS)[:, None]
    assert empty.any() == (shards > 1)
    assert (o[empty] == 0).all()
    assert (lse[empty] == np.float32(NEG)).all()


@pytest.mark.parametrize("shards", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("splits", [1, 2, 8])
@pytest.mark.parametrize("ts", [1, 4, 16])
@pytest.mark.parametrize("bs,mb", [(4, 8), (64, 64)])
def test_partials_split_tiles_each_shard_once(shards, splits, ts, bs, mb):
    """The Python mirror of the kernel's shard plan: each shard's runs, in
    rank order, tile exactly its live tokens (those of the global window
    0..min(seq_len, mb * bs - 1) in its blocks), start at whole stages,
    reach no page past the shard's live one (so no table entry past it);
    an empty shard gives every rank an empty run; the shards together
    cover the window once."""
    spb = -(-mb // shards)
    for seq_len in [0, 1, bs - 1, bs, bs + 1, spb * bs - 1, spb * bs,
                    spb * bs + 1, 3 * bs, mb * bs - 1, mb * bs + 5]:
        n_all = min(seq_len, mb * bs - 1) + 1
        plan = partials_split(seq_len, mb, bs, shards, splits, ts)
        assert len(plan) == -(-mb // spb)
        window = []
        for z, runs in enumerate(plan):
            b0, width = z * spb, min(spb, mb - z * spb)
            n = min(max(n_all - b0 * bs, 0), width * bs)
            assert len(runs) == splits
            covered = [t for a, b in runs for t in range(a, b)]
            assert covered == list(range(n))
            assert all(a % ts == 0 and a <= b <= n for a, b in runs)
            if n == 0:
                assert all(a == b == 0 for a, b in runs)
            else:
                assert max(t // bs for t in covered) == (n - 1) // bs
                assert (n - 1) // bs < width
                assert sum(b > a for a, b in runs) == min(splits,
                                                          -(-n // ts))
            window += [b0 * bs + t for t in covered]
        assert window == list(range(n_all))


def test_one_shard_plan_is_the_decode_plan():
    for seq_len in [0, 5, 63, 64, 2047, 4000]:
        assert partials_split(seq_len, 32, 64, 1, 8, 8) == \
            [decode_split(seq_len, 32, 64, 8, 8)]
