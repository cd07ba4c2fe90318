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
