"""The port's collectives (paddle_tpu_torch/distributed/collective.py)
against the JAX package's, on the CPU.

One world of 2 ranks and one of 4 (gloo, spawned, FileStore; the rank side
is tests/torch_dist_cases.py) run every call of the API once; each test
below holds one call's per-rank results against the JAX package's
stacked call on a mesh of the first n virtual devices (its
``_eager_runner`` over the same bodies the reference's eager collectives
run): port rank r took row r of the stacked input and must give row r of
the stacked output.

Tolerances, and why:
- integer-valued float32 inputs and int32 inputs: equal (every sum is
  exact in both);
- one random float32 all-reduce: 1e-6 relative (the backends sum in
  different orders);
- the compressed wires (int8 and bf16, all_reduce, reduce_scatter,
  alltoall): each element within one quantization step of the JAX output
  (int8: the largest input over 127 for the reduce stage plus the largest
  output over 127 for the gather stage; bf16: 2^-7 of the largest output)
  and at least 99.9 % of the elements equal: both sides compute the same
  codes from the same float32 arithmetic, so they differ only where a
  float32 sum of another order lands on a rounding tie;
- the codecs without a world: codes and scales equal to the JAX codec's
  under jit, the form every reference consumer (collectives, grad
  buckets, the MoE wire) runs it in: there XLA folds scale = blockmax /
  127 into a multiply by float32(1 / 127), which the port does too;
- the reference's error-bound tests, repeated on the port's world of 4:
  their own bounds with n = 4.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt  # noqa: F401  (installs the JAX shims first)
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from paddle_tpu.distributed import collective as JC

from paddle_tpu_torch.distributed import collective as TC

import torch_dist_cases as cases

WORLDS = (2, 4)
SUM, MAX, MIN, PROD, AVG = (JC.ReduceOp.SUM, JC.ReduceOp.MAX,
                            JC.ReduceOp.MIN, JC.ReduceOp.PROD,
                            JC.ReduceOp.AVG)
OPS = {"sum": SUM, "max": MAX, "min": MIN, "prod": PROD, "avg": AVG}
BOUND_SHAPES = [(4096,), (1000,), (13, 7), (8, 33)]


def _payload(n):
    rng = np.random.default_rng(100 + n)

    def ints(*s):
        return rng.integers(-4, 5, (n,) + s).astype(np.float32)

    def randn(*s):
        return rng.standard_normal((n,) + s).astype(np.float32)

    p = {
        "all_reduce": {"f:sum": ints(5, 3), "f:max": ints(7),
                       "f:min": ints(7), "f:prod": ints(6),
                       "f:avg": ints(4, 2) * n, "r:sum": randn(33),
                       "i:sum": rng.integers(-100, 100, (n, 9))
                       .astype(np.int32),
                       "i:avg": rng.integers(-100, 100, (n, 9))
                       .astype(np.int32),
                       "i:max": rng.integers(-100, 100, (n, 9))
                       .astype(np.int32)},
        "compressed": {"all_reduce:int8:sum:a": randn(1000),
                       "all_reduce:int8:avg:a": randn(37, 5),
                       "all_reduce:bf16:sum:a": randn(500),
                       "all_reduce:bf16:avg:a": randn(3, 70),
                       "reduce_scatter:int8:sum:a": randn(2 * n, 33),
                       "reduce_scatter:int8:avg:a": randn(2 * n, 5, 7),
                       "reduce_scatter:bf16:sum:a": randn(2 * n, 33),
                       "alltoall:int8:sum:a": randn(2 * n, 300),
                       "alltoall:bf16:sum:a": randn(2 * n, 30)},
        "gather": ints(3, 4),
        "reduce_scatter": {"f:sum": ints(2 * n, 3),
                           "f:avg": ints(2 * n, 3) * n,
                           "i:avg": rng.integers(0, 1000, (n, 2 * n))
                           .astype(np.int32)},
        "scatter": randn(3, 4),
        "alltoall": ints(2 * n, 3),
        "wire": randn(5, 70),
    }
    if n == 4:
        p["bounds"] = {}
        for i, shape in enumerate(BOUND_SHAPES):
            x = randn(*shape)
            for dt in ("float32", "bfloat16"):
                p["bounds"][f"all_reduce:int8:{dt}:{i}"] = x
        for i, shape in enumerate([(2 * n, 3), (n * 5, 11)]):
            p["bounds"][f"reduce_scatter:int8:float32:{i}"] = randn(*shape)
        p["bounds"]["all_reduce:bf16:float32:0"] = randn(500)
    return p


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    payloads = {n: _payload(n) for n in WORLDS}
    handles = {n: cases.start_world(n, "collectives", payloads[n], tmp)
               for n in WORLDS}
    return {n: (payloads[n], cases.finish_world(handles[n]))
            for n in WORLDS}


def _jax(n, fn_key, extra, x):
    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
    out = JC._eager_runner(mesh, ("x",), fn_key, tuple(extra))(
        jnp.asarray(x))
    return np.asarray(out)


def _rows(results, key):
    return [r[key] for r in results]


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("key", ["f:sum", "f:max", "f:min", "f:prod",
                                 "f:avg", "r:sum", "i:sum", "i:avg",
                                 "i:max"])
def test_all_reduce_matches_jax(worlds, n, key):
    payload, results = worlds[n]
    x = payload["all_reduce"][key]
    ref = _jax(n, "all_reduce", (OPS[key.split(":")[1]], None, n), x)
    for r, got in enumerate(_rows(results, f"all_reduce:{key}")):
        assert got.dtype == ref.dtype
        if key.startswith("r:"):
            np.testing.assert_allclose(got, ref[r], rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(got, ref[r])


def _int8_step(inputs, ref):
    return np.abs(inputs).max() / 127.0 + np.abs(ref).max() / 127.0


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("key", ["all_reduce:int8:sum:a",
                                 "all_reduce:int8:avg:a",
                                 "all_reduce:bf16:sum:a",
                                 "all_reduce:bf16:avg:a",
                                 "reduce_scatter:int8:sum:a",
                                 "reduce_scatter:int8:avg:a",
                                 "reduce_scatter:bf16:sum:a",
                                 "alltoall:int8:sum:a",
                                 "alltoall:bf16:sum:a"])
def test_compressed_wires_match_jax(worlds, n, key):
    """The two-stage int8 and bf16 bodies against the reference's bodies
    under shard_map."""
    payload, results = worlds[n]
    x = payload["compressed"][key]
    api, comp, opname, _ = key.split(":", 3)
    fn_key = {"alltoall": "all_to_all"}.get(api, api)
    extra = (0, 0, comp, n) if api == "alltoall" else (OPS[opname], comp, n)
    ref = _jax(n, fn_key, extra, x)
    step = _int8_step(x, ref) if comp == "int8" \
        else 2.0 ** -7 * np.abs(ref).max()
    for r, got in enumerate(_rows(results, f"compressed:{key}")):
        assert got.shape == ref[r].shape and got.dtype == ref.dtype
        assert np.abs(got - ref[r]).max() <= step, key
        assert (got == ref[r]).mean() >= 0.999, (key, (got == ref[r]).mean())
    # the wire is really compressed: the result is not the exact sum
    if api != "alltoall":
        exact = _jax(n, fn_key, (OPS[opname], None, n), x)
        assert not np.array_equal(ref, exact)


@pytest.mark.parametrize("n", WORLDS)
def test_all_gather_and_gather(worlds, n):
    payload, results = worlds[n]
    x = payload["gather"]
    stacked = _jax(n, "all_gather", (None,), x)        # [n, n, 3, 4]
    cat = _jax(n, "all_gather", (1,), x)               # [n, 3, 4n]
    for r, res in enumerate(results):
        np.testing.assert_array_equal(res["all_gather:list"], stacked[r])
        np.testing.assert_array_equal(res["gather"], stacked[r])
        np.testing.assert_array_equal(res["all_gather:axis1"], cat[r])
        assert res["all_gather_object"] == [
            {"rank": i, "sq": i * i} for i in range(n)]


@pytest.mark.parametrize("n", WORLDS)
def test_reduce_to_dst(worlds, n):
    payload, results = worlds[n]
    ref = _jax(n, "reduce", (SUM, 1), payload["gather"])
    for r, got in enumerate(_rows(results, "reduce:dst1")):
        np.testing.assert_array_equal(got, ref[r])


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("key", ["f:sum", "f:avg", "i:avg"])
def test_reduce_scatter_matches_jax(worlds, n, key):
    """The tensor input and the list input (one tensor a rank)."""
    payload, results = worlds[n]
    ref = _jax(n, "reduce_scatter", (OPS[key.split(":")[1]], None, n),
               payload["reduce_scatter"][key])
    for r, res in enumerate(results):
        for form in ("reduce_scatter", "reduce_scatter_list"):
            got = res[f"{form}:{key}"]
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref[r])


@pytest.mark.parametrize("n", WORLDS)
def test_broadcast_and_scatter(worlds, n):
    payload, results = worlds[n]
    bref = _jax(n, "broadcast", (n - 1,), payload["gather"])
    # the reference's scatter body reads the src rank's [n, ...] list
    lists = np.broadcast_to(payload["scatter"][None],
                            (n,) + payload["scatter"].shape)
    sref = _jax(n, "scatter", (0,), lists)
    for r, res in enumerate(results):
        np.testing.assert_array_equal(res["broadcast:src_last"], bref[r])
        np.testing.assert_array_equal(res["scatter:src0"], sref[r])


@pytest.mark.parametrize("n", WORLDS)
def test_alltoall_matches_jax(worlds, n):
    payload, results = worlds[n]
    ref = _jax(n, "all_to_all", (0, 0, None, n), payload["alltoall"])
    for r, res in enumerate(results):
        np.testing.assert_array_equal(res["alltoall:list"], ref[r])
        np.testing.assert_array_equal(res["alltoall_single"], ref[r])


@pytest.mark.parametrize("n", WORLDS)
def test_p2p_rings_match_ppermute(worlds, n):
    """send/recv and batch_isend_irecv rings against the reference's
    collective_permute bodies."""
    payload, results = worlds[n]
    x = payload["gather"]
    fwd = _jax(n, "ppermute", (tuple((i, (i + 1) % n) for i in range(n)),),
               x)
    back = _jax(n, "ppermute", (tuple((i, (i - 1) % n) for i in range(n)),),
                2 * x)
    for r, res in enumerate(results):
        np.testing.assert_array_equal(res["ring:send_recv"], fwd[r])
        np.testing.assert_array_equal(res["ring:batch_fwd"], fwd[r])
        np.testing.assert_array_equal(res["ring:batch_back"], back[r])
        np.testing.assert_array_equal(res["ring:irecv"], 3 * fwd[r])
        assert res["get_group"] == list(range(n))


@pytest.mark.parametrize("n", WORLDS)
def test_p2p_of_cpu_tensors_is_not_staged(worlds, n):
    """gloo moves CPU tensors as they are: the host-staging counter of the
    p2p calls stays 0 through the rings above."""
    for res in worlds[n][1]:
        assert res["p2p_host_staged"] == {"bytes": 0, "calls": 0}


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("compress", [None, "bf16", "int8"])
def test_wire_ppermute_matches_jax(worlds, n, compress):
    """One ring hop under the wire codec against the reference's
    wire_ppermute under shard_map: the payload encoded once at the
    source, equal on arrival."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    payload, results = worlds[n]
    x = payload["wire"]
    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
    ring = tuple((i, (i + 1) % n) for i in range(n))
    f = jax.jit(shard_map(
        lambda a: JC.wire_ppermute(a[0], "x", ring, compress)[None],
        mesh=mesh, in_specs=P("x"), out_specs=P("x"), check_vma=False))
    ref = np.asarray(f(jnp.asarray(x)))
    for r, res in enumerate(results):
        np.testing.assert_array_equal(res[f"wire_ppermute:{compress}"],
                                      ref[r])


@pytest.mark.parametrize("n", WORLDS)
def test_new_group_subsets(worlds, n):
    """An all_reduce over the even ranks against the reference's
    explicit-ranks emulation; members only, others keep their tensor."""
    payload, results = worlds[n]
    x = payload["gather"]
    evens = list(range(0, n, 2))
    g = JC.Group(("world",), ranks=evens)
    ref = np.asarray(JC._emulate("all_reduce", (jnp.asarray(x[evens]),), g,
                                 (SUM,)))
    for r, res in enumerate(results):
        want = ref[evens.index(r)] if r in evens else x[r]
        np.testing.assert_array_equal(res["subgroup:evens"], want)
        assert res["subgroup:evens_rank"] == (evens.index(r)
                                              if r in evens else -1)
        np.testing.assert_array_equal(res["subgroup:last"], x[r])


@pytest.mark.parametrize("n", WORLDS)
def test_async_tasks_and_stream(worlds, n):
    payload, results = worlds[n]
    x = payload["gather"]
    avg = _jax(n, "all_reduce", (AVG, None, n), x)
    tot = _jax(n, "all_reduce", (SUM, None, n), x)
    for r, res in enumerate(results):
        np.testing.assert_array_equal(res["async:avg"], avg[r])
        np.testing.assert_array_equal(res["stream:sum"], tot[r])


@pytest.mark.parametrize("n", WORLDS)
def test_object_collectives_and_world(worlds, n):
    _, results = worlds[n]
    for r, res in enumerate(results):
        assert res["broadcast_object_list"] == [1, "from 1"]
        assert res["scatter_object_list"] == [f"o{2 * r}", f"o{2 * r + 1}"]
        assert res["world"] == (r, n, "GLOO", True)


class _RefGroup:
    _ranks = None


@pytest.mark.parametrize("key", ["int", "op", "codec", "rs_op",
                                 "explicit"])
def test_compress_rejections_match_the_reference(worlds, key):
    """_check_compress's rejections, word for word."""
    xf = jnp.ones((4,), jnp.float32)
    explicit = JC.Group(("world",), ranks=[0, 2])
    ref_calls = {
        "int": lambda: JC._check_compress("int8", SUM,
                                          jnp.ones((4,), jnp.int32),
                                          _RefGroup(), "all_reduce"),
        "op": lambda: JC._check_compress("int8", MAX, xf, _RefGroup(),
                                         "all_reduce"),
        "codec": lambda: JC._check_compress("fp8", SUM, xf, _RefGroup(),
                                            "all_reduce"),
        "rs_op": lambda: JC._check_compress("bf16", MIN, xf, _RefGroup(),
                                            "reduce_scatter"),
        "explicit": lambda: JC._check_compress("int8", SUM, xf, explicit,
                                               "all_reduce")}
    with pytest.raises((ValueError, NotImplementedError)) as e:
        ref_calls[key]()
    for n in WORLDS:
        for res in worlds[n][1]:
            assert res["rejections"][key] == (type(e.value).__name__,
                                              str(e.value))


# -- the codecs, without a world ---------------------------------------------
@pytest.mark.parametrize("shape,scale", [((4, 256), 1.0), ((1024,), 1e-3),
                                         ((3, 512), 50.0)])
def test_quantize_blockwise_int8_matches_jax(shape, scale):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    x.reshape(-1)[:256] = 0.0                   # an all-zero block: scale 1
    x.reshape(-1)[300] = 127.5 * scale          # an outlier sets a block
    quant = jax.jit(JC.quantize_blockwise_int8)
    jq, js = quant(jnp.asarray(x.reshape(-1)))
    tq, ts = TC.quantize_blockwise_int8(torch.from_numpy(x.reshape(-1)))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jd = JC.dequantize_blockwise_int8(jq, js)
    td = TC.dequantize_blockwise_int8(tq, ts)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    amax = np.abs(x.reshape(-1, 256)).max(1) * 2
    jq2, js2 = quant(jnp.asarray(x.reshape(-1)),
                     shared_amax=jnp.asarray(amax))
    tq2, ts2 = TC.quantize_blockwise_int8(torch.from_numpy(x.reshape(-1)),
                                          shared_amax=torch.from_numpy(amax))
    np.testing.assert_array_equal(tq2.numpy(), np.asarray(jq2))
    np.testing.assert_array_equal(ts2.numpy(), np.asarray(js2))


@pytest.mark.parametrize("compress", [None, "bf16", "int8"])
def test_wire_encode_decode_matches_jax(compress):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((7, 45)).astype(np.float32)
    jparts = jax.jit(JC.encode_wire, static_argnums=1)(jnp.asarray(x),
                                                       compress)
    tparts = TC.encode_wire(torch.from_numpy(x), compress)
    assert len(jparts) == len(tparts)
    for j, t in zip(jparts, tparts):
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j.astype(jnp.float32)))
    jd = JC.decode_wire(jparts, compress, x.shape, jnp.float32)
    td = TC.decode_wire(tparts, compress, x.shape, torch.float32)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    flat, L = TC._pad_flat(torch.from_numpy(x), 256)
    jflat, jL = JC._pad_flat(jnp.asarray(x), 256)
    assert L == jL
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))


# -- the reference's error-bound tests on the port (world 4) -----------------
@pytest.mark.parametrize("i", range(len(BOUND_SHAPES)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_all_reduce_error_bound(worlds, i, dtype):
    """|out - exact| <= (n blockmax_in + blockmax_sum) / 254 per element
    (tests/test_quantized_collectives.py's bound), tails included."""
    payload, results = worlds[4]
    key = f"all_reduce:int8:{dtype}:{i}"
    x = payload["bounds"][key]
    xin = x if dtype == "float32" else \
        np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    exact = xin.sum(0)
    bound = (4 * np.abs(x).max() + np.abs(exact).max()) / 254.0
    if dtype == "bfloat16":
        bound += np.abs(exact).max() * 0.01       # bf16 storage rounding
    for res in results:
        err = np.abs(res["bounds"][key] - exact).max()
        assert err <= bound * 1.05, (err, bound)


@pytest.mark.parametrize("i", range(2))
def test_int8_reduce_scatter_error_bound(worlds, i):
    payload, results = worlds[4]
    key = f"reduce_scatter:int8:float32:{i}"
    x = payload["bounds"][key]
    exact = x.sum(0).reshape((4, x.shape[1] // 4) + x.shape[2:])
    bound = 4 * np.abs(x).max() / 254.0
    for r, res in enumerate(results):
        err = np.abs(res["bounds"][key] - exact[r]).max()
        assert 0 < err <= bound * 1.05, (err, bound)


def test_bf16_compress_error(worlds):
    payload, results = worlds[4]
    x = payload["bounds"]["all_reduce:bf16:float32:0"]
    exact = x.sum(0)
    for res in results:
        got = res["bounds"]["all_reduce:bf16:float32:0"]
        assert np.abs(got - exact).max() <= \
            4 * np.abs(exact).max() / 256.0 + 1e-3


@pytest.mark.parametrize("compress", ["int8", "bf16"])
@pytest.mark.parametrize("api", ["all_reduce", "reduce_scatter"])
def test_compressed_wires_at_one_rank_match_jax(compress, api):
    """One rank still quantizes (the reference's body over a one-device
    axis): the port's body over a one-rank group, which needs no world,
    gives the reference's result (chip_smoke's NCCL phase holds the card
    to this body)."""
    x = np.random.default_rng(9).standard_normal((37, 129)) \
        .astype(np.float32)
    local = TC.Group([0], None)
    t = torch.from_numpy(x.copy())
    if api == "all_reduce":
        TC.all_reduce(t, group=local, compress=compress)
    else:
        src, t = t, torch.empty_like(t)
        TC.reduce_scatter(t, src, group=local, compress=compress)
    ref = _jax(1, api, (SUM, compress, 1), x[None])[0]
    np.testing.assert_array_equal(t.numpy(), ref)
    assert not np.array_equal(ref, x)


# -- the store, the environment and the constants, without a world -----------
def test_tcp_store_api(monkeypatch):
    from paddle_tpu_torch.distributed import TCPStore
    store = TCPStore("127.0.0.1", 0, is_master=True, world_size=1,
                     timeout=5)
    assert store.port > 0
    store.set("k", "v")
    assert store.get("k") == b"v"
    assert store.add("n", 2) == 2 and store.add("n", 3) == 5
    assert store.check("k") and not store.check("absent")
    store.wait("k")
    with pytest.raises(TimeoutError):
        store.get("absent", timeout=0.2)
    store.delete_key("k")
    assert not store.check("k")
    assert store.num_keys() >= 1
    store.barrier("b")
    client = TCPStore("127.0.0.1", store.port, world_size=1, timeout=5)
    assert client.get("n") == b"5"
    with pytest.raises(ValueError, match="explicit port"):
        TCPStore("127.0.0.1", 0)
    with pytest.raises(NotImplementedError):
        TCPStore(is_master=True, use_native=True)


def test_parallel_env_contract_and_constants(monkeypatch):
    from paddle_tpu.distributed import misc as JM
    from paddle_tpu.distributed.env import ParallelEnv as JEnv
    import paddle_tpu_torch.distributed as dist
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "8")
    monkeypatch.setenv("FLAGS_selected_gpus", "1")
    monkeypatch.setenv("PADDLE_MASTER", "10.0.0.1:6170")
    got, ref = dist.ParallelEnv(), JEnv()
    for k in ("rank", "world_size", "device_id", "nranks", "local_rank",
              "current_endpoint", "trainer_endpoints"):
        assert getattr(got, k) == getattr(ref, k), k
    assert got._coordinator == ref._coordinator == "10.0.0.1:6170"
    assert dist.get_rank() == 3 and dist.get_world_size() == 8
    assert not dist.is_initialized() and dist.is_available()
    for cls in ("ParallelMode", "ReduceType"):
        ours, theirs = getattr(dist, cls), getattr(JM, cls)
        names = [k for k in vars(theirs) if not k.startswith("_")]
        assert names and all(getattr(ours, k) == getattr(theirs, k)
                             for k in names)
    assert [getattr(dist.ReduceOp, k) for k in
            ("SUM", "MAX", "MIN", "PROD", "AVG")] == \
        [getattr(JC.ReduceOp, k) for k in ("SUM", "MAX", "MIN", "PROD",
                                            "AVG")]


def test_rng_tracker_drives_dropout_in_its_region():
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        RNGStatesTracker, model_parallel_random_seed, get_rng_state_tracker)
    from paddle_tpu_torch.nn import Dropout
    tracker = RNGStatesTracker()
    tracker.add("mp", 11, device="cpu")
    with pytest.raises(ValueError, match="seed"):
        tracker.add("other", 11, device="cpu")
    with pytest.raises(ValueError, match="does not exist"):
        with tracker.rng_state("absent"):
            pass
    own = torch.Generator().manual_seed(5)
    drop = Dropout(0.5, generator=own)
    x = torch.ones(64)
    with tracker.rng_state("mp"):
        inside = drop(x)
    want = Dropout(0.5, generator=torch.Generator().manual_seed(11))(x)
    assert torch.equal(inside, want)
    assert torch.equal(drop(x), Dropout(
        0.5, generator=torch.Generator().manual_seed(5))(x))
    assert model_parallel_random_seed(100, device="cpu") == 100
    assert get_rng_state_tracker().states_["model_parallel_rng"] \
        .initial_seed() == 100 + 1024
