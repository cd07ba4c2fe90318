"""The port's fleet (paddle_tpu_torch/distributed/fleet/: the strategy,
the hybrid topology, fleet.init and its wrappers, the hybrid-parallel
utilities) against the JAX package's, on the CPU.

The topology's rank arithmetic is pure and is held to the reference's
for dp2 x mp2, pp2 x mp2 and dp4, exactly. One world of 4 ranks (gloo,
spawned; tests/torch_dist_cases.py) then runs fleet.init on dp2 x mp2,
dp4 (dp_degree=-1) and mp4, and a mismatched one: each rank's degrees,
coordinates, axis groups and comm lists must be the reference topology's
at that rank (global rank r is the reference's mesh position r); the
int8 all-reduce over each axis group must give the reference's body over
the group's rows (within one quantization step, at least 99.9 % equal:
the group rank, not the global rank, picks the scale rows); the wrappers
and the broadcast / gradient helpers move the values the groups say.
``validate()``'s rejections are the reference's, word for word, and each
knob of a later slice raises NotImplementedError naming itself.
"""
import numpy as np
import pytest

import paddle_tpu as pt  # noqa: F401  (installs the JAX shims first)
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from paddle_tpu.distributed import collective as JC
from paddle_tpu.distributed.fleet import DistributedStrategy as JStrategy
from paddle_tpu.distributed.fleet.topology import \
    CommunicateTopology as JTopo

import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet.topology import \
    CommunicateTopology as TTopo

import torch_dist_cases as cases

N = 4
NAMES = ["data", "pipe", "sharding", "expert", "sep", "model"]
CONFIGS = {
    "dp2_mp2": {"dp_degree": 2, "mp_degree": 2, "pp_degree": 1},
    "dp4": {"dp_degree": -1, "mp_degree": 1, "pp_degree": 1},
    "mp4": {"dp_degree": 1, "mp_degree": 4, "pp_degree": 1},
    "mismatch": {"dp_degree": 3, "mp_degree": 1, "pp_degree": 1},
}
DIMS = {"dp2_mp2": [2, 1, 1, 1, 1, 2], "dp4": [4, 1, 1, 1, 1, 1],
        "mp4": [1, 1, 1, 1, 1, 4]}
AXIS_OF = {"dp": "data", "mp": "model", "pp": "pipe",
           "sharding": "sharding", "sep": "sep", "ep": "expert"}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(11)
    payload = {"configs": CONFIGS,
               "int8": rng.standard_normal((N, 37, 5)).astype(np.float32)}
    return payload, cases.run_world(N, "fleet", payload,
                                    tmp_path_factory.mktemp("fleet"))


# -- the topology's arithmetic, against the reference's -----------------------
@pytest.mark.parametrize("names,dims", [
    (NAMES, [2, 1, 1, 1, 1, 2]),                 # dp2 x mp2
    (NAMES, [1, 2, 1, 1, 1, 2]),                 # pp2 x mp2
    (NAMES, [4, 1, 1, 1, 1, 1]),                 # dp4
    (["data", "pipe", "sharding", "sep", "model"], [2, 2, 1, 1, 2])])
def test_topology_matches_the_reference(names, dims):
    ref, got = JTopo(names, dims), TTopo(names, dims)
    assert got.world_size() == ref.world_size()
    assert got.get_hybrid_group_names() == ref.get_hybrid_group_names()
    for nm in names:
        assert got.get_dim(nm) == ref.get_dim(nm)
        assert got.get_comm_list(nm) == ref.get_comm_list(nm)
        for i in range(got.get_dim(nm)):
            assert got.get_axis_list(nm, i) == ref.get_axis_list(nm, i)
    for r in range(got.world_size()):
        assert tuple(got.get_coord(r)) == tuple(ref.get_coord(r))
        coord = ref.get_coord(r)._asdict()
        assert got.get_rank(**coord) == ref.get_rank(**coord) == r
        assert got.get_rank_from_stage(r, data=0) == \
            ref.get_rank_from_stage(r, data=0)


@pytest.mark.parametrize("config", ["dp2_mp2", "dp4", "mp4"])
def test_hybrid_groups_match_the_reference_topology(world, config):
    _, results = world
    ref = JTopo(NAMES, DIMS[config])
    for r, res in enumerate(results):
        v = res["views"][config]
        c = ref.get_coord(r)
        assert v["names"] == NAMES
        assert v["degrees"] == tuple(ref.get_dim(nm) for nm in (
            "data", "model", "pipe", "sharding", "sep", "expert"))
        assert v["ranks"] == (c.data, c.model, c.pipe, c.sharding)
        assert v["comm_lists"] == {nm: ref.get_comm_list(nm)
                                   for nm in NAMES}
        for axis, (ranks, grank) in v["groups"].items():
            mine = [g for g in ref.get_comm_list(AXIS_OF[axis]) if r in g]
            assert [ranks] == mine and grank == ranks.index(r)
        assert v["src"] == (v["groups"]["dp"][0][0],
                            v["groups"]["mp"][0][0])
        assert v["stages"] == (True, True)
        assert v["worker"] == (N, r, r == 0)


def test_degrees_must_multiply_to_the_world(world):
    _, results = world
    for res in results:
        kind, msg = res["views"]["mismatch"]
        assert kind == "ValueError" and "multiply to the world" in msg


@pytest.mark.parametrize("config", ["dp2_mp2", "dp4", "mp4"])
@pytest.mark.parametrize("axis", ["dp", "mp"])
def test_int8_over_each_axis_group_matches_jax(world, config, axis):
    """The reference's test at tests/test_quantized_collectives.py:178:
    the int8 body over a group that is not the world must read the scale
    rows of the rank's place in that group."""
    payload, results = world
    x = payload["int8"]
    for r, res in enumerate(results):
        v = res["views"][config]
        ranks, grank = v["groups"][axis]
        n = len(ranks)
        mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
        ref = np.asarray(JC._eager_runner(
            mesh, ("x",), "all_reduce", (JC.ReduceOp.SUM, "int8", n))(
                jnp.asarray(x[ranks])))[grank]
        got = v[f"int8:{axis}"]
        step = np.abs(x[ranks]).max() / 127 + np.abs(ref).max() / 127
        assert np.abs(got - ref).max() <= step
        assert (got == ref).mean() >= 0.999


@pytest.mark.parametrize("config", ["dp2_mp2", "dp4", "mp4"])
def test_wrappers_and_hybrid_helpers(world, config):
    _, results = world
    views = [res["views"][config] for res in results]
    dp_src = [v["src"][0] for v in views]
    mp_src = [v["src"][1] for v in views]
    for r, v in enumerate(views):
        mp = v["degrees"][1]
        assert v["wrapper"] == ("TensorParallel" if mp > 1
                                else "DataParallel")
        # the wrap's broadcast: DataParallel over dp; TensorParallel over
        # mp from the mp group's first rank, then over dp
        src = mp_src[dp_src[r]] if mp > 1 else dp_src[r]
        assert [float(p.reshape(-1)[0]) for p in v["params_after_wrap"]] \
            == [100 * src + i for i in range(4)]
        assert v["after_dp_broadcast"] == [100 * dp_src[r] + i
                                           for i in range(4)]
        assert v["after_mp_broadcast"] == [100 * dp_src[mp_src[r]] + i
                                           for i in range(4)]
        members = v["groups"]["dp"][0]
        assert v["fused_grads"] == [np.mean([m + i for m in members])
                                    for i in range(4)]


def test_validate_rejections_match_the_reference():
    for knob, value in (("grad_compress", "int8"), ("grad_bucket_mb", 4)):
        ref, got = JStrategy(), fleet.DistributedStrategy()
        for s in (ref, got):
            setattr(s, knob, value)
        with pytest.raises(ValueError) as je:
            ref.validate()
        with pytest.raises(ValueError) as te:
            got.validate()
        assert str(te.value) == str(je.value)
    ref, got = JStrategy(), fleet.DistributedStrategy()
    for s in (ref, got):
        s.grad_compress = "fp8"
        s.hybrid_configs = {"dp_degree": 2}
    with pytest.raises(ValueError) as je:
        ref.validate()
    with pytest.raises(ValueError) as te:
        got.validate()
    assert str(te.value) == str(je.value)
    ok = fleet.DistributedStrategy()
    ok.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}
    ok.grad_compress, ok.grad_bucket_mb = "bf16", 8
    assert ok.validate() is ok


@pytest.mark.parametrize("knob,value", [
    ("mp_overlap", True), ("mp_activation_compress", "int8"),
    ("dispatch_compress", "int8"), ("matmul_quant", "int8"),
    ("sharding_degree", 2), ("sep_degree", 2), ("ep_degree", 2)])
def test_later_slice_knobs_raise_and_name_themselves(knob, value):
    """The knobs of later slices raise NotImplementedError naming
    themselves; sharding_degree, ep_degree and dispatch_compress are
    ported: they raise only combined with tensor parallelism (or, for
    dispatch_compress, validate as the reference's rules say); mp_overlap,
    mp_activation_compress and matmul_quant are ported: they validate at
    mp 2 and an incoherent setting raises the reference's ValueError."""
    s = fleet.DistributedStrategy()
    if knob.endswith("_degree"):
        s.hybrid_configs = {knob: value}
    else:
        setattr(s, knob, value)
    if knob in ("mp_overlap", "mp_activation_compress", "matmul_quant"):
        s.hybrid_configs = {"mp_degree": 2}
        s.mp_overlap = True
        assert s.validate() is s
        # mp_overlap at mp 1; a codec without the rings; a bad dtype
        bad = {"mp_overlap": ({"mp_degree": 1}, {}),
               "mp_activation_compress": ({}, {"mp_overlap": False}),
               "matmul_quant": ({}, {"matmul_quant": "int4"})}[knob]
        ref = JStrategy()
        for st in (s, ref):
            st.hybrid_configs = {"mp_degree": 2, **bad[0]}
            for k, v in {knob: value, "mp_overlap": True, **bad[1]}.items():
                setattr(st, k, v)
        with pytest.raises(ValueError) as je:
            ref.validate()
        with pytest.raises(ValueError, match=knob) as te:
            s.validate()
        assert str(te.value) == str(je.value)
        return
    if knob in ("sharding_degree", "ep_degree", "dispatch_compress"):
        s.hybrid_configs = {"ep_degree": 2}
        assert s.validate() is s
        if knob == "dispatch_compress":
            s.hybrid_configs = {"ep_degree": 1}
            with pytest.raises(ValueError, match=knob):
                s.validate()
            return
        s.hybrid_configs = {"mp_degree": 2}
    with pytest.raises(NotImplementedError, match=knob):
        s.validate()


@pytest.mark.parametrize("knobs", [
    {"pp_degree": 2},
    {"pp_degree": 2, "pipeline_save_mode": "buffer"},
    {"pp_degree": 1, "pipeline_save_mode": "unroll"},
    {"pp_degree": 2, "pipeline_save_mode": "ring"}])
def test_pipeline_knobs_validate_as_the_reference(knobs):
    """pp_degree and pipeline_save_mode are ported: a coherent strategy
    validates, an incoherent one raises the reference's ValueError."""
    made = []
    for cls in (JStrategy, fleet.DistributedStrategy):
        s = cls()
        s.hybrid_configs = {"pp_degree": knobs["pp_degree"]}
        if "pipeline_save_mode" in knobs:
            s.pipeline_save_mode = knobs["pipeline_save_mode"]
        made.append(s)
    ref, got = made
    try:
        ref.validate()
    except ValueError as e:
        with pytest.raises(ValueError) as te:
            got.validate()
        assert str(te.value) == str(e)
    else:
        assert got.validate() is got


@pytest.mark.parametrize("call", ["apply_plan", "split", "ps_entry",
                                  "role_maker"])
def test_later_slice_entries_raise(call):
    with pytest.raises(NotImplementedError):
        if call == "apply_plan":
            fleet.apply_plan(object())
        elif call == "split":
            dist.split(None, (4, 4), "linear")
        elif call == "ps_entry":
            dist.ProbabilityEntry(0.5)
        else:
            fleet.init(role_maker=object())
