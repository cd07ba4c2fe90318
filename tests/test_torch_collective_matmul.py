"""The port's collective matmul against the JAX package's, on the CPU.

The JAX side runs ``cm_matmul`` (impl "overlap" and "reference", chunks
2) on the 8 virtual devices over meshes of 2 and 4 mp devices and a 2 x 2
(dp, mp) mesh, on global inputs (x [B, S, K], w [K, O], the cotangent g
of the output; B 2 (4 at dp 2), S 8, K = O = 64, float32), and takes
the output and the gradients of sum(y * g). The port runs the same calls
per rank in gloo worlds of 2 and 4 ranks (tests/torch_cm_cases.py): mp
2 and mp 4 through fleet's topology, dp 2 x mp 2 through a ProcessMesh.
Each rank's output and input gradient are held against the matching
shard of the JAX ones, and the sum over the dp ranks of a rank's weight
gradient against the JAX weight gradient's shard (the JAX one is summed
over dp inside its backward; the port's is not, so that the
data-parallel wrappers sum it once).

Tolerances, and why:
- the exact wire (either impl): 1e-5 relative and 1e-5 of each tensor's
  largest (float32, the products chunked and summed in other orders);
- "bf16" and "int8" wires: the output within the reference's error model
  of the exact output (collective_matmul.py's docstring: a block that
  travels a gather ring is encoded once, |err| <= blockmax / 254; the
  reduce-scatter accumulator n - 1 times, (n - 1) hopmax / 254; the
  matmul multiplies an input's error by at most the largest column sum
  of |w|), and against JAX's compressed ring within one code step of the
  largest (2^-8 bf16, 1/127 int8; two for gradients) with at most 1 % of
  the elements past 1e-5 of it (a value that differs by float noise
  before the codec may round to the neighbouring code); a codec lane must
  move more than half of the elements of the tensor its wire carries
  past 1e-5 of the largest from the exact lane;
- the bytes a rank's rings posted, as encoded, equal ``overlap_wire_plan``
  (sizes here are whole 256-value blocks, which the plan counts).
"""
import numpy as np
import pytest

import paddle_tpu as pt  # noqa: F401  (x64 and the shard_map shim)
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from paddle_tpu.distributed.fleet.meta_parallel import collective_matmul \
    as jcm
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    collective_matmul as tcm)

import torch_dist_cases as cases
from torch_cm_cases import LAYOUT, shard

B, S, K, O = 2, 8, 64, 64
CHUNKS = 2
TOL = 1e-5
CODEC_STEP = {"bf16": 2.0 ** -8, "int8": 1.0 / 127}
CODEC_FLIPS = 0.01
CODEC_MOVES = 0.5
CODECS = (None, "bf16", "int8")
KINDS = jcm.CM_KINDS


def _jobs():
    """Every call the worlds run: (kind, world, dp, impl, compress)."""
    jobs = []
    for world in (2, 4):
        for kind in KINDS:
            jobs.append((kind, world, 1, "reference", None))
            jobs += [(kind, world, 1, "overlap", c) for c in CODECS]
    for kind in ("column", "column_gather", "row"):
        jobs += [(kind, 4, 2, impl, None)
                 for impl in ("reference", "overlap")]
    return jobs


def _key(kind, world, dp, impl, comp):
    return f"{kind}:{world}:{dp}:{impl}:{comp}"


def _inputs(kind, dp, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B * dp, S, K)).astype(np.float32)
    w = (rng.standard_normal((K, O)) * 0.3).astype(np.float32)
    g = rng.standard_normal((B * dp, S, O)).astype(np.float32)
    return x, w, g


def _jax_run(kind, world, dp, variants, x, w, g):
    """JAX's (y, dx, dw) for each (impl, compress) of ``variants``, in one
    jitted function (one compile for the kind, world and dp)."""
    devs = np.array(jax.devices()[:world])
    mesh = Mesh(devs.reshape(dp, world // dp), ("dp", "mp")) if dp > 1 \
        else Mesh(devs, ("mp",))

    @jax.jit
    def each(x, w, g):
        out = []
        for impl, comp in variants:
            y, vjp = jax.vjp(lambda x, w: jcm.cm_matmul(
                x, w, mesh=mesh, axis="mp", kind=kind, chunks=CHUNKS,
                impl=impl, compress=comp), x, w)
            out.append((y,) + vjp(g))
        return out
    return [[np.asarray(a) for a in r] for r in each(x, w, g)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jobs, ref = {}, {}
    for i, (kind, world, dp, impl, comp) in enumerate(_jobs()):
        x, w, g = _inputs(kind, dp, 100 + KINDS.index(kind) + 10 * dp)
        jobs[_key(kind, world, dp, impl, comp)] = {
            "kind": kind, "world": world, "dp": dp, "impl": impl,
            "compress": comp, "chunks": CHUNKS, "x": x, "w": w, "g": g}
    rng = np.random.default_rng(7)
    payload = {"jobs": jobs, "layers": {
        "x": rng.standard_normal((2, 8, 64)).astype(np.float32),
        "compress": None}}
    tmp = tmp_path_factory.mktemp("cm")
    handles = {n: cases.start_world(n, "cm", payload, tmp,
                                    module="torch_cm_cases")
               for n in (2, 4)}
    groups = {}
    for key, j in jobs.items():
        groups.setdefault((j["kind"], j["world"], j["dp"]), []).append(key)
    for (kind, world, dp), keys in groups.items():
        j = jobs[keys[0]]
        variants = [(jobs[k]["impl"], jobs[k]["compress"]) for k in keys]
        for k, r in zip(keys, _jax_run(kind, world, dp, variants, j["x"],
                                       j["w"], j["g"])):
            ref[k] = r
    worlds = {n: cases.finish_world(h) for n, h in handles.items()}
    return jobs, ref, worlds


def _rank_of(res_world, world, dp, r):
    nm = world // dp
    return r // nm, r % nm, nm


def _local(job, full, what, d, m, nm):
    """The shard of a JAX result (y, dx or dw) this rank holds."""
    xd, wd, yd, dxd = LAYOUT[job["kind"]]
    if what == "dw":
        return shard(full, wd, nm, m)
    b = full.shape[0] // job["dp"]
    rows = full[d * b:(d + 1) * b]
    return shard(rows, yd if what == "y" else dxd, nm, m)


def _got(worlds, job, key, r, what):
    """A rank's result; the weight gradient summed over the dp ranks of
    its mp rank."""
    world, dp = job["world"], job["dp"]
    res = worlds[world]
    if what != "dw":
        return res[r]["jobs"][key][what]
    nm = world // dp
    m = r % nm
    return sum(res[d * nm + m]["jobs"][key]["dw"] for d in range(dp))


def _close(got, ref, what):
    np.testing.assert_allclose(got, ref, rtol=TOL,
                               atol=TOL * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


EXACT = [k for k in (_key(*j) for j in _jobs())
         if k.endswith(":None")]


@pytest.mark.parametrize("key", EXACT)
def test_exact_wire_matches_jax(run, key):
    """Output, input gradient and weight gradient of every kind, both
    impls, mp 2 and 4, and the flattened-row kinds at dp 2 x mp 2."""
    jobs, ref, worlds = run
    job = jobs[key]
    y, dx, dw = ref[key]
    for r in range(job["world"]):
        d, m, nm = _rank_of(worlds, job["world"], job["dp"], r)
        for what, full in (("y", y), ("dx", dx), ("dw", dw)):
            _close(_got(worlds, job, key, r, what),
                   _local(job, full, what, d, m, nm), f"{key} {what} r{r}")


def _fwd_bound(kind, n, x, w, y):
    """The reference's error model of a compressed output against the
    exact one (per element)."""
    if kind == "column":
        return 0.0                              # no forward wire
    if kind == "column_gather":
        return np.abs(y).max() / 254.0          # y's blocks, encoded once
    if kind == "column_sp":
        w_l1 = np.abs(w).sum(axis=0).max()      # x's blocks, encoded once
        return np.abs(x).max() / 254.0 * w_l1
    # the accumulator carries partial sums of the ranks' contributions
    contrib = [xs @ ws for xs, ws in zip(np.split(x, n, axis=2),
                                         np.split(w, n, axis=0))]
    m = np.abs(np.stack(contrib)).sum(axis=0).max()
    return (n - 1 if kind == "row_sp" else n) * m / 254.0


CODEC = [k for k in (_key(*j) for j in _jobs())
         if k.endswith(":bf16") or k.endswith(":int8")]


@pytest.mark.parametrize("key", CODEC)
def test_codec_wire_error_model_and_jax(run, key):
    jobs, ref, worlds = run
    job = jobs[key]
    kind, world, comp = job["kind"], job["world"], job["compress"]
    exact = ref[key.rsplit(":", 1)[0] + ":None"]
    bound = _fwd_bound(kind, world, job["x"], job["w"], exact[0])
    moved = 0
    for r in range(world):
        d, m, nm = _rank_of(worlds, world, 1, r)
        for i, what in enumerate(("y", "dx", "dw")):
            got = _got(worlds, job, key, r, what)
            want = _local(job, ref[key][i], what, d, m, nm)
            big = np.abs(want).max()
            step = CODEC_STEP[comp] * (1 if what == "y" else 2)
            np.testing.assert_allclose(got, want, rtol=0, atol=step * big,
                                       err_msg=f"{key} {what} r{r}")
            flips = float((np.abs(got - want) > TOL * big).mean())
            assert flips <= CODEC_FLIPS, (key, what, r, flips)
            ex = _local(job, exact[i], what, d, m, nm)
            if what == "y":
                err = np.abs(got - ex).max()
                assert err <= bound * 1.05 + TOL * np.abs(ex).max(), \
                    (key, r, err, bound)
            carried = "dx" if kind == "column" else "y"
            if what == carried:
                moved = max(moved, float(
                    (np.abs(got - ex) > TOL * np.abs(ex).max()).mean()))
    assert moved > CODEC_MOVES, (key, moved)


@pytest.mark.parametrize("key", [k for k in (_key(*j) for j in _jobs())
                                 if ":overlap:" in k])
def test_posted_bytes_equal_the_plan(run, key):
    """The bytes each rank's rings posted in the forward and backward, as
    encoded, are the plan's wire bytes (the rank's batch, the whole
    sequence and features)."""
    jobs, _, worlds = run
    job = jobs[key]
    nm = job["world"] // job["dp"]
    plan = tcm.overlap_wire_plan(job["kind"], nm, B, S, K, O, 4,
                                 job["compress"])
    assert plan == jcm.overlap_wire_plan(job["kind"], nm, B, S, K, O, 4,
                                         job["compress"])
    for res in worlds[job["world"]]:
        assert res["jobs"][key]["posted"] == plan["wire_bytes"], key


def test_wire_plan_equals_jax():
    for kind in KINDS:
        for n in (2, 4, 8):
            for b, s in ((1, 8), (2, 12), (3, 16)):
                for k, o in ((64, 96), (4096, 11008)):
                    for itemsize in (2, 4):
                        for comp in CODECS:
                            assert tcm.overlap_wire_plan(
                                kind, n, b, s, k, o, itemsize, comp) == \
                                jcm.overlap_wire_plan(
                                    kind, n, b, s, k, o, itemsize, comp)


def test_errors_match_jax(run):
    """A bad kind, a sequence and flattened rows that do not divide, an
    integer payload under a codec: the reference's ValueErrors."""
    _, _, worlds = run
    mesh = Mesh(np.array(jax.devices()[:2]), ("mp",))
    calls = {"kind": (jnp.ones((1, 4, 8)), "diag", None),
             "seq": (jnp.ones((2, 5, 16)), "row_sp", None),
             "rows": (jnp.ones((1, 5, 8)), "column", None),
             "floating": (jnp.ones((1, 4, 8), jnp.int32), "column_sp",
                          "int8")}
    for name, (x, kind, comp) in calls.items():
        with pytest.raises(ValueError) as je:
            jcm.cm_matmul(x, jnp.ones((x.shape[-1], 8)), mesh=mesh,
                          axis="mp", kind=kind, compress=comp)
        for res in worlds[2]:
            assert res["errors"][name] == str(je.value), name


def test_ineligible_calls_take_the_exact_path(run):
    for res in run[2][2]:
        assert res["ineligible"] == [True, True, True]


@pytest.mark.parametrize("name", ["column", "column_gather", "row"])
def test_mp_layers_under_the_knob(run, name):
    """Column (both gather_output) and Row under mp_overlap equal the
    exact layers, and their counters add the plan of each call."""
    _, _, worlds = run
    for res in worlds[2]:
        off, on = res["layers"][name][False], res["layers"][name][True]
        for what in ("y", "dx"):
            _close(on[what], off[what], f"{name} {what}")
        for a, b in zip(on["grads"], off["grads"]):
            _close(a, b, f"{name} grads")
        plan = tcm.overlap_wire_plan(name, 2, 2, 8, 64, 64, 4)
        c = on["counters"]
        assert c["paddle_tpu_mp_overlap_bytes_total"][name] == \
            plan["logical_bytes"]
        assert c["paddle_tpu_mp_overlap_compressed_bytes_total"][name] == \
            plan["wire_bytes"]
        assert c["paddle_tpu_mp_overlap_chunks_total"][name] == \
            2 * 2 * plan["matmul_rings"]
        assert c["posted_wire_bytes"][name] == plan["wire_bytes"]
        assert not any(off["counters"]["posted_wire_bytes"].values())


def test_fleet_init_sets_and_clears_the_knobs(run):
    for res in run[2][2]:
        assert res["knobs_on"] == ({"enabled": True, "compress": "int8",
                                    "chunks": 2}, "fp8", "fp8")
        assert res["knobs_off"] == ({"enabled": False, "compress": None,
                                     "chunks": "auto"}, None, "bfloat16")


def test_knobs_and_context_manager_match_jax():
    """configure_mp_overlap validates and returns the previous setting;
    mp_overlap_ctx restores it, also on an exception."""
    for mod in (jcm, tcm):
        before = mod.mp_overlap_config()
        prev = mod.configure_mp_overlap(enabled=True, compress="bf16",
                                        chunks=3)
        assert prev == before
        assert mod.mp_overlap_config() == {"enabled": True,
                                           "compress": "bf16", "chunks": 3}
        for bad in ({"compress": "fp4"}, {"chunks": 0}):
            with pytest.raises(ValueError):
                mod.configure_mp_overlap(**bad)
        mod.configure_mp_overlap(enabled=before["enabled"], compress="none",
                                 chunks=before["chunks"])
        with pytest.raises(RuntimeError):
            with mod.mp_overlap_ctx(enabled=True, compress="int8"):
                assert mod.mp_overlap_config()["compress"] == "int8"
                raise RuntimeError("inside")
        assert mod.mp_overlap_config() == before
        assert mod.DEFAULT_CHUNKS == 4 and mod.CM_KINDS == KINDS
