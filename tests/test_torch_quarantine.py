"""The port's fault plan and its serve's quarantine and replay against the
JAX package's, on the CPU (tests/test_pipelined_decode.py's fixture: vocab
97, hidden 64, 2 layers, float32, max_len 64, block_size 8, 4 slots, 48
blocks, chunk 4, budgets 20/9/14). Weights cross with
convert.params_from_jax, and every array handed to JAX carries an
explicit dtype.

- ``_decision`` and ``FaultInjector.fire`` give the reference's coins,
  fires, counts and schedules over a grid of seeds, sites, windows,
  probabilities and caps, and a plan parses alike from a dict, inline
  JSON and a file;
- under the reference's ``test_quarantine_one_chunk_late`` plan
  (logits_poison, p 1, window [0, 2]), ``serve(pipeline=None | True |
  False, max_restarts=6)`` gives the JAX engine's streams, which equal
  the unpoisoned serial serve's, with its ``quarantines`` and
  ``replays``; with ``replay_backoff_s=0`` the replays join at a point
  the clock cannot move, and ``h2d_uploads``, ``pipeline_drains`` and the
  chunk counts equal the JAX engine's too;
- ``max_restarts=0`` delivers the reference's partial streams (give up);
- a prompt whose prefill logits go non-finite (NaN in one embedding row)
  is quarantined at every prefill and given up, as in the reference,
  while the other requests are served.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as pt
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.paged_decode import PagedDecoder as JaxPagedDecoder
from paddle_tpu.resilience import faults as jax_faults

from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models.paged_decode import PagedDecoder
from paddle_tpu_torch.resilience import faults
from torch_threads import one_thread  # noqa: F401  (autouse)

CFG = dict(vocab_size=97, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=128, use_flash_attention=False,
           dtype="float32")
LATE_PLAN = {"seed": 7, "sites": {
    "logits_poison": {"p": 1.0, "window": [0, 2]}}}
COUNTERS = ("quarantines", "replays", "replay_giveups", "evictions",
            "h2d_uploads", "pipeline_drains", "chunk_dispatches",
            "lookahead_dispatches")
PIPELINES = [None, True, False]


@pytest.fixture(autouse=True)
def _no_plan():
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


@pytest.fixture(scope="module")
def models():
    pt.seed(5)
    jmodel = JaxLlama(JaxLlamaConfig(**CFG))
    jmodel.eval()
    sd = {k: np.asarray(v.numpy()) for k, v in jmodel.state_dict().items()}
    cfg = LlamaConfig(**CFG)
    tmodel = LlamaForCausalLM(cfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(sd, cfg))
    tmodel.eval()
    return jmodel, tmodel


# -- the coins ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 123456789])
def test_decision_matches_jax(seed):
    for site in sorted(faults.KNOWN_SITES):
        for n in range(0, 400, 7):
            assert faults._decision(seed, site, n) == \
                jax_faults._decision(seed, site, n)


SITE_PLANS = [{"p": 1.0, "window": [0, 2]}, {"p": 0.3},
              {"p": 0.5, "window": [3, 30], "max_fires": 4},
              {"p": 0.0}]


@pytest.mark.parametrize("seed", [0, 7, 99])
@pytest.mark.parametrize("sp", range(len(SITE_PLANS)))
def test_fire_sequences_match_jax(seed, sp):
    plan = {"seed": seed, "sites": {
        "logits_poison": SITE_PLANS[sp],
        "decode_chunk": SITE_PLANS[(sp + 1) % len(SITE_PLANS)]}}
    got = faults.FaultInjector(faults.FaultPlan.parse(plan))
    want = jax_faults.FaultInjector(jax_faults.FaultPlan.parse(plan))
    # the sites interleaved unevenly; a site outside the plan never fires
    order = ["logits_poison", "decode_chunk", "logits_poison",
             "prefill_chunk"] * 25
    assert [got.fire(s) for s in order] == [want.fire(s) for s in order]
    assert got.schedule() == want.schedule()
    assert got.counts() == want.counts()
    assert got.invocations() == want.invocations()
    got.reset()
    assert got.schedule() == [] and got.invocations() == {}


def test_plan_forms_and_module_functions(tmp_path):
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(LATE_PLAN))
    for spec in (LATE_PLAN, json.dumps(LATE_PLAN), str(path)):
        assert faults.FaultPlan.parse(spec).to_dict() == \
            jax_faults.FaultPlan.parse(spec).to_dict()
    assert faults.FaultPlan.parse(LATE_PLAN, seed=3).seed == 3
    bare = faults.FaultPlan.parse({"logits_poison": {"p": 1.0}})
    assert bare.seed == 0 and "logits_poison" in bare.sites
    with pytest.raises(ValueError, match="unknown fault site"):
        faults.FaultPlan.parse({"sites": {"logit_poison": {}}})
    with pytest.raises(ValueError):
        faults.SitePlan(p=1.5)
    assert not faults.active() and faults.fire("logits_poison") is False
    faults.install_plan(LATE_PLAN)
    jax_faults.install_plan(LATE_PLAN)
    for _ in range(5):
        assert faults.fire("logits_poison") == \
            jax_faults.fire("logits_poison")
    assert faults.schedule() == jax_faults.schedule() == \
        [("logits_poison", 0), ("logits_poison", 1)]
    assert faults.counts() == jax_faults.counts() == {"logits_poison": 2}
    faults.reset()
    assert faults.schedule() == []
    faults.install_plan({"sites": {"prefill_chunk": {"p": 1.0}}})
    with pytest.raises(faults.InjectedFault):
        faults.inject("prefill_chunk")
    faults.clear()
    assert not faults.active() and faults.counts() == {}


# -- quarantine and replay in serve ------------------------------------------------

def _dec(cls, model, **kw):
    args = dict(max_len=64, block_size=8, max_slots=4, num_blocks=48)
    args.update(kw)
    return cls(model, **args)


def _prompt(n, seed):
    rng = np.random.default_rng(seed)
    return [int(t) for t in rng.integers(0, 97, n)]


def _reqs():
    return [("a", _prompt(7, 1), 20), ("b", _prompt(5, 2), 9),
            ("c", _prompt(9, 3), 14)]


def _serve(cls, model, plan, mod, **kw):
    dec = _dec(cls, model, **({"device": "cpu"} if cls is PagedDecoder
                              else {}))
    if plan is not None:
        mod.install_plan(plan)
    try:
        out = dec.serve(_reqs(), chunk=4, **kw)
    finally:
        mod.clear()
    return out, {c: getattr(dec, c) for c in COUNTERS}


_JAX = {}


def _jax(jmodel, key, plan, **kw):
    # the JAX engine runs pipeline=True exactly as None (the lookahead;
    # True only refuses spec_decode), so both read one run
    if kw.get("pipeline") is True:
        kw["pipeline"] = None
        key = tuple(None if k is True else k for k in key)
    if key not in _JAX:
        _JAX[key] = _serve(JaxPagedDecoder, jmodel, plan, jax_faults, **kw)
    return _JAX[key]


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_quarantine_one_chunk_late_matches_jax(models, pipeline):
    """The poisoned chunk's flags reach the host after the lookahead chunk
    behind it was dispatched: both slots are still recycled and replayed
    to the unpoisoned streams."""
    jmodel, tmodel = models
    serial, _ = _jax(jmodel, "serial", None, pipeline=False)
    ref, jc = _jax(jmodel, ("late", pipeline), LATE_PLAN,
                   pipeline=pipeline, max_restarts=6)
    out, c = _serve(PagedDecoder, tmodel, LATE_PLAN, faults,
                    pipeline=pipeline, max_restarts=6)
    assert out == ref == serial
    assert c["quarantines"] == jc["quarantines"] == 2
    assert c["replays"] == jc["replays"] == 2
    assert c["replay_giveups"] == jc["replay_giveups"] == 0
    assert c["evictions"] == 0


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_quarantine_counters_match_jax(models, pipeline):
    """With no backoff the replays join at the next admission scan,
    whatever the clock: every counter equals the JAX engine's, the poison
    column's single re-upload included."""
    jmodel, tmodel = models
    ref, jc = _jax(jmodel, ("nobackoff", pipeline), LATE_PLAN,
                   pipeline=pipeline, max_restarts=6, replay_backoff_s=0.0)
    out, c = _serve(PagedDecoder, tmodel, LATE_PLAN, faults,
                    pipeline=pipeline, max_restarts=6,
                    replay_backoff_s=0.0)
    assert out == ref
    assert c == jc
    assert c["quarantines"] == 2 and c["pipeline_drains"] >= 1
    if pipeline is not False:
        # the lookahead chunk's coins clear the poison: one upload
        assert c["h2d_uploads"] % 6 == 1


def test_giveup_delivers_partial_streams(models):
    jmodel, tmodel = models
    ref, jc = _jax(jmodel, "giveup", LATE_PLAN, max_restarts=0)
    out, c = _serve(PagedDecoder, tmodel, LATE_PLAN, faults,
                    max_restarts=0)
    assert out == ref
    assert c["replay_giveups"] == jc["replay_giveups"] == 2
    assert c["replays"] == 0
    # a and b keep what they had before the poisoned chunk: the prefill's
    # token
    assert len(out["a"]) == len(out["b"]) == 1 and len(out["c"]) == 14


def test_quarantined_prefill_matches_jax(models):
    """NaN in the embedding row of a token only request "p" holds: its
    every prefill is non-finite, so it is quarantined, replayed twice and
    given up with nothing, while the others are served. The token ends a
    prompt that fills its bucket: no padding row attends to it and writes
    NaN into the trash block, which the dense path would read as 0 x NaN
    in both engines."""
    jmodel, tmodel = models
    reqs = _reqs()
    bad = 96
    assert all(bad not in p for _, p, _ in reqs)
    reqs.append(("p", _prompt(7, 9) + [bad], 5))
    jdec = _dec(JaxPagedDecoder, jmodel)
    jdec._params["embed"] = jdec._params["embed"].at[bad].set(
        jnp.float32(np.nan))
    ref = jdec.serve(reqs, chunk=4, max_restarts=2, replay_backoff_s=0.0)
    tdec = _dec(PagedDecoder, tmodel, device="cpu")
    tdec.embed = tdec.embed.clone()
    tdec.embed[bad] = float("nan")
    out = tdec.serve(reqs, chunk=4, max_restarts=2, replay_backoff_s=0.0)
    assert out == ref
    assert out["p"] == [] and all(len(out[r]) == b for r, _, b in reqs[:3])
    for name in ("quarantines", "replays", "replay_giveups"):
        assert getattr(tdec, name) == getattr(jdec, name)
    assert (tdec.quarantines, tdec.replays, tdec.replay_giveups) == \
        (3, 2, 1)
    assert tdec.allocator.in_use == 0
    assert torch.isnan(tdec.embed[bad]).all()
