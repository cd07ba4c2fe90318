"""The port's gradient buckets and data parallelism
(paddle_tpu_torch/distributed/fleet/grad_buckets.py, parallel.py, and
TrainStep(grad_sync=...)) against the JAX package, on the CPU.

The partition and its byte counts are held against the reference's
functions on the same entries, exactly. Then one world of 2 ranks (gloo,
spawned; tests/torch_dist_cases.py) trains the reference test's GPT
(tests/test_quantized_collectives.py:445-447: vocab 128, hidden 64, 2
layers, 4 heads, float32; dropout 0, since the JAX package draws one
mask over the global batch and a rank draws its own) for 3 AdamW steps
at lr 1e-3 on a global batch of 8 x 32, each rank on its 4 rows, six
ways: the exact sync, int8, bf16 (TrainStep(grad_sync=...) with 0.05 MiB
buckets), DataParallel's own scheduler, accum_steps=2, and the strategy
knobs through fleet. The same weights and batch run in one process of
the port and in the JAX package's TrainStep.

Tolerances, and why:
- the exact run's losses (the mean of the ranks' losses, each over its
  rows) against the one-process port and the JAX losses: 1e-5 relative
  (float32, the sums ordered differently);
- the parameters after 3 steps against the one-process run: AdamW moves
  an element by about lr a step whatever its gradient's size, so an
  element whose gradient is near 0 may take another sign (the key part
  of qkv_proj.bias, whose gradient is 0 but for rounding: softmax ignores
  a constant added to a query's scores): every element within 2 lr x
  steps and all but 0.1 % of all elements within 1e-5
  (test_torch_gpt.py's rule);
- the two ranks' parameters: equal, bit for bit, after every run (the
  data-parallel invariant);
- int8 and bf16 (the reference test's bounds): step 1 within 1e-6 of the
  exact run (the weights are the same before the first update), steps 2
  and 3 within 5e-3 and not equal to it;
- DataParallel's scheduler, the fleet-built one and accum_steps=2 against
  the runs they must equal: 1e-6 relative.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.distributed.fleet import grad_buckets as JB
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT

from paddle_tpu_torch import AdamW, TrainStep
from paddle_tpu_torch.convert import gpt_params_from_jax
from paddle_tpu_torch.distributed.fleet import grad_buckets as TB
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM

import torch_dist_cases as cases

N = 2
STEPS = 3
LR = 1e-3
CFG = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, max_position_embeddings=64,
           dtype="float32", dropout=0.0)


def _batch():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 128, (8, 32)).astype(np.int64),
            rng.integers(0, 128, (8, 32)).astype(np.int64))


def _jax_model():
    pt.seed(123)
    model = JaxGPT(JaxGPTConfig(**CFG))
    return model, {k: np.asarray(v.numpy(), np.float32)
                   for k, v in model.state_dict().items()}


def _jax_run(model, ids, labels):
    crit = pt.nn.CrossEntropyLoss()

    def loss_fn(logits, lab):
        v = logits.shape[-1]
        return crit(logits.reshape([-1, v]), lab.reshape([-1]))

    opt = pt.optimizer.AdamW(learning_rate=LR,
                             parameters=model.parameters())
    step = pt.jit.TrainStep(model, loss_fn, opt)
    x = pt.to_tensor(ids, dtype="int64")
    y = pt.to_tensor(labels, dtype="int64")
    return [float(step((x,), (y,))) for _ in range(STEPS)]


def _port_run(sd, ids, labels):
    cfg = GPTConfig(**CFG)
    model = GPTForCausalLM(cfg, device="cpu")
    model.load_state_dict(gpt_params_from_jax(sd, cfg))
    step = TrainStep(model, lambda lo, la: cases.model_loss(cfg, lo, la),
                     AdamW(learning_rate=LR,
                           parameters=model.parameters()))
    x, y = torch.from_numpy(ids), torch.from_numpy(labels)
    losses = [float(step((x,), (y,))) for _ in range(STEPS)]
    return losses, {k: p.detach().numpy().copy()
                    for k, p in model.named_parameters()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ids, labels = _batch()
    model, sd = _jax_model()
    payload = {"cfg": CFG, "sd": sd, "ids": ids, "labels": labels,
               "lr": LR, "bucket_mb": 0.05, "steps": STEPS}
    handle = cases.start_world(N, "dp", payload,
                               tmp_path_factory.mktemp("dp"))
    jax_losses = _jax_run(model, ids, labels)
    one_losses, one_params = _port_run(sd, ids, labels)
    return {"jax": jax_losses, "one": (one_losses, one_params),
            "ranks": cases.finish_world(handle)}


def _mean_losses(ranks, name):
    return np.mean([r[name]["losses"] for r in ranks], axis=0)


# -- the partition, against the reference's --------------------------------------
def _entries():
    model = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    ents = [(k, tuple(p.shape), "float32")
            for k, p in model.named_parameters()]
    # bf16 entries price 2 bytes a value; an int entry never syncs
    return ents + [("extra.bf16", (300, 7), "bfloat16"),
                   ("extra.int", (5,), "int32")]


@pytest.mark.parametrize("bucket_mb", [0.005, 0.05, 32])
def test_partition_matches_the_reference(bucket_mb):
    ents = [e for e in _entries() if e[2] != "int32"]
    ref = JB.partition_buckets(ents, bucket_mb)
    got = TB.partition_buckets(ents, bucket_mb)
    assert [b.names for b in got] == [b.names for b in ref]
    for b, rb in zip(got, ref):
        assert b.nbytes == rb.nbytes
        for comp in (None, "int8", "bf16"):
            assert b.wire(comp) == rb.wire(comp)


@pytest.mark.parametrize("compress", [None, "int8", "bf16"])
def test_scheduler_byte_counts_match_the_reference(compress):
    ents = _entries()
    ref = JB.GradBucketScheduler(ents, bucket_mb=0.05, compress=compress)
    got = TB.GradBucketScheduler(ents, bucket_mb=0.05, compress=compress)
    assert [e[0] for e in got.entries] == [e[0] for e in ref.entries]
    assert got.bytes_per_step == ref.bytes_per_step
    assert got.wire_bytes_per_step == ref.wire_bytes_per_step
    assert len(got.buckets) == len(ref.buckets) >= 2


@pytest.mark.parametrize("nbytes,itemsize", [(4096, 4), (1000, 4),
                                             (2048, 2), (7, 1)])
@pytest.mark.parametrize("compress", [None, "int8", "bf16"])
def test_wire_bytes_match_the_reference(nbytes, itemsize, compress):
    for stages in (1, 2):
        assert TB.wire_bytes(nbytes, compress, stages, itemsize) == \
            JB.wire_bytes(nbytes, compress, stages, itemsize)


def test_auto_bucket_size_raises():
    with pytest.raises(NotImplementedError, match="auto"):
        TB.GradBucketScheduler(_entries(), bucket_mb="auto")


# -- data-parallel training, world 2 ----------------------------------------------
def test_exact_sync_matches_one_process_and_jax(runs):
    got = _mean_losses(runs["ranks"], "exact")
    np.testing.assert_allclose(got, runs["one"][0], rtol=1e-5)
    np.testing.assert_allclose(got, runs["jax"], rtol=1e-5)
    np.testing.assert_allclose(runs["one"][0], runs["jax"], rtol=1e-5)


def test_exact_sync_parameters_match_one_process(runs):
    one = runs["one"][1]
    got = runs["ranks"][0]["exact"]["params"]
    d = np.concatenate([np.abs(got[k] - one[k]).ravel() for k in one])
    assert d.max() <= 2 * LR * STEPS * (1 + 1e-3)
    assert np.mean(d > 1e-5) < 1e-3


@pytest.mark.parametrize("name", ["exact", "int8", "bf16", "wrapper",
                                  "accum", "fleet_int8"])
def test_replicas_stay_equal_bit_for_bit(runs, name):
    a, b = (r[name]["params"] for r in runs["ranks"])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("compress", ["int8", "bf16"])
def test_compressed_sync_trains_within_the_reference_bound(runs, compress):
    exact = _mean_losses(runs["ranks"], "exact")
    q = _mean_losses(runs["ranks"], compress)
    assert q[0] == pytest.approx(exact[0], rel=1e-6)
    for i in (1, 2):
        assert q[i] == pytest.approx(exact[i], rel=5e-3), (exact, q)
        assert q[i] != exact[i]          # the compression is in the loop


def test_dataparallel_scheduler_and_accumulation(runs):
    exact = _mean_losses(runs["ranks"], "exact")
    np.testing.assert_allclose(_mean_losses(runs["ranks"], "wrapper"),
                               exact, rtol=1e-6)
    np.testing.assert_allclose(_mean_losses(runs["ranks"], "accum"),
                               exact, rtol=1e-6)


def test_accumulated_gradients_sync_once_a_step(runs):
    for r in runs["ranks"]:
        s = r["accum"]["sched"]
        c = s["counters"]
        assert c["grad_sync_buckets_total"] == STEPS * len(s["buckets"])
        assert c["grad_sync_bytes_total"] == STEPS * s["bytes_per_step"]


@pytest.mark.parametrize("name", ["exact", "int8", "bf16"])
def test_counters_count_each_bucket_once_a_step(runs, name):
    s = runs["ranks"][0][name]["sched"]
    c = s["counters"]
    assert len(s["buckets"]) >= 2
    assert c["grad_sync_buckets_total"] == STEPS * len(s["buckets"])
    assert c["grad_sync_bytes_total"] == STEPS * s["bytes_per_step"]
    assert c["grad_sync_compressed_bytes_total"] == \
        STEPS * s["wire_bytes_per_step"]
    if name == "int8":
        assert s["wire_bytes_per_step"] / s["bytes_per_step"] < 0.27


def test_strategy_knobs_reach_train_step(runs):
    """grad_compress / grad_bucket_mb -> fleet.distributed_optimizer ->
    TrainStep builds the scheduler, which trains as the explicit one."""
    for r in runs["ranks"]:
        s = r["fleet_int8"]["sched"]
        assert s["compress"] == "int8" and s["axis"] == "dp"
        assert len(s["buckets"]) >= 2
        assert s["buckets"] == r["int8"]["sched"]["buckets"]
    np.testing.assert_allclose(_mean_losses(runs["ranks"], "fleet_int8"),
                               _mean_losses(runs["ranks"], "int8"),
                               rtol=1e-6)


def test_dataparallel_surface(runs):
    """scale_loss returns the loss; state_dict and parameters are the
    wrapped layers' (no wrapper prefix)."""
    for res in runs["ranks"]:
        assert res["wrapper_surface"] == (True, True, True, True)


def test_no_sync_defers_the_sync(runs):
    for r, res in enumerate(runs["ranks"]):
        np.testing.assert_array_equal(res["no_sync_local"],
                                      np.full((2, 3), r + 1.0))
        # each rank accumulated 2 (r + 1); the synced backward averages
        np.testing.assert_array_equal(res["no_sync_then_synced"],
                                      np.full((2, 3), float(N + 1)))
