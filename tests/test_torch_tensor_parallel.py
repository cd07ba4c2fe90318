"""GPT-2 and Llama with ``tensor_parallel=True`` in the port against the
JAX package's tensor-parallel models, on the CPU.

The JAX models run under fleet.init(mp_degree=2, dp_degree=-1) on the 8
virtual devices, over the global batch (4 x 16): logits, loss, the
gradients of the eager tape, and the parameters after one eager AdamW
step at lr 1e-3. The port's run in a world of 2 ranks (mp 2) and one of 4
(dp2 x mp2), gloo, spawned (tests/torch_dist_cases.py), through the
entry points a user calls: fleet.init, the model built with
tensor_parallel=True, each rank's shard of the JAX weights
(convert.tp_params_from_jax), fleet.distributed_model (TensorParallel:
the gradients averaged over dp) and fleet.distributed_optimizer; rank
(d, m) runs the d-th dp slice of the batch. Tiny widths (gpt_tiny and
llama_tiny: vocab 256, hidden 64, 2 layers, 4 heads; Llama with 2
key-value heads), float32, dropout 0, XLA's attention on the JAX side
(use_flash_attention=False on both).

Rank (d, m)'s logits are the m-th vocab shard of the JAX logits' rows of
d; the mean of the dp ranks' losses is the JAX loss; each rank's
gradients (after TensorParallel's dp sync) and parameters are the m-th
shards of the JAX ones, converted to the port's layout by the same
converter as the weights, so the shards together are the full tensors.
Tolerances: logits, loss and gradients 1e-5 relative and 1e-5 of each
tensor's largest magnitude (float32, summed in other orders); the
parameters after AdamW, whose step moves an element by about lr whatever
its gradient's size, every element within 2 lr and all but 0.1 % of all
elements within 1e-6.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import LlamaPretrainingCriterion as JaxCrit
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny

from paddle_tpu_torch.convert import _TP_SPLITS, tp_params_from_jax
from paddle_tpu_torch.models.gpt import gpt_tiny
from paddle_tpu_torch.models.llama import llama_tiny

import torch_dist_cases as cases

MP = 2
B, S = 4, 16
LR = 1e-3
TOL = 1e-5
CFG = {"gpt": dict(use_flash_attention=False),
       "llama": dict(use_flash_attention=False)}


def _np(t):
    return np.asarray(t.numpy(), np.float32)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The JAX models are built first; the port's worlds start on their
    weights and run while the JAX side computes."""
    saved = mesh_mod._global_mesh[0]
    try:
        s = jdist.fleet.DistributedStrategy()
        s.hybrid_configs = {"dp_degree": -1, "mp_degree": MP,
                            "pp_degree": 1}
        jdist.fleet.init(is_collective=True, strategy=s)
        rng = np.random.default_rng(31)
        built, ref = {}, {}
        for fam in ("gpt", "llama"):
            pt.seed(41)
            if fam == "gpt":
                model = JaxGPT(jax_gpt_tiny(tensor_parallel=True,
                                            **CFG[fam]))
                crit = model.loss
            else:
                cfg = jax_llama_tiny(tensor_parallel=True, **CFG[fam])
                model = JaxLlama(cfg)
                crit = JaxCrit(cfg)
            built[fam] = (model, crit)
            ref[fam] = {
                "sd": {k: _np(v) for k, v in model.state_dict().items()},
                "ids": rng.integers(0, 256, (B, S)).astype(np.int64),
                "labels": rng.integers(0, 256, (B, S)).astype(np.int64)}
        payload = {"mp": MP, "lr": LR, "models": {
            fam: {"cfg": {k: v for k, v in vars(_port_cfg(fam)).items()
                          if not k.startswith("_")
                          and k != "tensor_parallel"},
                  "sd": r["sd"], "ids": r["ids"], "labels": r["labels"]}
            for fam, r in ref.items()}}
        tmp = tmp_path_factory.mktemp("tp_models")
        handles = {n: cases.start_world(n, "tp_models", payload, tmp)
                   for n in (2, 4)}
        for fam, (model, crit) in built.items():
            r = ref[fam]
            logits = model(pt.to_tensor(r["ids"]))
            loss = crit(logits, pt.to_tensor(r["labels"]))
            loss.backward()
            r["grads"] = {k: _np(p.grad) for k, p in model.named_parameters()}
            pt.optimizer.AdamW(learning_rate=LR,
                               parameters=model.parameters()).step()
            r.update(logits=_np(logits), loss=float(loss),
                     params={k: _np(p) for k, p in model.named_parameters()})
        return ref, {n: cases.finish_world(h) for n, h in handles.items()}
    finally:
        mesh_mod._global_mesh[0] = saved


def _port_cfg(fam):
    return (gpt_tiny if fam == "gpt" else llama_tiny)(tensor_parallel=True,
                                                      **CFG[fam])


def _close(got, ref, what):
    np.testing.assert_allclose(got, ref, rtol=TOL,
                               atol=TOL * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


def _shards(fam, named, m):
    """The port-layout m-th shards of full JAX-layout tensors."""
    return {k: v.numpy() for k, v in
            tp_params_from_jax(named, _port_cfg(fam), m, MP).items()}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("fam", ["gpt", "llama"])
def test_forward_and_loss_match_jax(models, n, fam):
    ref, worlds = models
    r = ref[fam]
    dp = n // MP
    per = B // dp
    for res in worlds[n]:
        d, m = res["dp_rank"], res["mp_rank"]
        got = res[fam]
        assert got["wrapper"] == "TensorParallel"
        want = np.split(r["logits"][d * per:(d + 1) * per], MP, -1)[m]
        _close(got["logits"], want, f"{fam} logits, rank ({d}, {m})")
    loss = np.mean([res[fam]["loss"] for res in worlds[n]])
    assert loss == pytest.approx(r["loss"], rel=TOL)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("fam", ["gpt", "llama"])
def test_gradients_match_jax(models, n, fam):
    ref, worlds = models
    for res in worlds[n]:
        m = res["mp_rank"]
        want = _shards(fam, ref[fam]["grads"], m)
        got = res[fam]["grads"]
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], f"{fam} grad {k}, rank {res['mp_rank']}")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("fam", ["gpt", "llama"])
def test_adamw_step_matches_jax(models, n, fam):
    ref, worlds = models
    for res in worlds[n]:
        want = _shards(fam, ref[fam]["params"], res["mp_rank"])
        got = res[fam]["params"]
        d = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
        assert d.max() <= 2 * LR * (1 + 1e-3)
        assert np.mean(d > 1e-6) < 1e-3


@pytest.mark.parametrize("n", [2, 4])
def test_replicated_parameters_agree_across_ranks(models, n):
    """A parameter no rank shards (norms, row biases, wpe) takes the same
    step on every rank, bit for bit."""
    ref, worlds = models
    for fam in ("gpt", "llama"):
        full = [k for k in ref[fam]["params"]
                if ".".join(k.split(".")[-2:]) not in _TP_SPLITS]
        assert full
        for k in full:
            vals = [res[fam]["params"][k] for res in worlds[n]]
            for v in vals[1:]:
                np.testing.assert_array_equal(v, vals[0], err_msg=k)
