"""The port's ZeRO sharding stages (fleet/meta_parallel/
sharding_optimizer.py, distributed.sharding.group_sharded_parallel, fleet
at sharding_degree > 1) and configuration 4's composition (the GPT-MoE at
ep 2 x sharding 2 through GroupShardedOptimizerStage2) against the JAX
package, on the CPU.

One world of 4 gloo ranks (tests/torch_zero_cases.py), started once for
the module; rank r of the data world takes row block r of the batch. The
JAX package runs ZeRO as a placement of one controller's state, so the
reference is its unsharded step on the concatenated batch (one process,
the same function): three AdamW steps (lr 1e-3) of
- a residual MLP (input 6 -> hidden 12, two blocks of LayerNorm, 12 -> 20
  -> 12 with GELU, head 3; widths that 4 ranks do not divide, so the last
  slices are short or empty) on 8 x 6 float32 rows with a mean-squared
  loss, at each level of group_sharded_parallel over the world and
  through fleet (sharding 2 x dp 2: ShardingParallel and
  DygraphShardingOptimizer), and at stage 2 once more in gradient
  buckets of at most 256 values;
- the tiny GPT-MoE (hidden 32, 2 layers, 2 heads, 4 experts, vocab 64,
  grouped dispatch, random_routing=False) on 4 x 16 ids with the
  benchmark's loss.
Inputs come from numpy on a seed; the JAX weights cross to each rank.

Tolerances, and why:
- losses (the mean of the ranks' local losses is the batch's) to 1e-5
  relative: float32 sums in other orders;
- parameters after three steps: AdamW moves an element whose gradient is
  near 0 by up to lr a step on rounding noise, so they are held within
  2 lr of JAX a step, with no more than 0.1 % of the elements beyond 1e-5
  of their tensor's largest (the GPT-MoE's key-projection bias, whose
  gradient is 0 in exact arithmetic, is left to the first rule);
- GroupShardedStage2 over two Linear maps 4 -> 3 of which only rank 0
  uses the second (the others leave its gradient unreached), two SGD
  steps (lr 0.1) against torch on one process stepping the mean of the
  four ranks' losses: parameters within 1e-5 of each tensor's largest
  (float32 sums in other orders);
- each rank's state bytes: moments 1/4 of the whole (1/2 through fleet)
  to within one padded value a tensor; stage 1 keeps whole gradients,
  stage 2 and 3 1/N, stage 3 parameters 1/N.
"""
import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.incubate.distributed.models.moe import GShardGate as JGShard
from paddle_tpu.incubate.distributed.models.moe import MoELayer as JMoELayer

import torch
import torch_dist_cases as cases
import torch_zero_cases
from torch_threads import one_thread  # noqa: F401  (autouse)

N = 4
DIMS = (6, 12, 20, 3, 2)           # in, hidden, width, out, blocks
ROWS = 8
LR = 1e-3
STEPS = 3
LOSS_RTOL = 1e-5
PARAM_TOL = 1e-5
PARAM_FRAC = 1e-3
CLIP = 0.05                       # below the step-1 gradient norm
CLIP_LR = 0.5                     # SGD, so that the clip shows
BUCKET = 256                      # values: several stage-2 buckets
UNREACHED_LR = 0.1
MOE = dict(hidden_size=32, num_layers=2, num_heads=2, num_experts=4,
           vocab_size=64, dispatch_mode="grouped", random_routing=False,
           group_block=8)
MOE_ROWS, MOE_SEQ = 4, 16


class _JBlock(pt.nn.Layer):
    def __init__(self, h, f):
        super().__init__()
        self.ln = pt.nn.LayerNorm(h)
        self.fc1 = pt.nn.Linear(h, f)
        self.fc2 = pt.nn.Linear(f, h)

    def forward(self, x):
        return x + self.fc2(pt.nn.functional.gelu(self.fc1(self.ln(x))))


class _JNet(pt.nn.Layer):
    def __init__(self):
        super().__init__()
        d_in, h, f, d_out, nb = DIMS
        self.inp = pt.nn.Linear(d_in, h)
        self.blocks = pt.nn.LayerList([_JBlock(h, f) for _ in range(nb)])
        self.head = pt.nn.Linear(h, d_out)

    def forward(self, x):
        x = self.inp(x)
        for b in self.blocks:
            x = b(x)
        return self.head(x)


def _jax_gpt_moe():
    h, e, v = MOE["hidden_size"], MOE["num_experts"], MOE["vocab_size"]

    class Block(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.ln1 = pt.nn.LayerNorm(h)
            self.attn = pt.nn.MultiHeadAttention(h, MOE["num_heads"])
            self.ln2 = pt.nn.LayerNorm(h)
            self.moe = JMoELayer(
                d_model=h, num_expert=e, d_hidden=4 * h,
                gate=JGShard(h, e, random_routing=False), top_k=2,
                dispatch_mode="grouped", group_block=MOE["group_block"])

        def forward(self, x):
            y = self.ln1(x)
            x = x + self.attn(y, y, y)
            return x + self.moe(self.ln2(x))

    class GPT(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = pt.nn.Embedding(v, h)
            self.blocks = pt.nn.LayerList([Block() for _ in
                                           range(MOE["num_layers"])])
            self.head = pt.nn.Linear(h, v)

        def forward(self, ids):
            x = self.emb(ids)
            for b in self.blocks:
                x = b(x)
            return self.head(x)

    return GPT()


def _jax_train(model, loss_fn, x, y, opt=None):
    sd = {k: np.asarray(p.numpy(), np.float32)
          for k, p in model.state_dict().items()}
    step = pt.jit.TrainStep(model, loss_fn, opt or pt.optimizer.AdamW(
        learning_rate=LR, parameters=model.parameters()))
    losses = [float(step((pt.to_tensor(x),), (pt.to_tensor(y),)).numpy())
              for _ in range(STEPS)]
    after = {k: np.asarray(p.numpy(), np.float32)
             for k, p in model.state_dict().items()}
    return sd, losses, after


def _mse(out, y):
    return ((out - y) ** 2).mean()


def _ce(logits, labels):
    v = logits.shape[-1]
    return pt.nn.CrossEntropyLoss()(logits.reshape([-1, v]).astype(
        "float32"), labels.reshape([-1]))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(31)
    x = rng.standard_normal((ROWS, DIMS[0])).astype(np.float32)
    y = rng.standard_normal((ROWS, DIMS[3])).astype(np.float32)
    pt.seed(3)
    sd, losses, after = _jax_train(_JNet(), _mse, x, y)
    pt.seed(3)
    net = _JNet()
    csd, closses, cafter = _jax_train(net, _mse, x, y, pt.optimizer.SGD(
        learning_rate=CLIP_LR, parameters=net.parameters(),
        grad_clip=pt.nn.ClipGradByGlobalNorm(CLIP)))
    for k, v in csd.items():
        np.testing.assert_array_equal(v, sd[k])
    ids = rng.integers(0, MOE["vocab_size"], (MOE_ROWS, MOE_SEQ))
    labels = rng.integers(0, MOE["vocab_size"], (MOE_ROWS, MOE_SEQ))
    pt.seed(4)
    msd, mlosses, mafter = _jax_train(_jax_gpt_moe(), _ce, ids, labels)
    unreached = {"sd": {k: rng.standard_normal(v.shape).astype(np.float32)
                        for k, v in torch_zero_cases.Partial(True)
                        .state_dict().items()},
                 "x": rng.standard_normal((2 * N, 4)).astype(np.float32),
                 "y": rng.standard_normal((2 * N, 3)).astype(np.float32),
                 "steps": 2, "lr": UNREACHED_LR}
    tmp = tmp_path_factory.mktemp("sharding")
    payload = {"dims": DIMS, "sd": sd, "x": x, "y": y, "steps": STEPS,
               "lr": LR, "clip_norm": CLIP, "clip_lr": CLIP_LR,
               "save_dir": str(tmp / "saved"), "bucket": BUCKET,
               "unreached": unreached,
               "gpt_moe": {"cfg": MOE, "sd": msd, "ids": ids,
                           "labels": labels, "steps": STEPS, "lr": LR}}
    results = cases.run_world(N, "sharding", payload, tmp,
                              module="torch_zero_cases")
    return {"mlp": (sd, losses, after), "mlp_clip": (sd, closses, cafter),
            "moe": (msd, mlosses, mafter), "x": x, "y": y,
            "unreached": unreached}, results


def _assert_params_close(got, ref, skip_tight=()):
    far = total = 0
    for k, r in ref.items():
        d = np.abs(got[k] - r)
        assert d.max() <= 2 * LR * STEPS, (k, d.max())
        if k.endswith(skip_tight):
            continue
        far += int((d > PARAM_TOL * np.abs(r).max()).sum())
        total += d.size
    assert far <= PARAM_FRAC * total, (far, total)


LEVELS = ["os", "os_g", "p_g_os", "fleet"]
WRAPPERS = {"os": "Net", "os_g": "GroupShardedStage2",
            "p_g_os": "GroupShardedStage3", "fleet": "ShardingParallel",
            "os_g_clip": "GroupShardedStage2",
            "p_g_os_clip": "GroupShardedStage3",
            "os_g_buckets": "GroupShardedStage2"}


@pytest.mark.parametrize("level", LEVELS + ["os_g_clip", "p_g_os_clip",
                                            "os_g_buckets"])
def test_three_steps_match_jax_on_the_whole_batch(world, level):
    """The _clip levels (SGD lr 0.5 with ClipGradByGlobalNorm(0.05), whose
    step is the clipped gradient itself) hold the clip on the sharded
    slices (the norm's squares summed over the group) against JAX's on
    the whole gradients; its gradients' norm is above 0.05 at every
    step."""
    refs, results = world
    _, losses, after = refs["mlp_clip" if level.endswith("_clip")
                            else "mlp"]
    got = np.mean([r[level]["losses"] for r in results], axis=0)
    np.testing.assert_allclose(got, losses, rtol=LOSS_RTOL)
    for r in results:
        assert r[level]["wrapper"] == WRAPPERS[level]
        _assert_params_close(r[level]["params"], after)
    if level.endswith("_clip"):          # the clip bites at step 1
        net = torch_zero_cases.Net(DIMS)
        torch_zero_cases._load(net, refs["mlp"][0])
        loss = torch_zero_cases._mse(net(torch.from_numpy(refs["x"])),
                                     torch.from_numpy(refs["y"]))
        loss.backward()
        norm = sum(float(p.grad.square().sum()) for p in net.parameters())
        assert norm ** 0.5 > 2 * CLIP
    if level == "fleet":
        assert results[0][level]["opt"] == "DygraphShardingOptimizer"


@pytest.mark.parametrize("level", LEVELS + ["os_g_buckets"])
def test_each_rank_holds_its_share_of_the_state(world, level):
    refs, results = world
    sd = refs["mlp"][0]
    whole = sum(v.size for v in sd.values()) * 4          # float32 bytes
    pad = len(sd) * 4
    n = 2 if level == "fleet" else N
    for r in results:
        b = r[level]["bytes"]
        assert abs(b["moments"] - 2 * whole / n) <= 2 * pad, b
        if level in ("os", "fleet"):          # stage 1: whole gradients
            assert b["grads"] == whole and b["params"] == whole
        else:
            assert abs(b["grads"] - whole / n) <= pad, b
        if level == "p_g_os":                 # parameters rest as slices
            assert abs(b["params"] - whole / n) <= pad, b
        elif level.startswith("os_g"):
            assert b["params"] == whole


def test_stage2_buckets_follow_buffer_max_size(world):
    _, results = world
    for r in results:
        assert r["os_g"]["buckets"] == 1              # 2^23 values
        assert r["os_g_buckets"]["buckets"] > 3


def test_stage2_with_a_parameter_some_ranks_leave_unreached(world):
    """Rank 0 sends b's bucket in backward; the others send it, zeros,
    in the step, with a's bucket queued behind it: the same reduce-scatters
    in the same order on every rank, and the mean of the ranks' gradients
    stepped."""
    refs, results = world
    inp = refs["unreached"]
    net = torch_zero_cases.Partial(True)
    with torch.no_grad():
        for k, p in net.named_parameters():
            p.copy_(torch.from_numpy(inp["sd"][k]))
    x, y = torch.from_numpy(inp["x"]), torch.from_numpy(inp["y"])
    nloc = x.shape[0] // N
    for _ in range(inp["steps"]):
        net.zero_grad()
        total = 0
        for r in range(N):
            net.use_b = r == 0
            rows = slice(r * nloc, (r + 1) * nloc)
            total = total + torch_zero_cases._mse(net(x[rows]), y[rows])
        (total / N).backward()
        with torch.no_grad():
            for p in net.parameters():
                p -= UNREACHED_LR * p.grad
    for r in results:
        got = r["unreached"]
        assert got["buckets"] == 2
        for k, p in net.named_parameters():
            ref = p.detach().numpy()
            np.testing.assert_allclose(got["params"][k], ref, rtol=0,
                                       atol=PARAM_TOL * np.abs(ref).max(),
                                       err_msg=k)


def test_stage3_gathers_and_saves_the_whole_state(world):
    refs, results = world
    _, _, after = refs["mlp"]
    for r in results:
        rec = r["p_g_os"]
        assert set(rec["saved"]) == set(after)
        for k, v in rec["saved"].items():       # torch's Linear layout
            np.testing.assert_array_equal(v.T if v.ndim == 2 else v,
                                          rec["params"][k])
        _assert_params_close(rec["jax_params"], after)
        shapes = [tuple(v.shape) for v in after.values()]
        assert sorted(tuple(p.shape) for p in rec["all_params"]) == \
            sorted(tuple(s[::-1]) if len(s) == 2 else s for s in shapes)
        for level in ("os", "p_g_os"):       # moments gathered whole
            st = r[level]["opt_state"]
            assert len(st) == 2 * len(after)
            assert sorted(v.size for v in st.values()) == sorted(
                v.size for v in after.values() for _ in range(2))


def test_configuration_4_ep2_sharding2_matches_jax(world):
    """fleet.init(ep_degree=2, sharding_degree=2), MoEGPT built under it
    (each MoELayer takes fleet's ep group), GroupShardedOptimizerStage2
    over AdamW, TrainStep: three steps against the JAX step on the whole
    batch, and the experts gathered back over each ep group."""
    refs, results = world
    _, losses, after = refs["moe"]
    got = np.mean([r["gpt_moe"]["losses"] for r in results], axis=0)
    np.testing.assert_allclose(got, losses, rtol=LOSS_RTOL)
    assert sorted(r["gpt_moe"]["ep_rank"] for r in results) == [0, 0, 1, 1]
    for r in results:
        params = r["gpt_moe"]["jax_params"]
        assert set(params) == set(after)
        _assert_params_close(params, after, skip_tight=("k_proj.bias",))
    experts = sum(v.size for k, v in after.items() if ".experts." in k)
    dense = sum(v.size for v in after.values()) - experts
    for r in results:       # moments: a 1/2 slice of this rank's half
        b = r["gpt_moe"]["bytes"]
        want = 2 * 4 * (dense + experts / 2) / 2
        assert abs(b["moments"] - want) <= 2 * 4 * len(after), b


@pytest.mark.parametrize("what", [
    "offload", "stage3_offload", "subset", "grad_compress", "sharding_mp",
    "ep_pp", "sep", "stage2_clip_by_norm"])
def test_out_of_scope_options_raise(world, what):
    _, results = world
    for r in results:
        assert r["errors"][what] is not None and \
            r["errors"][what][0] == "NotImplementedError", r["errors"][what]
    assert results[0]["errors"]["level"][0] == "ValueError"
