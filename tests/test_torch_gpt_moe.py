"""The GPT-MoE training slice against the JAX package, on the CPU.

The model of benchmarks/gpt_moe_ep.py at its CPU widths (hidden 64, 2
layers, 4 experts, 4 heads; batch 2 x 128; the vocabulary cut from 50257
to 512 for speed). The benchmark defines its JAX model inside ``main()``,
so this file builds the same classes from ``paddle_tpu.nn`` and
``MoELayer``; the GShard gates run with random_routing=False (the two
packages draw different random numbers). The port's model
(models/gpt_moe.py) takes the JAX weights through
convert.moe_params_from_jax, and both train 3 AdamW steps (lr 1e-4) of
their TrainStep in float32 on the same ids and labels, with the
benchmark's loss (cross-entropy on flattened float32 logits).

Tolerances: losses to 1e-5 relative; the step-1 gradients, the tight
check, to 1e-4 of each gradient's largest element (float32 forward and
backward through attention, routing, the expert products and the head,
summed in different orders by the two frameworks). One gradient is 0 in
exact arithmetic: the key projection's bias adds q . b_k to every score of
a row, which the softmax removes; both frameworks give float noise there,
so it is held below 1e-6 of the largest element of its layer's key
weight gradient instead. The routing of the first step is compared too:
every top-2 index of the first block equal.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.incubate.distributed.models.moe import GShardGate as JGShard
from paddle_tpu.incubate.distributed.models.moe import MoELayer as JMoELayer

from paddle_tpu_torch import AdamW, TrainStep
from paddle_tpu_torch.convert import moe_params_from_jax
from paddle_tpu_torch.models.gpt_moe import (MoEGPT, gpt_moe_tiny, moe_loss,
                                             moe_flops_per_token)
from torch_threads import one_thread  # noqa: F401  (autouse)

VOCAB = 512
BATCH, SEQ = 2, 128
BM = 16
LR = 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


def _jax_model(cfg, mode):
    h, heads, e = cfg.hidden_size, cfg.num_heads, cfg.num_experts

    class DenseFFN(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = pt.nn.Linear(h, 4 * h)
            self.fc2 = pt.nn.Linear(4 * h, h)

        def forward(self, x):
            return self.fc2(pt.nn.functional.gelu(self.fc1(x)))

    class MoEBlock(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.ln1 = pt.nn.LayerNorm(h)
            self.attn = pt.nn.MultiHeadAttention(h, heads)
            self.ln2 = pt.nn.LayerNorm(h)
            self.moe = DenseFFN() if mode == "dense" else JMoELayer(
                d_model=h, num_expert=e, d_hidden=4 * h,
                gate=JGShard(h, e, random_routing=False), top_k=2,
                dispatch_mode=mode, group_block=BM,
                expert_quant=cfg.expert_quant)

        def forward(self, x):
            y = self.ln1(x)
            x = x + self.attn(y, y, y)
            return x + self.moe(self.ln2(x))

    class MoEGPTJax(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = pt.nn.Embedding(VOCAB, h)
            self.blocks = pt.nn.LayerList([MoEBlock()
                                           for _ in range(cfg.num_layers)])
            self.head = pt.nn.Linear(h, VOCAB)

        def forward(self, ids):
            x = self.emb(ids)
            for b in self.blocks:
                x = b(x)
            return self.head(x)

    return MoEGPTJax()


def _jax_loss(logits, labels):
    v = logits.shape[-1]
    return pt.nn.CrossEntropyLoss()(logits.reshape([-1, v]).astype(
        "float32"), labels.reshape([-1]))


def _is_linear(name):
    return name == "head.weight" or name.endswith(
        ("proj.weight", "gate.gate.weight", "fc1.weight", "fc2.weight"))


def _assert_block0_routing_equal(jmodel, tmodel, ids, cfg):
    with torch.no_grad():
        x = tmodel.emb(torch.from_numpy(ids))
        blk = tmodel.blocks[0]
        y = blk.ln1(x)
        x = x + blk.attn(y, y, y)
        _, tidx = blk.moe.gate(blk.ln2(x).reshape(-1, cfg.hidden_size))
    jx = jmodel.emb(pt.to_tensor(ids))
    jb = jmodel.blocks[0]
    jy = jb.ln1(jx)
    jx = jx + jb.attn(jy, jy, jy)
    _, jidx = jb.moe.gate(jb.ln2(jx).reshape([-1, cfg.hidden_size]))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx.numpy()))


# the benchmark's three lanes, and the grouped lane with int8 experts
VARIANTS = {"grouped": ("grouped", None), "capacity": ("capacity", None),
            "dense": ("dense", None), "grouped_int8": ("grouped", "int8")}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_three_adamw_steps_match_jax(variant):
    mode, quant = VARIANTS[variant]
    cfg = gpt_moe_tiny(vocab_size=VOCAB, dispatch_mode=mode,
                       random_routing=False, group_block=BM,
                       expert_quant=quant)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, VOCAB, (BATCH, SEQ)).astype(np.int64)
    labels = rng.integers(0, VOCAB, (BATCH, SEQ)).astype(np.int64)

    pt.seed(5)
    jmodel = _jax_model(cfg, mode)
    sd = {k: np.asarray(v.numpy(), np.float32)
          for k, v in jmodel.state_dict().items()}
    tmodel = MoEGPT(cfg, device="cpu")
    tmodel.load_state_dict(moe_params_from_jax(sd, cfg))
    assert {k for k, _ in tmodel.named_parameters()} == set(sd)

    # step-1 gradients from the JAX eager tape, and the routing of block 0
    jloss = _jax_loss(jmodel(pt.to_tensor(ids)), pt.to_tensor(labels))
    jloss.backward()
    jgrads = {k: np.asarray(p.grad.numpy())
              for k, p in jmodel.named_parameters()}
    for p in jmodel.parameters():
        p.clear_grad()
    if mode != "dense":
        _assert_block0_routing_equal(jmodel, tmodel, ids, cfg)


    jopt = pt.optimizer.AdamW(learning_rate=LR,
                              parameters=jmodel.parameters())
    jstep = pt.jit.TrainStep(jmodel, _jax_loss, jopt)
    topt = AdamW(learning_rate=LR, parameters=tmodel.parameters())
    tstep = TrainStep(tmodel, moe_loss, topt)
    tids, tlabels = torch.from_numpy(ids), torch.from_numpy(labels)
    for i in range(3):
        jl = float(jstep((pt.to_tensor(ids),),
                         (pt.to_tensor(labels),)).numpy())
        tl = tstep((tids,), (tlabels,))
        assert tl.dtype == torch.float32 and torch.isfinite(tl)
        np.testing.assert_allclose(tl.item(), jl, rtol=LOSS_RTOL)
        if i == 0:
            np.testing.assert_allclose(tl.item(), float(jloss.numpy()),
                                       rtol=LOSS_RTOL)
            for k, p in tmodel.named_parameters():
                g = p.grad.numpy()
                g = g.T if _is_linear(k) else g
                ref = jgrads[k]
                if k.endswith("k_proj.bias"):
                    top = np.abs(jgrads[k[:-4] + "weight"]).max()
                    assert np.abs(g).max() <= 1e-6 * top, k
                    assert np.abs(ref).max() <= 1e-6 * top, k
                    continue
                np.testing.assert_allclose(g, ref, rtol=0,
                                           atol=GRAD_TOL * np.abs(ref).max(),
                                           err_msg=k)


def test_full_width_counts_match_the_benchmark():
    """The benchmark's TPU widths: 318,151,297 parameters, 148,143,745
    activated, 945.5 M flops per token at seq 1024 (counted on the meta
    device: nothing is allocated)."""
    from paddle_tpu_torch.models.gpt_moe import gpt_moe_config
    model = MoEGPT(gpt_moe_config(), device="meta",
                   generator=torch.Generator())
    n, active, flops = moe_flops_per_token(model, 1024)
    assert (n, active) == (318151297, 148143745)
    assert round(flops) == 945485574


def test_converter_transposes_each_linear_once():
    """Over the whole JAX GPT-MoE (both lanes' modules): every Linear
    weight arrives transposed, the expert stacks keep [E, K, N], biases,
    the embedding and the LayerNorms arrive as they are."""
    cfg = gpt_moe_tiny(vocab_size=VOCAB)
    for mode in ("grouped", "dense"):
        pt.seed(6)
        sd = {k: np.asarray(v.numpy(), np.float32)
              for k, v in _jax_model(cfg, mode).state_dict().items()}
        out = moe_params_from_jax(sd, cfg)
        assert set(out) == set(sd)
        for k, a in sd.items():
            want = a.T if _is_linear(k) else a
            np.testing.assert_array_equal(out[k].numpy(), want, err_msg=k)
        assert sum(_is_linear(k) for k in sd) == \
            cfg.num_layers * (5 if mode == "grouped" else 6) + 1
    e, h, f = cfg.num_experts, cfg.hidden_size, cfg.d_hidden
    assert tuple(out["blocks.0.moe.fc1.weight"].shape) == (4 * h, h)
    sd = {k: np.asarray(v.numpy(), np.float32)
          for k, v in _jax_model(cfg, "grouped").state_dict().items()}
    out = moe_params_from_jax(sd, cfg)
    assert tuple(out["blocks.1.moe.experts.w1"].shape) == (e, h, f)
    assert tuple(out["blocks.1.moe.experts.w2"].shape) == (e, f, h)
