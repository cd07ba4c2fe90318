"""The GPT-MoE of benchmarks/gpt_moe_ep.py (BASELINE.json's configuration
4, "GPT-MoE expert-parallel"), as a module of the port.

The benchmark defines its model inside ``main()``: ``DenseFFN``,
``MoEBlock`` (pre-norm LayerNorm, MultiHeadAttention with no mask, a
MoELayer with a GShard top-2 gate) and ``MoEGPT`` (an untied embedding and
a head with a bias over the GPT-2 vocabulary). These are the same classes
with the same parameter names, so a JAX state dict converts one to one
(convert.moe_params_from_jax). The benchmark's loss is ``moe_loss``:
cross-entropy on float32 logits, flattened. ``gpt_moe_config`` gives the
benchmark's TPU widths (``_shapes``: hidden 768, 6 layers, 8 experts, 12
heads) and ``gpt_moe_tiny`` its CPU widths (64, 2, 4, 4). The benchmark
trains through fleet's stage-2 optimizer wrapper, which at sharding
degree 1 is AdamW; the port trains with its AdamW under TrainStep.
"""
from __future__ import annotations

from torch import nn
from torch.nn import functional as F

from ..framework.device import resolve_device, seed, torch_dtype
from ..incubate.distributed.models.moe import GShardGate, MoELayer
from ..nn.functional.loss import cross_entropy
from ..nn.layer.common import embedding, linear
from ..nn.layer.transformer import MultiHeadAttention

__all__ = ["GPTMoEConfig", "gpt_moe_config", "gpt_moe_tiny", "DenseFFN",
           "MoEBlock", "MoEGPT", "moe_loss", "moe_flops_per_token"]


class GPTMoEConfig:
    """The benchmark's model settings. dispatch_mode is MoELayer's
    ("capacity" or "grouped"), or "dense" for the benchmark's dense lane
    (a 4h FFN in place of each MoE layer). random_routing is the GShard
    gate's random drop of second routes in training."""

    def __init__(self, vocab_size=50257, hidden_size=768, num_layers=6,
                 num_heads=12, num_experts=8, top_k=2, d_hidden=None,
                 dispatch_mode="grouped", capacity_factor=1.25,
                 group_block="auto", expert_quant=None, random_routing=True,
                 layer_norm_eps=1e-5, dtype="float32"):
        if dispatch_mode not in ("capacity", "grouped", "dense"):
            raise ValueError(f"dispatch_mode must be 'capacity', 'grouped' "
                             f"or 'dense', got {dispatch_mode!r}")
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.num_experts = num_experts
        self.top_k = top_k
        self.d_hidden = d_hidden or 4 * hidden_size
        self.dispatch_mode = dispatch_mode
        self.capacity_factor = capacity_factor
        self.group_block = group_block
        self.expert_quant = expert_quant
        self.random_routing = random_routing
        self.layer_norm_eps = layer_norm_eps
        self.dtype = dtype


def gpt_moe_config(**overrides):
    """The benchmark's widths on its chip (gpt_moe_ep._shapes)."""
    kw = dict(hidden_size=768, num_layers=6, num_experts=8, num_heads=12)
    kw.update(overrides)
    return GPTMoEConfig(**kw)


def gpt_moe_tiny(**overrides):
    """The benchmark's CPU widths (gpt_moe_ep._shapes off the chip)."""
    kw = dict(hidden_size=64, num_layers=2, num_experts=4, num_heads=4)
    kw.update(overrides)
    return GPTMoEConfig(**kw)


class DenseFFN(nn.Module):
    """The benchmark's dense baseline: a 4h MLP."""

    def __init__(self, h, device, dtype, generator):
        super().__init__()
        self.fc1 = linear(h, 4 * h, device, dtype, generator)
        self.fc2 = linear(4 * h, h, device, dtype, generator)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class MoEBlock(nn.Module):
    def __init__(self, cfg, device, dtype, generator):
        super().__init__()
        h = cfg.hidden_size
        eps = cfg.layer_norm_eps
        self.ln1 = nn.LayerNorm(h, eps=eps, device=device, dtype=dtype)
        self.attn = MultiHeadAttention(h, cfg.num_heads, device=device,
                                       dtype=dtype, generator=generator)
        self.ln2 = nn.LayerNorm(h, eps=eps, device=device, dtype=dtype)
        if cfg.dispatch_mode == "dense":
            self.moe = DenseFFN(h, device, dtype, generator)
        else:
            gate = GShardGate(h, cfg.num_experts, topk=cfg.top_k,
                              random_routing=cfg.random_routing,
                              device=device, dtype=dtype,
                              generator=generator)
            self.moe = MoELayer(
                d_model=h, num_expert=cfg.num_experts, d_hidden=cfg.d_hidden,
                gate=gate, top_k=cfg.top_k,
                dispatch_mode=cfg.dispatch_mode,
                capacity_factor=cfg.capacity_factor,
                group_block=cfg.group_block, expert_quant=cfg.expert_quant,
                device=device, dtype=dtype, generator=generator)

    def forward(self, x):
        y = self.ln1(x)
        x = x + self.attn(y, y, y)
        return x + self.moe(self.ln2(x))


class MoEGPT(nn.Module):
    """The benchmark's MoEGPT, built on ``device`` (default ``cuda``;
    raises without a card unless ``device="cpu"``) with weights drawn
    from ``generator`` (seed 0 when None). forward(ids [B, S]) -> logits
    [B, S, vocab]."""

    def __init__(self, config, device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        dtype = torch_dtype(config.dtype)
        gen = seed(0, dev) if generator is None else generator
        self.config = config
        h = config.hidden_size
        self.emb = embedding(config.vocab_size, h, dev, dtype, gen)
        self.blocks = nn.ModuleList([MoEBlock(config, dev, dtype, gen)
                                     for _ in range(config.num_layers)])
        self.head = linear(h, config.vocab_size, dev, dtype, gen)
        # parameters carry their qualified names (the optimizer keys its
        # state by them), as LlamaForCausalLM's do
        for name, p in self.named_parameters():
            p.param_name = name

    def forward(self, ids):
        x = self.emb(ids)
        for blk in self.blocks:
            x = blk(x)
        return self.head(x)


def moe_loss(logits, labels):
    """The benchmark's loss_fn: mean cross-entropy over the flattened
    float32 logits."""
    v = logits.shape[-1]
    return cross_entropy(logits.reshape(-1, v).float(), labels.reshape(-1))


def moe_flops_per_token(model, seq):
    """(params, activated params, flops per token) by the benchmark's
    formula: a token runs top_k of the experts' FFNs, and flops per token
    are 6 x activated params + 12 x layers x hidden x seq."""
    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    expert = 0
    if cfg.dispatch_mode != "dense":
        expert = sum(p.numel() for blk in model.blocks
                     for p in blk.moe.experts.parameters())
    n_active = n_params - expert + expert * cfg.top_k // cfg.num_experts
    flops = 6.0 * n_active + 12.0 * cfg.num_layers * cfg.hidden_size * seq
    return n_params, n_active, flops
