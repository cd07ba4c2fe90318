"""GPT-2 for causal LM (counterpart of paddle_tpu/models/gpt.py; BASELINE
configuration 2, "GPT-2 124M dygraph DP", of benchmarks/gpt2_dp.py).

Learned position embeddings, pre-LN blocks (LayerNorm, a fused qkv
projection into causal flash attention, a tanh-GELU MLP, dropout after
the embedding sum, the attention output and the MLP) and an LM head tied
to the token embedding: ``logits = F.linear(h, wte.weight)``, with no
parameter of its own, so autograd sums the embedding's and the head's
gradients into ``wte.weight``. Module and parameter names are the JAX
model's (``gpt.h.<i>.attn.qkv_proj.weight`` ...); convert.gpt_params_from_jax
transposes its Linear weights, which torch keeps as [out, in].

Weights follow paddle's initialisers (Linear XavierUniform with a zero
bias, Embedding XavierNormal, LayerNorm ones and zeros), drawn from the
model's ``generator``. Every dropout mask is drawn from that same
generator afterwards (the port never reads torch's global RNG), so two
models built from one seed draw the same masks. ``recompute=True``
checkpoints each block in training; the recomputation replays the
generator from the state it had when the block first ran, so a
recomputed block draws the forward's masks and its gradients are the
ones without recompute. Tensor and pipeline parallelism raise.
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from ..framework.device import resolve_device, seed, torch_dtype
from ..nn.functional.activation import gelu
from ..nn.functional.flash_attention import (flash_attention,
                                             scaled_dot_product_attention)
from ..nn.functional.loss import cross_entropy
from ..nn.layer.common import Dropout, embedding, linear
from ..nn.layer.norm import LayerNorm

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "gpt2_124m",
           "gpt_tiny"]


class GPTConfig:
    """The JAX package's GPTConfig fields. The port reads the model
    fields; the parallelism fields exist so that a shared config raises
    instead of being silently ignored."""

    def __init__(self, vocab_size=50304, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=None, max_position_embeddings=1024,
                 layer_norm_epsilon=1e-5, dropout=0.1,
                 use_flash_attention=True, tensor_parallel=False,
                 recompute=False, recompute_granularity="layer",
                 dtype="float32",
                 pipeline_parallel=False, pp_microbatches=None,
                 virtual_pp_degree=1, pipeline_save_mode="scan"):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.max_position_embeddings = max_position_embeddings
        self.layer_norm_epsilon = layer_norm_epsilon
        self.dropout = dropout
        self.use_flash_attention = use_flash_attention
        self.tensor_parallel = tensor_parallel
        self.recompute = recompute
        self.recompute_granularity = recompute_granularity
        self.dtype = dtype
        self.pipeline_parallel = pipeline_parallel
        self.pp_microbatches = pp_microbatches
        self.virtual_pp_degree = virtual_pp_degree
        self.pipeline_save_mode = pipeline_save_mode

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def _check_supported(cfg):
    for name in ("tensor_parallel", "pipeline_parallel"):
        if getattr(cfg, name):
            raise NotImplementedError(
                f"GPTConfig.{name} is not ported to the PyTorch package yet "
                f"(it runs on a single device)")


class GPTAttention(nn.Module):
    def __init__(self, config, device, dtype, generator):
        super().__init__()
        self.config = config
        self.num_heads = config.num_attention_heads
        self.head_dim = config.head_dim
        h = config.hidden_size
        self.qkv_proj = linear(h, 3 * h, device, dtype, generator)
        self.out_proj = linear(h, h, device, dtype, generator)
        self.dropout = Dropout(config.dropout, generator=generator)

    def forward(self, x):
        B, S = x.shape[0], x.shape[1]
        qkv = self.qkv_proj(x).reshape(B, S, 3, self.num_heads,
                                       self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if self.config.use_flash_attention:
            out, _ = flash_attention(q, k, v, causal=True)
        else:
            out = scaled_dot_product_attention(q, k, v, is_causal=True)
        out = out.reshape(B, S, self.num_heads * self.head_dim)
        return self.dropout(self.out_proj(out))


class GPTMLP(nn.Module):
    def __init__(self, config, device, dtype, generator):
        super().__init__()
        h, f = config.hidden_size, config.intermediate_size
        self.fc_in = linear(h, f, device, dtype, generator)
        self.fc_out = linear(f, h, device, dtype, generator)
        self.dropout = Dropout(config.dropout, generator=generator)

    def forward(self, x):
        return self.dropout(self.fc_out(gelu(self.fc_in(x),
                                             approximate=True)))


class GPTBlock(nn.Module):
    def __init__(self, config, device, dtype, generator):
        super().__init__()
        h, eps = config.hidden_size, config.layer_norm_epsilon
        self.ln_1 = LayerNorm(h, epsilon=eps, device=device, dtype=dtype)
        self.attn = GPTAttention(config, device, dtype, generator)
        self.ln_2 = LayerNorm(h, epsilon=eps, device=device, dtype=dtype)
        self.mlp = GPTMLP(config, device, dtype, generator)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


def _replay_generator(generator):
    """checkpoint's context_fn for one block: the forward notes the
    generator's state as the block starts; the recomputation sets that
    state for the block's rerun (so its dropouts draw the forward's
    masks) and puts the generator back where it was afterwards, so that
    draws after the backward go on from the forward's end."""
    saved = {}

    @contextlib.contextmanager
    def forward():
        saved["state"] = generator.get_state()
        yield

    @contextlib.contextmanager
    def recompute():
        now = generator.get_state()
        generator.set_state(saved["state"])
        try:
            yield
        finally:
            generator.set_state(now)

    return forward(), recompute()


class GPTModel(nn.Module):
    def __init__(self, config, device, dtype, generator):
        super().__init__()
        self.config = config
        self.generator = generator
        h = config.hidden_size
        self.wte = embedding(config.vocab_size, h, device, dtype, generator)
        self.wpe = embedding(config.max_position_embeddings, h, device, dtype,
                             generator)
        self.drop = Dropout(config.dropout, generator=generator)
        self.h = nn.ModuleList([GPTBlock(config, device, dtype, generator)
                                for _ in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(h, epsilon=config.layer_norm_epsilon,
                              device=device, dtype=dtype)

    def forward(self, input_ids):
        S = input_ids.shape[1]
        pos = torch.arange(S, device=input_ids.device)
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        recompute = self.config.recompute and self.training
        # the global RNG is not saved: the masks come from self.generator,
        # which _replay_generator restores for the rerun
        replay = functools.partial(_replay_generator, self.generator)
        for block in self.h:
            if recompute:
                x = checkpoint(block, x, use_reentrant=False,
                               preserve_rng_state=False, context_fn=replay)
            else:
                x = block(x)
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    """GPT-2 with its tied head, built on ``device`` (default ``cuda``;
    raises without a card unless ``device="cpu"``), weights and then
    dropout masks drawn from ``generator`` (a torch.Generator on that
    device; seed 0 when None). forward(ids [B, S]) -> logits [B, S, V] in
    the config's dtype."""

    def __init__(self, config, device=None, generator=None):
        super().__init__()
        _check_supported(config)
        dev = resolve_device(device)
        gen = seed(0, dev) if generator is None else generator
        self.config = config
        self.gpt = GPTModel(config, dev, torch_dtype(config.dtype), gen)
        # parameters carry their qualified names (the optimizer keys its
        # state and apply_decay_param_fun by them), as LlamaForCausalLM's do
        for name, p in self.named_parameters():
            p.param_name = name

    @property
    def device(self):
        return self.gpt.wte.weight.device

    def forward(self, input_ids):
        hidden = self.gpt(input_ids)
        # tied head: logits = h @ wte^T
        return F.linear(hidden, self.gpt.wte.weight)

    def loss(self, logits, labels):
        return cross_entropy(logits.float(), labels.unsqueeze(-1))

    def generate(self, input_ids, **kwargs):
        from .generation import generate
        return generate(self, input_ids, **kwargs)


def gpt2_124m(**overrides):
    kw = dict(vocab_size=50304, hidden_size=768, num_hidden_layers=12,
              num_attention_heads=12, max_position_embeddings=1024)
    kw.update(overrides)
    return GPTConfig(**kw)


def gpt_tiny(**overrides):
    kw = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
              num_attention_heads=4, max_position_embeddings=128,
              dropout=0.0)
    kw.update(overrides)
    return GPTConfig(**kw)
