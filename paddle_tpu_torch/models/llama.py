"""Llama for causal LM and its pretraining criterion (counterpart of
paddle_tpu/models/llama.py).

The modules and parameter names mirror the JAX package, so a JAX state
dict converts one to one (convert.params_from_jax). Two layouts differ:
torch.nn.Linear keeps its weight as [out, in] where paddle keeps [in,
out], and the converter owns that transpose. The model trains under
``.train()``; ``recompute=True`` checkpoints each decoder layer.

``tensor_parallel=True`` builds the Megatron split over fleet's mp group
(one rank when fleet is not initialized): the embedding is a
VocabParallelEmbedding, q/k/v and gate/up are ColumnParallelLinear (each
rank computes heads / mp query heads and kv_heads / mp key-value heads,
and intermediate / mp features), o and down are RowParallelLinear, the
head a ColumnParallelLinear whose logits stay vocab-sharded, and the
criterion is ParallelCrossEntropy. Weights are drawn whole from the
generator and sliced, so n ranks hold the slices of the one-rank model,
and at one rank the model computes what the dense model does, kernel for
kernel. Pipeline parallelism, MoE, context (ring) parallelism, sequence
parallelism and selective recompute policies are not ported; a config
that asks for them raises.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from ..framework.device import resolve_device, seed, torch_dtype
from ..nn.functional.flash_attention import (flash_attention,
                                             scaled_dot_product_attention)
from ..nn.functional.loss import cross_entropy
from ..nn.layer.norm import RMSNorm
from ._tp_utils import mp_group, parallel_linears

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "LlamaPretrainingCriterion", "llama_tiny", "llama_2_7b"]


class LlamaConfig:
    """The JAX package's LlamaConfig fields. The port reads the model
    fields; the parallelism fields exist so a shared config raises
    instead of being silently ignored."""

    def __init__(self, vocab_size=32000, hidden_size=4096,
                 intermediate_size=11008, num_hidden_layers=32,
                 num_attention_heads=32, num_key_value_heads=None,
                 max_position_embeddings=4096, rms_norm_eps=1e-5,
                 rope_theta=10000.0, tie_word_embeddings=False,
                 use_flash_attention=True, tensor_parallel=False,
                 sequence_parallel=False, recompute=False,
                 recompute_policy=None, dtype="float32",
                 pipeline_parallel=False, head_dim=None,
                 context_parallel=False, num_experts=0):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = num_key_value_heads or num_attention_heads
        self.max_position_embeddings = max_position_embeddings
        self.rms_norm_eps = rms_norm_eps
        self.rope_theta = rope_theta
        self.tie_word_embeddings = tie_word_embeddings
        self.use_flash_attention = use_flash_attention
        self.tensor_parallel = tensor_parallel
        self.sequence_parallel = sequence_parallel
        self.recompute = recompute
        self.recompute_policy = recompute_policy
        self.dtype = dtype
        self.pipeline_parallel = pipeline_parallel
        self._head_dim = head_dim
        self.context_parallel = context_parallel
        self.num_experts = int(num_experts or 0)

    @property
    def head_dim(self):
        return self._head_dim or self.hidden_size // self.num_attention_heads


def _check_supported(cfg):
    for name in ("sequence_parallel", "pipeline_parallel",
                 "context_parallel", "num_experts"):
        if getattr(cfg, name):
            raise NotImplementedError(
                f"LlamaConfig.{name} is not ported to the PyTorch package "
                f"yet (it runs on a single device)")
    if cfg.recompute and cfg.recompute_policy is not None:
        raise NotImplementedError(
            f"LlamaConfig.recompute_policy={cfg.recompute_policy!r} is not "
            f"ported to the PyTorch package yet; recompute=True with "
            f"recompute_policy=None checkpoints whole decoder layers")


# -- rotary embedding ---------------------------------------------------------

def _rope_tables(head_dim, max_pos, theta):
    """cos/sin tables [max_pos, head_dim] computed in float64 and cast to
    float32, exactly as the JAX package does (bit-identical tables)."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                                / head_dim))
    t = np.arange(max_pos, dtype=np.float64)
    freqs = np.outer(t, inv_freq)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return (np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32))


def _rope_apply(x, cos, sin):
    """NeoX rotate-half RoPE. x [B, S, H, D]; cos/sin [S, D]."""
    c = cos[None, :, None, :].to(x.dtype)
    s = sin[None, :, None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return x * c + torch.cat([-x2, x1], dim=-1) * s


def _mp_size(config):
    g = mp_group(config)
    return 1 if g is None else g.nranks


class LlamaAttention(nn.Module):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        mp = _mp_size(config)
        if config.num_attention_heads % mp or \
                config.num_key_value_heads % mp:
            raise ValueError(
                f"{config.num_attention_heads} heads and "
                f"{config.num_key_value_heads} key-value heads do not "
                f"split over mp {mp}")
        # this rank's heads (all of them without tensor parallelism)
        self.num_heads = config.num_attention_heads // mp
        self.num_kv_heads = config.num_key_value_heads // mp
        self.head_dim = config.head_dim
        self.use_flash = config.use_flash_attention
        h, hd = config.hidden_size, config.head_dim
        col, row = parallel_linears(config, device, dtype)
        self.q_proj = col(h, config.num_attention_heads * hd)
        self.k_proj = col(h, config.num_key_value_heads * hd)
        self.v_proj = col(h, config.num_key_value_heads * hd)
        self.o_proj = row(config.num_attention_heads * hd, h)

    def forward(self, x, cos, sin):
        B, S = x.shape[0], x.shape[1]
        q = self.q_proj(x).reshape(B, S, self.num_heads, self.head_dim)
        k = self.k_proj(x).reshape(B, S, self.num_kv_heads, self.head_dim)
        v = self.v_proj(x).reshape(B, S, self.num_kv_heads, self.head_dim)
        q, k = _rope_apply(q, cos, sin), _rope_apply(k, cos, sin)
        if self.num_kv_heads != self.num_heads:
            n_rep = self.num_heads // self.num_kv_heads
            k = k.repeat_interleave(n_rep, dim=2)
            v = v.repeat_interleave(n_rep, dim=2)
        if self.use_flash:
            out, _ = flash_attention(q, k, v, causal=True)
        else:
            out = scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.o_proj(out.reshape(B, S, self.num_heads * self.head_dim))


class LlamaMLP(nn.Module):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        h, f = config.hidden_size, config.intermediate_size
        col, row = parallel_linears(config, device, dtype)
        self.gate_proj = col(h, f)
        self.up_proj = col(h, f)
        self.down_proj = row(f, h)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        eps = config.rms_norm_eps
        self.input_layernorm = RMSNorm(config.hidden_size, epsilon=eps,
                                       device=device, dtype=dtype)
        self.self_attn = LlamaAttention(config, device, dtype)
        self.post_attention_layernorm = RMSNorm(
            config.hidden_size, epsilon=eps, device=device, dtype=dtype)
        self.mlp = LlamaMLP(config, device, dtype)

    def forward(self, x, cos, sin):
        h = x + self.self_attn(self.input_layernorm(x), cos, sin)
        return h + self.mlp(self.post_attention_layernorm(h))


class LlamaModel(nn.Module):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        self.config = config
        if config.tensor_parallel:
            from ..distributed.fleet.meta_parallel import (
                VocabParallelEmbedding)
            self.embed_tokens = VocabParallelEmbedding(
                config.vocab_size, config.hidden_size, device=device,
                dtype=dtype)
        else:
            self.embed_tokens = nn.utils.skip_init(
                nn.Embedding, config.vocab_size, config.hidden_size,
                device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, device, dtype)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, epsilon=config.rms_norm_eps,
                            device=device, dtype=dtype)
        cos, sin = _rope_tables(config.head_dim,
                                config.max_position_embeddings,
                                config.rope_theta)
        self.register_buffer("rope_cos", torch.from_numpy(cos).to(device),
                             persistent=False)
        self.register_buffer("rope_sin", torch.from_numpy(sin).to(device),
                             persistent=False)

    def forward(self, input_ids):
        S = input_ids.shape[1]
        x = self.embed_tokens(input_ids)
        cos, sin = self.rope_cos[:S], self.rope_sin[:S]
        # full recompute of each layer in training, as the JAX model's
        # recompute with policy None: the backward reruns the layer's
        # forward instead of keeping its activations
        recompute = self.config.recompute and self.training
        for layer in self.layers:
            if recompute:
                x = checkpoint(layer, x, cos, sin, use_reentrant=False)
            else:
                x = layer(x, cos, sin)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """Llama with its LM head, built on ``device`` (default ``cuda``;
    raises without a card unless ``device="cpu"``). Weights are drawn
    from ``generator`` (a torch.Generator on that device; seed 0 when
    None) as N(0, 0.02) for embeddings and projections, 1 for norms."""

    def __init__(self, config, device=None, generator=None):
        super().__init__()
        _check_supported(config)
        dev = resolve_device(device)
        dtype = torch_dtype(config.dtype)
        self.config = config
        self.llama = LlamaModel(config, dev, dtype)
        self.lm_head = None
        if not config.tie_word_embeddings:
            col, _ = parallel_linears(config, dev, dtype)
            self.lm_head = col(config.hidden_size, config.vocab_size)
        self.init_weights(seed(0, dev) if generator is None else generator)
        # parameters carry their qualified names, as paddle parameters
        # carry a name (torch's Tensor.name is taken): the optimizer keys
        # its state and apply_decay_param_fun by it
        for name, p in self.named_parameters():
            p.param_name = name

    @property
    def device(self):
        return self.llama.embed_tokens.weight.device

    @torch.no_grad()
    def init_weights(self, generator):
        """Norms 1, everything else N(0, 0.02); a tensor-parallel shard is
        its slice of the whole tensor drawn in its place."""
        from ..distributed.fleet.meta_parallel.mp_layers import shard_like
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            elif hasattr(p, "tp_full_shape"):
                full = torch.empty(p.tp_full_shape, device=p.device,
                                   dtype=p.dtype)
                p.copy_(shard_like(full.normal_(0.0, 0.02,
                                                generator=generator), p))
            else:
                p.normal_(0.0, 0.02, generator=generator)

    def forward(self, input_ids):
        """Logits [B, S, V]; under tensor parallelism this rank's
        vocab shard [B, S, V / mp]."""
        hidden = self.llama(input_ids)
        if self.lm_head is None:
            from ..distributed.fleet.meta_parallel.mp_layers import (
                parallel_logits)
            return parallel_logits(hidden, self.llama.embed_tokens.weight,
                                   mp_group(self.config))
        return self.lm_head(hidden)

    def generate(self, input_ids, **kwargs):
        from .generation import generate
        return generate(self, input_ids, **kwargs)


class LlamaPretrainingCriterion(nn.Module):
    """Next-token cross-entropy over logits [B, S, V] and pre-shifted
    labels [B, S] (the caller shifts, as the reference's data pipeline
    does): logits are cast to float32 first, labels of -100 are ignored,
    and the mean is over the valid labels. With a tensor-parallel config
    the logits are vocab-sharded and ParallelCrossEntropy computes the
    loss; as the reference's, that mean is then over every position (an
    ignored one counts 0)."""

    def __init__(self, config=None):
        super().__init__()
        self._pce = None
        if config is not None and config.tensor_parallel:
            from ..distributed.fleet.meta_parallel import (
                ParallelCrossEntropy)
            self._pce = ParallelCrossEntropy()

    def forward(self, logits, labels):
        logits = logits.float()
        if self._pce is not None:
            loss = self._pce(logits, labels.unsqueeze(-1))
            # divided by a device count, as cross_entropy's mean is, so
            # that one rank's loss is the dense criterion's bit for bit
            return loss.sum() / torch.tensor(loss.numel(),
                                             device=loss.device)
        return cross_entropy(logits, labels.unsqueeze(-1))


def llama_tiny(**overrides):
    """A tiny config for tests and dry-runs."""
    kw = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=128)
    kw.update(overrides)
    return LlamaConfig(**kw)


def llama_2_7b(**overrides):
    kw = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
              num_hidden_layers=32, num_attention_heads=32,
              max_position_embeddings=4096)
    kw.update(overrides)
    return LlamaConfig(**kw)
