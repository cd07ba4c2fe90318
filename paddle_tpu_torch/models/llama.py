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
kernel.

``pipeline_parallel=True`` under fleet.init with a pp topology builds
only this rank's stage (models/llama_pipe.py): the embedding on stage 0,
its decoder layers, and the final norm and head on the last stage (a tied
embedding on both ends, its gradient summed over the two). TrainStep and
fleet's PipelineParallel run the 1F1B (or, with ``virtual_pp_degree`` >
1, interleaved) schedule over send/recv; ``forward`` returns the last
stage's logits on every rank of the pp group. MoE, context (ring)
parallelism, sequence parallelism under the pipeline and selective
recompute policies are not ported; a config that asks for them raises.

``sequence_parallel=True`` with ``tensor_parallel`` is Megatron's
sequence parallelism over the mp group: between the blocks each rank
holds S/mp positions, so the norms and residuals run on them; q/k/v and
gate/up are ColumnSequenceParallelLinear (all-gather of the sequence, or
the ``column_sp`` ring under mp_overlap), o and down
RowSequenceParallelLinear (reduce-scatter, or ``row_sp``). The
embedding's output is scattered over the sequence and the final norm's
gathered, so the head and the criterion see tensor parallelism's layout.
The norms' weights are marked sequence-parallel and their gradients
summed over mp as backward makes them. Without tensor parallelism the
flag changes nothing (the dense model), as the reference's pin on an
absent mp axis. The parameter names are tensor parallelism's.

Auto-parallel: after ``distributed.shard_layer`` the parameters are
DTensors, and the forward lifts every dense operand that meets them (the
ids, unless they came as a DTensor from ``shard_dataloader``, and the
RoPE tables) to a replicated DTensor on their mesh. Heads split over the
mesh stay split through the reshapes, RoPE and the grouped key-value
repeat, and ``flash_attention`` runs on each rank's heads. Megatron's
all-reduces at the split projections are shard_layer's hooks.
"""
from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from ..framework.device import resolve_device, seed, torch_dtype
from ..framework.dtensor import lift
from ..nn.functional.flash_attention import (flash_attention,
                                             scaled_dot_product_attention)
from ..nn.functional.loss import cross_entropy
from ..nn.layer.norm import RMSNorm
from ._stacked_pipe import PipelinedLM
from ._tp_utils import mp_group, parallel_linears

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "LlamaPretrainingCriterion", "llama_tiny", "llama_2_7b"]


def check_recompute_granularity(value):
    """The pipeline remat granularity knob (LlamaConfig and GPTConfig):
    "layer" checkpoints each decoder layer, "stage" each stage call."""
    if value not in ("layer", "stage"):
        raise ValueError(
            f"recompute_granularity must be 'layer' or 'stage', got "
            f"{value!r}")
    return value


def check_pipeline_save_mode(value, virtual_pp_degree=1):
    """The reference's validator of the pipeline's backward-save knob
    (LlamaConfig and GPTConfig). The knob says how XLA stores the JAX
    package's traced scan; the port keeps each microbatch's autograd
    graph whatever its value (fleet/meta_parallel/pipeline_spmd.py)."""
    if value not in ("scan", "unroll", "buffer"):
        raise ValueError(
            f"pipeline_save_mode must be 'scan', 'unroll' or 'buffer', "
            f"got {value!r}")
    if value == "buffer" and virtual_pp_degree > 1:
        raise ValueError(
            "pipeline_save_mode='buffer' applies to the non-interleaved "
            "pipeline; use 'unroll' with virtual_pp_degree > 1")
    return value


class LlamaConfig:
    """The JAX package's LlamaConfig fields and defaults. The parallelism
    fields the port has not ported exist so a shared config raises
    instead of being silently ignored."""

    def __init__(self, vocab_size=32000, hidden_size=4096,
                 intermediate_size=11008, num_hidden_layers=32,
                 num_attention_heads=32, num_key_value_heads=None,
                 max_position_embeddings=4096, rms_norm_eps=1e-5,
                 rope_theta=10000.0, tie_word_embeddings=False,
                 use_flash_attention=True, tensor_parallel=False,
                 sequence_parallel=False, recompute=False,
                 recompute_policy=None, recompute_granularity="layer",
                 dtype="float32", pipeline_parallel=False,
                 pp_microbatches=None, virtual_pp_degree=1, head_dim=None,
                 pin_pipeline_carry=False, pipeline_save_mode="scan",
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
        self.recompute_granularity = check_recompute_granularity(
            recompute_granularity)
        self.dtype = dtype
        self.pipeline_parallel = pipeline_parallel
        self.pp_microbatches = pp_microbatches
        # interleaved chunks a stage (virtual pipeline): the bubble shrinks
        # by this factor
        self.virtual_pp_degree = virtual_pp_degree
        # a placement hint of the JAX package's scan carry: accepted and
        # ignored (a rank's carry is its own tensor)
        self.pin_pipeline_carry = pin_pipeline_carry
        self.pipeline_save_mode = check_pipeline_save_mode(
            pipeline_save_mode, virtual_pp_degree)
        self._head_dim = head_dim
        self.context_parallel = context_parallel
        self.num_experts = int(num_experts or 0)

    @property
    def head_dim(self):
        return self._head_dim or self.hidden_size // self.num_attention_heads


def _check_supported(cfg):
    if cfg.sequence_parallel and cfg.pipeline_parallel:
        raise NotImplementedError(
            "LlamaConfig.sequence_parallel with pipeline_parallel is not "
            "ported to the PyTorch package yet (sequence parallelism under "
            "tensor parallelism is)")
    for name in ("context_parallel", "num_experts"):
        if getattr(cfg, name):
            raise NotImplementedError(
                f"LlamaConfig.{name} is not ported to the PyTorch package "
                f"yet (data, tensor and pipeline parallelism are)")
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
        q = self.q_proj(x)
        # the whole sequence: under sequence parallelism x holds a part
        B, S = q.shape[0], q.shape[1]
        q = q.reshape(B, S, self.num_heads, self.head_dim)
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


def _no_mask(config, attn_mask):
    """The models are causal: an explicit mask raises the reference's
    ValueError under the pipeline, NotImplementedError elsewhere."""
    if attn_mask is None:
        return
    if config.pipeline_parallel:
        raise ValueError("pipeline_parallel Llama supports causal attention "
                         "only (attn_mask must be None)")
    raise NotImplementedError("LlamaForCausalLM(attn_mask=...) is not "
                              "ported to the PyTorch package yet")


def _seq_group(config):
    """The mp group a sequence-parallel model splits its sequence over
    (None when it does not)."""
    if not (config.sequence_parallel and config.tensor_parallel):
        return None
    g = mp_group(config)
    return g if g is not None and g.nranks > 1 else None


def _embedding(config, device, dtype):
    if config.tensor_parallel:
        from ..distributed.fleet.meta_parallel import VocabParallelEmbedding
        return VocabParallelEmbedding(config.vocab_size, config.hidden_size,
                                      device=device, dtype=dtype)
    return nn.utils.skip_init(nn.Embedding, config.vocab_size,
                              config.hidden_size, device=device, dtype=dtype)


def _stage_ends(config):
    """(holds the first stage, holds the last stage) of this rank."""
    if not config.pipeline_parallel:
        return True, True
    from ._stacked_pipe import pipeline_topology
    hcg = pipeline_topology()
    return hcg.is_first_stage(), hcg.is_last_stage()


class LlamaModel(PipelinedLM, nn.Module):
    """Embedding, decoder layers and final norm; under pipeline_parallel
    this rank's stage of them (the embedding on the first stage, and on
    the last too for a tied head; the norm on the last)."""

    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        self.config = config
        first, last = _stage_ends(config)
        if first or (last and config.tie_word_embeddings):
            self.embed_tokens = _embedding(config, device, dtype)
        if config.pipeline_parallel:
            from .llama_pipe import LlamaStackedDecoder
            self.decoder_stack = LlamaStackedDecoder(config, device, dtype)
        else:
            self.layers = nn.ModuleList(
                [LlamaDecoderLayer(config, device, dtype)
                 for _ in range(config.num_hidden_layers)])
        if last:
            self.norm = RMSNorm(config.hidden_size,
                                epsilon=config.rms_norm_eps, device=device,
                                dtype=dtype)
        cos, sin = _rope_tables(config.head_dim,
                                config.max_position_embeddings,
                                config.rope_theta)
        self.register_buffer("rope_cos", torch.from_numpy(cos).to(device),
                             persistent=False)
        self.register_buffer("rope_sin", torch.from_numpy(sin).to(device),
                             persistent=False)

    @property
    def device(self):
        return self.rope_cos.device

    def _pp_stack(self):
        return getattr(self, "decoder_stack", None)

    def _pp_tied(self):
        return None

    def _pp_stage(self, chunk, x):
        """Chunk ``chunk`` of this stage: the embedding first on virtual
        stage 0, the norm last on the last one."""
        st = self.decoder_stack
        v = chunk * st._pp + st._stage
        if v == 0:
            x = self.embed_tokens(x)
        S = x.shape[1]
        x = st(chunk, x, self.rope_cos[:S], self.rope_sin[:S])
        return self.norm(x) if v == st._pp * st._vpp - 1 else x

    def forward(self, input_ids, attn_mask=None):
        _no_mask(self.config, attn_mask)
        if self.config.pipeline_parallel:
            return self._pipeline_forward(input_ids)
        S = input_ids.shape[1]
        w = self.embed_tokens.weight
        x = self.embed_tokens(lift(input_ids, w))
        cos, sin = lift(self.rope_cos[:S], w), lift(self.rope_sin[:S], w)
        sp = _seq_group(self.config)
        if sp is not None:
            from ..distributed.fleet.utils.sequence_parallel_utils import (
                ScatterOp)
            x = ScatterOp.apply(x, sp)
        # full recompute of each layer in training, as the JAX model's
        # recompute with policy None: the backward reruns the layer's
        # forward instead of keeping its activations
        recompute = self.config.recompute and self.training
        for layer in self.layers:
            if recompute:
                x = checkpoint(layer, x, cos, sin, use_reentrant=False)
            else:
                x = layer(x, cos, sin)
        x = self.norm(x)
        if sp is not None:
            from ..distributed.fleet.utils.sequence_parallel_utils import (
                GatherOp)
            x = GatherOp.apply(x, sp)
        return x


class LlamaForCausalLM(PipelinedLM, nn.Module):
    """Llama with its LM head, built on ``device`` (default ``cuda``;
    raises without a card unless ``device="cpu"``). Weights are drawn
    from ``generator`` (a torch.Generator on that device; seed 0 when
    None) as N(0, 0.02) for embeddings and projections, 1 for norms, in
    the one-rank model's order: a tensor-parallel or pipelined rank draws
    every weight whole and keeps its shard, so it holds the one-rank
    model's weights."""

    def __init__(self, config, device=None, generator=None):
        super().__init__()
        _check_supported(config)
        dev = resolve_device(device)
        dtype = torch_dtype(config.dtype)
        self.config = config
        self.llama = LlamaModel(config, dev, dtype)
        first, last = _stage_ends(config)
        self.lm_head = None
        if not config.tie_word_embeddings and last and \
                config.tensor_parallel:
            # on the gathered final hidden state, sequence-parallel or not
            from ..distributed.fleet.meta_parallel.mp_layers import (
                ColumnParallelLinear)
            self.lm_head = ColumnParallelLinear(
                config.hidden_size, config.vocab_size, has_bias=False,
                gather_output=False, device=dev, dtype=dtype)
        elif not config.tie_word_embeddings and last:
            col, _ = parallel_linears(config, dev, dtype)
            self.lm_head = col(config.hidden_size, config.vocab_size)
        if config.pipeline_parallel:
            self._make_shared_group(config.tie_word_embeddings)
        self.init_weights(seed(0, dev) if generator is None else generator)
        # parameters carry their qualified names, as paddle parameters
        # carry a name (torch's Tensor.name is taken): the optimizer keys
        # its state and apply_decay_param_fun by it
        for name, p in self.named_parameters():
            p.param_name = name
        if _seq_group(config) is not None:
            from ..distributed.fleet.utils.sequence_parallel_utils import (
                mark_as_sequence_parallel_parameter,
                register_sequence_parallel_allreduce_hooks)
            for name, p in self.named_parameters():
                if name.endswith("norm.weight"):
                    mark_as_sequence_parallel_parameter(p)
            register_sequence_parallel_allreduce_hooks(self)

    @property
    def device(self):
        return self.llama.device

    def _natural_params(self):
        """(name, whole shape) of every parameter of the one-rank model,
        in its order, under this model's names."""
        cfg = self.config
        V, h = cfg.vocab_size, cfg.hidden_size
        yield "llama.embed_tokens.weight", (V, h)
        dense = copy.copy(cfg)
        dense.tensor_parallel = False
        per = [(n, tuple(p.shape)) for n, p in
               LlamaDecoderLayer(dense, "meta").named_parameters()]
        prefix = "llama.decoder_stack.layers" if cfg.pipeline_parallel \
            else "llama.layers"
        for l in range(cfg.num_hidden_layers):
            for n, shape in per:
                yield f"{prefix}.{l}.{n}", shape
        yield "llama.norm.weight", (h,)
        if not cfg.tie_word_embeddings:
            yield "lm_head.weight", (V, h)

    @torch.no_grad()
    def init_weights(self, generator):
        """Norms 1, everything else N(0, 0.02), drawn whole in the one-rank
        model's order; a rank keeps the weights (or tensor-parallel
        slices) it holds and draws the others only to keep its generator
        in step."""
        from ..distributed.fleet.meta_parallel.mp_layers import shard_like
        local = dict(self.named_parameters())
        dtype = torch_dtype(self.config.dtype)
        for name, shape in self._natural_params():
            p = local.get(name)
            if name.endswith("norm.weight"):
                if p is not None:
                    p.fill_(1.0)
            elif p is not None and not hasattr(p, "tp_full_shape"):
                p.normal_(0.0, 0.02, generator=generator)
            else:
                full = torch.empty(shape, device=self.device, dtype=dtype)
                full.normal_(0.0, 0.02, generator=generator)
                if p is not None:
                    p.copy_(shard_like(full, p))

    def _pp_stack(self):
        return self.llama._pp_stack()

    def _pp_tied(self):
        if not self.config.tie_word_embeddings:
            return None
        emb = getattr(self.llama, "embed_tokens", None)
        return None if emb is None else emb.weight

    def _head(self, hidden):
        if self.lm_head is None:
            from ..distributed.fleet.meta_parallel.mp_layers import (
                parallel_logits)
            return parallel_logits(hidden, self.llama.embed_tokens.weight,
                                   mp_group(self.config))
        return self.lm_head(hidden)

    def _pp_stage(self, chunk, x):
        st = self._pp_stack()
        h = self.llama._pp_stage(chunk, x)
        last = chunk * st._pp + st._stage == st._pp * st._vpp - 1
        return self._head(h) if last else h

    def forward(self, input_ids, attn_mask=None):
        """Logits [B, S, V]; under tensor parallelism this rank's
        vocab shard [B, S, V / mp]; under pipeline parallelism the last
        stage's, on every rank of the pp group."""
        _no_mask(self.config, attn_mask)
        if self.config.pipeline_parallel:
            return self._pipeline_forward(input_ids)
        return self._head(self.llama(input_ids))

    def generate(self, input_ids, **kwargs):
        if self.config.pipeline_parallel:
            raise NotImplementedError(
                "generate on a pipeline-parallel model is not ported; "
                "load its weights into a one-rank model to decode")
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
        # the pipeline weights microbatch losses by the positions this
        # mean counts: every position under tensor parallelism
        self.pipeline_mean_over_positions = bool(
            config is not None and config.tensor_parallel)
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
