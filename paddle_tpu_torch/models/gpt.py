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
ones without recompute.

``tensor_parallel=True`` splits the blocks and the vocabulary over fleet's
mp group. ``pipeline_parallel=True`` (with dropout 0, as the reference
requires) builds this rank's stage (models/gpt_pipe.py): ``wte`` on the
first and the last stage (the head is tied: the two gradients are summed
over the pair before a step), ``wpe`` on the first, ``ln_f`` on the last.
Every rank builds every weight in the one-rank model's order from the
generator and keeps its own, so the stages hold the one-rank model's
weights.
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
from ..nn.layer.common import Dropout, embedding
from ..nn.layer.norm import LayerNorm
from ._stacked_pipe import PipelinedLM
from ._tp_utils import mp_group, parallel_linears

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "gpt2_124m",
           "gpt_tiny"]


class GPTConfig:
    """The JAX package's GPTConfig fields, defaults and validators."""

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
        from .llama import (check_pipeline_save_mode,
                            check_recompute_granularity)
        self.recompute_granularity = check_recompute_granularity(
            recompute_granularity)
        self.dtype = dtype
        self.pipeline_parallel = pipeline_parallel
        self.pp_microbatches = pp_microbatches
        self.virtual_pp_degree = virtual_pp_degree
        self.pipeline_save_mode = check_pipeline_save_mode(
            pipeline_save_mode, virtual_pp_degree)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


class GPTAttention(nn.Module):
    def __init__(self, config, device, dtype, generator):
        super().__init__()
        self.config = config
        g = mp_group(config)
        mp = 1 if g is None else g.nranks
        if config.num_attention_heads % mp:
            raise ValueError(f"{config.num_attention_heads} heads do not "
                             f"split over mp {mp}")
        self.num_heads = config.num_attention_heads // mp   # this rank's
        self.head_dim = config.head_dim
        h = config.hidden_size
        col, row = parallel_linears(config, device, dtype, generator,
                                    has_bias=True)
        self.qkv_proj = col(h, 3 * h, fused_parts=3)
        self.out_proj = row(h, h)
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
        col, row = parallel_linears(config, device, dtype, generator,
                                    has_bias=True)
        self.fc_in = col(h, f)
        self.fc_out = row(f, h)
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


class GPTModel(PipelinedLM, nn.Module):
    def __init__(self, config, device, dtype, generator):
        super().__init__()
        from .llama import _stage_ends
        self.config = config
        self.generator = generator
        first, last = _stage_ends(config)
        h = config.hidden_size
        # every weight is drawn in the one-rank model's order; a pipelined
        # rank drops the ones another stage holds
        if config.tensor_parallel:
            from ..distributed.fleet.meta_parallel import (
                VocabParallelEmbedding)
            wte = VocabParallelEmbedding(config.vocab_size, h,
                                         device=device, dtype=dtype,
                                         generator=generator)
        else:
            wte = embedding(config.vocab_size, h, device, dtype, generator)
        if first or last:
            self.wte = wte
        wpe = embedding(config.max_position_embeddings, h, device, dtype,
                        generator)
        if first:
            self.wpe = wpe
        del wte, wpe
        self.drop = Dropout(config.dropout, generator=generator)
        if config.pipeline_parallel:
            from .gpt_pipe import GPTStackedDecoder
            self.decoder_stack = GPTStackedDecoder(config, device, dtype,
                                                   generator)
        else:
            self.h = nn.ModuleList([GPTBlock(config, device, dtype,
                                             generator)
                                    for _ in range(config.num_hidden_layers)])
        if last:
            self.ln_f = LayerNorm(h, epsilon=config.layer_norm_epsilon,
                                  device=device, dtype=dtype)

    def _pp_stack(self):
        return getattr(self, "decoder_stack", None)

    def _embed(self, input_ids):
        S = input_ids.shape[1]
        pos = torch.arange(S, device=input_ids.device)
        return self.drop(self.wte(input_ids) + self.wpe(pos))

    def _pp_stage(self, chunk, x):
        """Chunk ``chunk`` of this stage: the embeddings first on virtual
        stage 0, ln_f last on the last one."""
        st = self.decoder_stack
        v = chunk * st._pp + st._stage
        if v == 0:
            x = self._embed(x)
        x = st(chunk, x)
        return self.ln_f(x) if v == st._pp * st._vpp - 1 else x

    def forward(self, input_ids):
        if self.config.pipeline_parallel:
            return self._pipeline_forward(input_ids)
        x = self._embed(input_ids)
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

    @property
    def device(self):
        return next(self.parameters()).device


class GPTForCausalLM(PipelinedLM, nn.Module):
    """GPT-2 with its tied head, built on ``device`` (default ``cuda``;
    raises without a card unless ``device="cpu"``), weights and then
    dropout masks drawn from ``generator`` (a torch.Generator on that
    device; seed 0 when None). forward(ids [B, S]) -> logits [B, S, V] in
    the config's dtype."""

    def __init__(self, config, device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = seed(0, dev) if generator is None else generator
        self.config = config
        self.gpt = GPTModel(config, dev, torch_dtype(config.dtype), gen)
        if config.pipeline_parallel:
            self._make_shared_group(True)
        # parameters carry their qualified names (the optimizer keys its
        # state and apply_decay_param_fun by them), as LlamaForCausalLM's do
        for name, p in self.named_parameters():
            p.param_name = name

    @property
    def device(self):
        return self.gpt.device

    def _pp_stack(self):
        return self.gpt._pp_stack()

    def _pp_tied(self):
        wte = getattr(self.gpt, "wte", None)
        return None if wte is None else wte.weight

    def _head(self, hidden):
        # tied head: logits = h @ wte^T
        if self.config.tensor_parallel:
            from ..distributed.fleet.meta_parallel.mp_layers import (
                parallel_logits)
            return parallel_logits(hidden, self.gpt.wte.weight,
                                   mp_group(self.config))
        return F.linear(hidden, self.gpt.wte.weight)

    def _pp_stage(self, chunk, x):
        st = self._pp_stack()
        h = self.gpt._pp_stage(chunk, x)
        last = chunk * st._pp + st._stage == st._pp * st._vpp - 1
        return self._head(h) if last else h

    def forward(self, input_ids):
        """Logits [B, S, V]; under tensor parallelism this rank's vocab
        shard [B, S, V / mp]; under pipeline parallelism the last stage's,
        on every rank of the pp group."""
        if self.config.pipeline_parallel:
            return self._pipeline_forward(input_ids)
        return self._head(self.gpt(input_ids))

    def loss(self, logits, labels):
        """Mean cross entropy over the labels that are not -100 (vocab-
        sharded logits under tensor parallelism)."""
        if self.config.tensor_parallel:
            from ..distributed.fleet.meta_parallel import (
                ParallelCrossEntropy)
            per = ParallelCrossEntropy()(logits.float(), labels.unsqueeze(-1))
            return per.sum() / (labels != -100).sum().clamp(min=1)
        return cross_entropy(logits.float(), labels.unsqueeze(-1))

    def generate(self, input_ids, **kwargs):
        if self.config.pipeline_parallel:
            raise NotImplementedError(
                "generate on a pipeline-parallel model is not ported; "
                "load its weights into a one-rank model to decode")
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
