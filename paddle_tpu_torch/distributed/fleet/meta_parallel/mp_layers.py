"""Tensor-parallel layers (counterpart of
paddle_tpu/distributed/fleet/meta_parallel/mp_layers.py).

Each rank of the mp group holds its shard, as Paddle's mp layers do, and
the layer-boundary collectives are explicit (the reference lets GSPMD
insert the same ones):

- VocabParallelEmbedding: rows [r V/n, (r+1) V/n) of the vocabulary;
  ids outside them give zeros, and an all-reduce sums the ranks' rows;
- ColumnParallelLinear: output features [r O/n, (r+1) O/n); its input
  passes an identity whose backward all-reduces the input gradient, and
  ``gather_output`` all-gathers the output features;
- RowParallelLinear: input features [r I/n, (r+1) I/n); the partial
  products are all-reduced, then the (replicated) bias is added;
- ParallelCrossEntropy: cross entropy over vocab-sharded logits, with a
  MAX all-reduce of the row maxima and a SUM all-reduce of the exp-sums
  and of the target logit; ``ignore_index`` rows give zero loss and zero
  gradient.

Weights are torch's Linear layout ([out, in]) and are drawn whole from the
layer's generator with paddle's initialisers, then sliced, so that the
shards of n ranks built from one seed are the slices of the one-rank
model. A sharded parameter carries ``mp_sharded = True`` (Paddle's
``is_distributed``, which names a method of torch's tensors),
``split_axis`` and its full shape. At one rank every layer is the plain
torch op it replaces (no collective, the same kernels).

Column and Row take the reference's order: first the collective-matmul
rings (``overlapped_linear``: kinds ``column_gather``, ``column`` and
``row``) when ``mp_overlap`` is on and the call is eligible; else
``F.quant_linear`` (the quant_matmul kernel on the weight quantized per
block, full-precision gradients) when ``matmul_quant`` is set, with the
bias added outside the kernel; else the exact path. With both knobs on,
the rings win and the product is not quantized, as in the reference.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from ....framework.device import resolve_device, seed as _seed
from ....kernels.quant_matmul import (FP8_MAX, get_matmul_quant,
                                      quantized_linear)
from ....nn.functional.common import quant_linear
from ....nn.functional.loss import cross_entropy
from ...collective import ReduceOp, all_gather, all_reduce
from .collective_matmul import overlapped_linear

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "shard_of",
           "shard_like", "parallel_logits"]


def _mp_group(mp_group):
    """The layer's mp group: the one given, else fleet's, else none (one
    rank)."""
    if mp_group is not None:
        return mp_group
    from ..fleet import fleet
    hcg = fleet.get_hybrid_communicate_group()
    return hcg.get_model_parallel_group() if hcg is not None else None


def _size_rank(group):
    return (1, 0) if group is None else (group.nranks, group.rank)


def shard_of(full, dim, n, rank, parts=1):
    """Rank ``rank``'s slice of ``full`` along ``dim`` for ``n`` ranks.
    ``parts`` > 1 splits each of that many equal sections of ``dim``
    alike (a fused q/k/v projection: each rank takes its heads of each)."""
    if n == 1:
        return full
    if parts == 1:
        return full.chunk(n, dim)[rank]
    return torch.cat([p.chunk(n, dim)[rank] for p in full.chunk(parts, dim)],
                     dim)


def _not_ported(name, value):
    if value is not None:
        raise NotImplementedError(f"{name}= is not ported to the PyTorch "
                                  f"package's mp layers")


def _sharded_param(full_shape, dim, group, parts, init, device, dtype,
                   generator):
    """A Parameter holding this rank's slice of a tensor of
    ``full_shape`` drawn whole by ``init(tensor, generator)``."""
    n, rank = _size_rank(group)
    full = torch.empty(full_shape, device=device, dtype=dtype)
    with torch.no_grad():
        init(full, generator)
    p = nn.Parameter(shard_of(full, dim, n, rank, parts).contiguous())
    p.mp_sharded = n > 1
    p.split_axis = dim
    p.tp_parts = parts
    p.tp_full_shape = tuple(full_shape)
    p.tp_rank_size = (rank, n)
    return p


def shard_like(full, p):
    """``p``'s slice of ``full`` (a tensor of ``p``'s full shape)."""
    if not hasattr(p, "tp_full_shape"):
        return full
    rank, n = p.tp_rank_size
    return shard_of(full, p.split_axis, n, rank, p.tp_parts)


def _xavier_uniform(n_in, n_out):
    a = math.sqrt(6.0 / (n_in + n_out))
    return lambda t, g: t.uniform_(-a, a, generator=g)


# -- the layer-boundary collectives -----------------------------------------
class _CopyToMP(torch.autograd.Function):
    """Identity forward; the backward all-reduces the input gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromMP(torch.autograd.Function):
    """All-reduce forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromMP(torch.autograd.Function):
    """All-gather of the last dim forward; the backward keeps this rank's
    slice."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(None, x.contiguous(), group=group, axis=-1)

    @staticmethod
    def backward(ctx, g):
        n, rank = _size_rank(ctx.group)
        return g.chunk(n, -1)[rank].contiguous(), None


class _ScatterToMP(torch.autograd.Function):
    """This rank's slice of the last dim forward; all-gather backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n, rank = _size_rank(group)
        return x.chunk(n, -1)[rank].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(None, g.contiguous(), group=ctx.group,
                          axis=-1), None


def _parallel(group):
    return group is not None and group.nranks > 1


def _fp8_scale(x, split_over):
    """fp8's per-tensor scale of the whole activation (the reference's
    amax over the global array) when this rank holds a part of it: its
    amax MAX-reduced over the groups ``split_over`` (on the device, no
    host sync); None when the rank holds it whole."""
    groups = [g for g in split_over if g is not None and g.nranks > 1]
    if not groups:
        return None
    amax = x.detach().float().abs().amax()
    for g in groups:
        all_reduce(amax, op=ReduceOp.MAX, group=g)
    return torch.clamp_min(amax, 1e-12) / FP8_MAX


def _dp_group():
    from ..fleet import live_hcg
    hcg = live_hcg()
    return None if hcg is None else hcg.get_data_parallel_group()


def _linear(x, weight, bias, split_group=None):
    """F.linear, or the quantized product under ``matmul_quant`` with
    the bias added outside the kernel. ``split_group`` is the mp group
    when x is split over it (fp8 scales x by the amax of all its parts,
    and of every dp rank's rows)."""
    mq = get_matmul_quant()
    if mq is None:
        return F.linear(x, weight, bias)
    xs = _fp8_scale(x, (_dp_group(), split_group)) if mq == "fp8" else None
    if xs is None:
        out = quant_linear(x, weight, qdtype=mq)
    else:
        out = quantized_linear(x, weight, qdtype=mq, x_scale=xs)
    return out if bias is None else out + bias


class VocabParallelEmbedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        _not_ported("weight_attr", weight_attr)
        self._group = _mp_group(mp_group)
        self.world_size, self.rank = _size_rank(self._group)
        if num_embeddings % self.world_size:
            raise ValueError(f"vocab {num_embeddings} % mp "
                             f"{self.world_size} != 0")
        dev = resolve_device(device)
        self.num_embeddings = num_embeddings
        self.per_part = num_embeddings // self.world_size
        self.vocab_start = self.rank * self.per_part
        std = math.sqrt(2.0 / (num_embeddings + embedding_dim))
        self.weight = _sharded_param(
            (num_embeddings, embedding_dim), 0, self._group, 1,
            lambda t, g: t.normal_(0.0, std, generator=g), dev, dtype,
            generator if generator is not None else _seed(0, dev))

    def forward(self, x):
        if not _parallel(self._group):
            return F.embedding(x, self.weight)
        outside = (x < self.vocab_start) | \
            (x >= self.vocab_start + self.per_part)
        local = (x - self.vocab_start).masked_fill(outside, 0)
        out = F.embedding(local, self.weight)
        out = out.masked_fill(outside.unsqueeze(-1), 0.0)
        return _ReduceFromMP.apply(out, self._group)


class ColumnParallelLinear(nn.Module):
    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, device=None, dtype=None,
                 generator=None, _fused_parts=1):
        super().__init__()
        _not_ported("weight_attr", weight_attr)
        self._group = _mp_group(mp_group)
        self.world_size, self.rank = _size_rank(self._group)
        if out_features % (self.world_size * _fused_parts):
            raise ValueError(f"out_features {out_features} % mp "
                             f"{self.world_size} != 0")
        dev = resolve_device(device)
        gen = generator if generator is not None else _seed(0, dev)
        self.gather_output = gather_output
        self.weight = _sharded_param(
            (out_features, in_features), 0, self._group, _fused_parts,
            _xavier_uniform(in_features, out_features), dev, dtype, gen)
        self.bias = None
        if has_bias is None or has_bias:
            self.bias = _sharded_param(
                (out_features,), 0, self._group, _fused_parts,
                lambda t, g: t.zero_(), dev, dtype, gen)

    def forward(self, x):
        if not _parallel(self._group):
            return _linear(x, self.weight, self.bias)
        cm = overlapped_linear(
            x, self.weight, self._group,
            "column_gather" if self.gather_output else "column")
        if cm is not None:
            if self.bias is None:
                return cm
            return cm + (_GatherFromMP.apply(self.bias, self._group)
                         if self.gather_output else self.bias)
        out = _linear(_CopyToMP.apply(x, self._group), self.weight,
                      self.bias)
        if self.gather_output:
            return _GatherFromMP.apply(out, self._group)
        return out


class RowParallelLinear(nn.Module):
    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None, *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        _not_ported("weight_attr", weight_attr)
        self._group = _mp_group(mp_group)
        self.world_size, self.rank = _size_rank(self._group)
        if in_features % self.world_size:
            raise ValueError(f"in_features {in_features} % mp "
                             f"{self.world_size} != 0")
        dev = resolve_device(device)
        gen = generator if generator is not None else _seed(0, dev)
        self.input_is_parallel = input_is_parallel
        self.weight = _sharded_param(
            (out_features, in_features), 1, self._group, 1,
            _xavier_uniform(in_features, out_features), dev, dtype, gen)
        self.bias = None
        if has_bias:
            self.bias = nn.Parameter(torch.zeros(out_features, device=dev,
                                                 dtype=dtype))

    def forward(self, x):
        if not _parallel(self._group):
            return _linear(x, self.weight, self.bias)
        if not self.input_is_parallel:
            x = _ScatterToMP.apply(x, self._group)
        out = overlapped_linear(x, self.weight, self._group, "row")
        if out is None:
            out = _ReduceFromMP.apply(
                _linear(x, self.weight, None, self._group), self._group)
        return out if self.bias is None else out + self.bias


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, label, group, ignore_index):
        n, rank = _size_rank(group)
        per = logits.shape[-1]
        start = rank * per
        m = logits.detach().amax(-1, keepdim=True)
        all_reduce(m, op=ReduceOp.MAX, group=group)
        shifted = logits - m
        e = shifted.exp()
        s = e.sum(-1, keepdim=True)
        all_reduce(s, group=group)
        valid = label != ignore_index
        mine = valid & (label >= start) & (label < start + per)
        idx = torch.where(mine, label - start, torch.zeros_like(label))
        tgt = shifted.gather(-1, idx.unsqueeze(-1)).squeeze(-1)
        tgt = torch.where(mine, tgt, torch.zeros_like(tgt))
        all_reduce(tgt, group=group)
        loss = torch.where(valid, s.squeeze(-1).log() - tgt,
                           torch.zeros_like(tgt))
        ctx.save_for_backward(e.div_(s), idx, mine, valid)
        return loss.unsqueeze(-1)

    @staticmethod
    def backward(ctx, g):
        softmax, idx, mine, valid = ctx.saved_tensors
        grad = softmax.scatter_add(-1, idx.unsqueeze(-1),
                                   -mine.to(softmax.dtype).unsqueeze(-1))
        grad = grad * (g * valid.unsqueeze(-1).to(g.dtype))
        return grad, None, None, None


def parallel_logits(hidden, weight, group):
    """``hidden @ weight^T`` against a vocab-sharded weight [V / n, H]
    (a tied head on VocabParallelEmbedding's weight): this rank's logits
    [..., V / n]; the input's gradient is all-reduced over the group."""
    if _parallel(group):
        hidden = _CopyToMP.apply(hidden, group)
    return F.linear(hidden, weight)


class ParallelCrossEntropy(nn.Module):
    """Cross entropy over class-sharded logits [..., V / n] and labels
    [..., 1] (or [...]); returns the loss per position [..., 1]."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self._group = _mp_group(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):
        if label.dim() == input.dim():
            label = label.squeeze(-1)
        if not _parallel(self._group):
            return cross_entropy(input, label, reduction="none",
                                 ignore_index=self.ignore_index) \
                .unsqueeze(-1)
        return _VocabParallelCE.apply(input, label.long(), self._group,
                                      self.ignore_index)
