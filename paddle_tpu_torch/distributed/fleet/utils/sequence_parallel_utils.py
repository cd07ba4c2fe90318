"""Megatron-style sequence parallelism (counterpart of
paddle_tpu/distributed/fleet/utils/sequence_parallel_utils.py).

Activations are [B, S, H] and the sequence is dim 1. Between the
tensor-parallel blocks each rank of the mp group holds S/n positions;
the collectives the reference lets GSPMD insert are explicit here:

- ScatterOp: this rank's S/n positions forward, all-gather backward;
- GatherOp: all-gather forward, this rank's positions backward;
- AllGatherOp: all-gather forward, reduce-scatter backward;
- ReduceScatterOp: reduce-scatter forward, all-gather backward.

ColumnSequenceParallelLinear all-gathers its sequence-sharded input and
multiplies by its column shard (output [B, S, O/n]);
RowSequenceParallelLinear multiplies its feature-sharded input by its row
shard and reduce-scatters the sum over the sequence (output [B, S/n, O]).
Under ``mp_overlap`` both run the collective-matmul rings instead
(``column_sp`` and ``row_sp``). Their weights are drawn and sliced as the
Column/RowParallelLinear ones are, so the parameters are the same; like
the reference's, they do not quantize under ``matmul_quant``.

A parameter outside the split projections (a norm's weight, the row
layer's bias, added on S/n positions) sees only its rank's positions, so
its gradient is a part of the whole one.
``register_sequence_parallel_allreduce_hooks`` sums the gradients of the
parameters marked by ``mark_as_sequence_parallel_parameter`` over the mp
group as backward produces them (the reference registers nothing: GSPMD
makes those gradients whole). RowSequenceParallelLinear marks and hooks
its own bias. A parameter is hooked once, however often the hooks are
registered.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from ...collective import Group, all_gather, all_reduce, reduce_scatter
from ..meta_parallel.collective_matmul import overlapped_linear
from ..meta_parallel.mp_layers import (ColumnParallelLinear,
                                       RowParallelLinear, _mp_group,
                                       _parallel, _size_rank)

__all__ = [
    "ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp",
    "ColumnSequenceParallelLinear", "RowSequenceParallelLinear",
    "mark_as_sequence_parallel_parameter",
    "register_sequence_parallel_allreduce_hooks",
]

_SEQ_DIM = 1


def _group(axis):
    """The group a sequence op runs over: a Group given as ``axis``, else
    fleet's mp group (none at one rank)."""
    return axis if isinstance(axis, Group) else _mp_group(None)


def _split(x, group, dim):
    n, rank = _size_rank(group)
    return x.chunk(n, dim)[rank].contiguous()


def _gather(x, group, dim):
    return all_gather(None, x.contiguous(), group=group, axis=dim)


def _reduce_scatter(x, group, dim):
    n, _ = _size_rank(group)
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    reduce_scatter(out, src, group=group)
    return out.movedim(0, dim)


class _SeqOp(torch.autograd.Function):
    """One of the four ops: ``fwd`` and ``bwd`` name the collective
    each way ("split", "gather" or "reduce_scatter")."""

    _DO = {"split": _split, "gather": _gather,
           "reduce_scatter": _reduce_scatter}

    @staticmethod
    def forward(ctx, x, group, dim, fwd, bwd):
        ctx.cfg = (group, dim, bwd)
        return _SeqOp._DO[fwd](x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim, bwd = ctx.cfg
        return _SeqOp._DO[bwd](g, group, dim), None, None, None, None


def _seq_op(fwd, bwd):
    class Op:
        @staticmethod
        def apply(x, axis="mp", seq_dim=_SEQ_DIM):
            group = _group(axis)
            if not _parallel(group):
                return x
            return _SeqOp.apply(x, group, seq_dim, fwd, bwd)
    return Op


class ScatterOp(_seq_op("split", "gather")):
    """This rank's part of the sequence (forward) / all-gather
    (backward)."""


class GatherOp(_seq_op("gather", "split")):
    """All-gather of the sequence (forward) / this rank's part
    (backward)."""


class AllGatherOp(_seq_op("gather", "reduce_scatter")):
    """All-gather of the sequence (forward) / reduce-scatter
    (backward)."""


class ReduceScatterOp(_seq_op("reduce_scatter", "gather")):
    """Reduce-scatter over the sequence (forward) / all-gather
    (backward)."""


class ColumnSequenceParallelLinear(ColumnParallelLinear):
    """x [B, S/n, in] sequence-sharded -> [B, S, out/n]."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=False, fuse_matmul_bias=False,
                 mp_group=None, name=None, **kw):
        if gather_output:
            raise ValueError("ColumnSequenceParallelLinear keeps its "
                             "output split (gather_output=False)")
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         False, fuse_matmul_bias, mp_group, name, **kw)

    def forward(self, x):
        if not _parallel(self._group):
            return F.linear(x, self.weight, self.bias)
        cm = overlapped_linear(x, self.weight, self._group, "column_sp")
        if cm is not None:
            return cm if self.bias is None else cm + self.bias
        return F.linear(AllGatherOp.apply(x, self._group), self.weight,
                        self.bias)


class RowSequenceParallelLinear(RowParallelLinear):
    """x [B, S, in/n] feature-sharded -> [B, S/n, out], the sum over the
    mp group reduce-scattered over the sequence; the bias (whole on every
    rank) is added after."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True,
                 fuse_matmul_bias=False, mp_group=None, name=None, **kw):
        if not input_is_parallel:
            raise ValueError("RowSequenceParallelLinear takes its input "
                             "split (input_is_parallel=True)")
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         True, fuse_matmul_bias, mp_group, name, **kw)
        if self.bias is not None:
            mark_as_sequence_parallel_parameter(self.bias)
            _sum_grad_over(self.bias, self._group)

    def forward(self, x):
        if not _parallel(self._group):
            return F.linear(x, self.weight, self.bias)
        out = overlapped_linear(x, self.weight, self._group, "row_sp")
        if out is None:
            out = ReduceScatterOp.apply(F.linear(x, self.weight),
                                        self._group)
        return out if self.bias is None else out + self.bias


def mark_as_sequence_parallel_parameter(parameter):
    parameter.sequence_parallel = True


def register_sequence_parallel_allreduce_hooks(
        model, accumulation_steps=1, fuse_sequence_parallel_allreduce=False):
    """Sum the gradient of every parameter of ``model`` marked
    sequence_parallel over the mp group, each backward's part as backward
    produces it (a sum, so accumulation over steps needs nothing more).
    Returns None, as the reference."""
    group = _mp_group(None)
    for p in model.parameters():
        if getattr(p, "sequence_parallel", False):
            _sum_grad_over(p, group)
    return None


def _sum_grad_over(p, group):
    """Hook ``p`` (once) so that each gradient backward makes for it is
    summed over ``group``."""
    if not _parallel(group) or getattr(p, "_sp_allreduce_hooked", False):
        return

    def hook(g):
        g = g.contiguous().clone()
        all_reduce(g, group=group)
        return g
    p.register_hook(hook)
    p._sp_allreduce_hooked = True
