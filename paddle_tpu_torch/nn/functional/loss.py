"""Loss functionals (counterpart of paddle_tpu/nn/functional/loss.py).

``mse_loss``: the mean (or sum, or none) of the squared difference.

``cross_entropy`` with hard labels, as the JAX package computes it:
log-softmax over ``axis``, the label's log-probability picked out, an
optional label smoothing toward the mean log-probability, and
``ignore_index`` rows zeroed. ``mean`` divides by the number of valid
labels (at least 1). Class weights and soft labels are not ported.

DTensor inputs (auto-parallel) take dense labels: the labels hold the
whole batch on every rank and are split as the input's batch dims are;
a ``mean`` or ``sum`` comes back replicated on every mesh dimension, so
``float(loss)`` and its backward see the whole value.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.nn import functional as F

from ...framework.dtensor import lift, replicated

__all__ = ["cross_entropy", "mse_loss"]


def _reduce(out, reduction):
    if reduction == "mean":
        return replicated(out.mean())
    if reduction == "sum":
        return replicated(out.sum())
    if reduction == "none":
        return out
    raise ValueError(f"reduction must be 'none', 'sum' or 'mean', got "
                     f"{reduction!r}")


def mse_loss(input, label, reduction="mean", name=None):
    if isinstance(input, DTensor):
        label = lift(label, input, [p if p.is_shard() else Replicate()
                                    for p in input.placements])
    return _reduce((input - label).square(), reduction)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """paddle.nn.functional.cross_entropy for integer labels. A label of
    the logits' rank (a trailing 1 on ``axis``) is squeezed first."""
    if weight is not None:
        raise NotImplementedError("cross_entropy(weight=...) is not ported "
                                  "to the PyTorch package yet")
    if soft_label:
        raise NotImplementedError("cross_entropy(soft_label=True) is not "
                                  "ported to the PyTorch package yet")
    if reduction not in ("none", "sum", "mean"):
        raise ValueError(f"reduction must be 'none', 'sum' or 'mean', got "
                         f"{reduction!r}")
    axis = axis % input.dim()
    if use_softmax:
        logp = F.log_softmax(input, dim=axis)
    else:
        logp = torch.log(input.clamp(min=1e-12))
    lab = label
    if lab.dim() == logp.dim():
        lab = lab.squeeze(axis)
    if isinstance(input, DTensor) and not isinstance(lab, DTensor):
        lab = lift(lab, input, _label_placements(input.placements, axis))
    lab = lab.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    picked = -logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    if label_smoothing > 0.0:
        smooth = -logp.mean(dim=axis)
        picked = (1 - label_smoothing) * picked + label_smoothing * smooth
    picked = torch.where(valid, picked, torch.zeros_like(picked))
    if reduction == "mean":
        return replicated(picked.sum() / valid.sum().clamp(min=1))
    if reduction == "sum":
        return replicated(picked.sum())
    return picked


def _label_placements(placements, axis):
    """The labels' placements (the class axis dropped) of logits placed
    as ``placements``."""
    out = []
    for p in placements:
        if p.is_shard() and p.dim != axis:
            out.append(Shard(p.dim - (p.dim > axis)))
        else:
            out.append(Replicate())
    return out
