"""Loss functionals (counterpart of paddle_tpu/nn/functional/loss.py).

``cross_entropy`` with hard labels, as the JAX package computes it:
log-softmax over ``axis``, the label's log-probability picked out, an
optional label smoothing toward the mean log-probability, and
``ignore_index`` rows zeroed. ``mean`` divides by the number of valid
labels (at least 1). Class weights and soft labels are not ported.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

__all__ = ["cross_entropy"]


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
    lab = lab.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    picked = -logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    if label_smoothing > 0.0:
        smooth = -logp.mean(dim=axis)
        picked = (1 - label_smoothing) * picked + label_smoothing * smooth
    picked = torch.where(valid, picked, torch.zeros_like(picked))
    if reduction == "mean":
        return picked.sum() / valid.sum().clamp(min=1)
    if reduction == "sum":
        return picked.sum()
    return picked
