"""Gradient clipping (counterpart of paddle_tpu/nn/clip.py).

The three clip classes take a list of (parameter, gradient) pairs and
return a new one, as an optimizer's ``grad_clip`` is called inside
``step()`` before the update; a gradient of None, or of a parameter whose
``need_clip`` attribute is False, passes through. Norms are summed in
float32 and every scale stays a device tensor, so clipping never waits
for the device. A clipped gradient keeps its dtype: a bfloat16 one is
scaled in float32 and rounded back, as the JAX package promotes it.
``clip_grad_norm_`` and ``clip_grad_value_`` clip ``p.grad`` in place.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_", "clip_grad_value_"]


def _clipped(p, g):
    return g is not None and getattr(p, "need_clip", True)


def _scaled(g, scale):
    return (g.float() * scale).to(g.dtype)


def _sq_norm(g):
    return g.float().square().sum()


class ClipGradBase:
    def __call__(self, params_grads):
        return self._dygraph_clip(params_grads)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _dygraph_clip(self, params_grads):
        return [(p, g.clamp(self.min, self.max) if _clipped(p, g) else g)
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient on its own: g * min(clip_norm / max(||g||, 1e-12), 1)."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _dygraph_clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if _clipped(p, g):
                norm = _sq_norm(g).sqrt()
                scale = (self.clip_norm / norm.clamp(min=1e-12)).clamp(
                    max=1.0)
                g = _scaled(g, scale)
            out.append((p, g))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """All gradients together: g * clip_norm / max(||all||, clip_norm).
    ``group_name`` and ``auto_skip_clip`` are accepted and unused, as in
    the JAX package (there is one device)."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _dygraph_clip(self, params_grads):
        grads = [g for p, g in params_grads if _clipped(p, g)]
        if not grads:
            return params_grads
        # multi-tensor ops: a step clips every gradient of the model, and
        # one launch per gradient per op would hold the host back
        norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
        total = torch.linalg.vector_norm(torch.stack(norms))
        scale = self.clip_norm / total.clamp(min=self.clip_norm)
        scaled = iter(torch._foreach_mul(grads, scale))
        return [(p, next(scaled) if _clipped(p, g) else g)
                for p, g in params_grads]


def _grads_of(parameters):
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    return [p for p in parameters if p.grad is not None]


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every ``p.grad`` in place by min(max_norm / (total + 1e-6), 1),
    total the norm of all gradients together (float32; the largest
    magnitude for ``norm_type=inf``). Returns total as a float32 device
    tensor. ``error_if_nonfinite`` is accepted and unused, as in the JAX
    package (checking it would wait for the device)."""
    params = _grads_of(parameters)
    if not params:
        return torch.zeros(())
    grads = [p.grad for p in params]
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max().float() for g in grads]).max()
    else:
        total = torch.stack([g.float().abs().pow(norm_type).sum()
                             for g in grads]).sum().pow(1.0 / norm_type)
    coef = (max_norm / (total + 1e-6)).clamp(max=1.0)
    for p in params:
        p.grad = _scaled(p.grad, coef)
    return total


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    """Clamp every ``p.grad`` to [-clip_value, clip_value] in place."""
    for p in _grads_of(parameters):
        p.grad.clamp_(-clip_value, clip_value)
