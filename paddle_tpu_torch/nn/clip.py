"""Gradient clipping (counterpart of paddle_tpu/nn/clip.py).

The three clip classes take a list of (parameter, gradient) pairs and
return a new one, as an optimizer's ``grad_clip`` is called inside
``step()`` before the update; a gradient of None, or of a parameter whose
``need_clip`` attribute is False, passes through. Norms are summed in
float32 and every scale stays a device tensor, so clipping never waits
for the device. A clipped gradient keeps its dtype: a bfloat16 one is
scaled in float32 and rounded back, as the JAX package promotes it.
``clip_grad_norm_`` and ``clip_grad_value_`` clip ``p.grad`` in place.

``ClipGradByGlobalNorm`` takes DTensor gradients (auto-parallel): the
global norm is the norm of the whole tensors. Each rank sums the squares
of its shards, and the sums of the gradients sharded over a mesh
dimension are summed over that dimension; a replicated dimension is not
summed. Each rank then scales its own shards.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

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
    the JAX package (there is one device). Parameters marked ``expert``
    (experts split over an expert group) raise: their norm needs
    ClipGradForMOEByGlobalNorm's sum over the group. ``sum_squares`` (the
    ZeRO optimizers pass it) sums the local squared norm over the ranks
    that hold the other slices of the gradients."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _dygraph_clip(self, params_grads, sum_squares=None):
        if any(getattr(p, "expert", False) for p, g in params_grads
               if _clipped(p, g)):
            raise NotImplementedError(
                "ClipGradByGlobalNorm over experts split across an expert "
                "group: this rank sees only its own experts' gradients; "
                "use ClipGradForMOEByGlobalNorm with the expert group")
        grads = [g for p, g in params_grads if _clipped(p, g)]
        if not grads:
            return params_grads
        locals_ = [g.to_local() if isinstance(g, DTensor) else g
                   for g in grads]
        # multi-tensor ops: a step clips every gradient of the model, and
        # one launch per gradient per op would hold the host back
        norms = torch._foreach_norm(locals_, 2, dtype=torch.float32)
        if sum_squares is not None:
            total = sum_squares(torch.stack(norms).square().sum()).sqrt()
        elif any(_split_dims(g) for g in grads):
            total = _dtensor_norm(grads, norms)
        else:
            total = torch.linalg.vector_norm(torch.stack(norms))
        scale = self.clip_norm / total.clamp(min=self.clip_norm)
        scaled = iter([_like(g, s) for g, s in
                       zip(grads, torch._foreach_mul(locals_, scale))])
        return [(p, next(scaled) if _clipped(p, g) else g)
                for p, g in params_grads]


def _split_dims(g):
    """The mesh dimensions of more than one rank a DTensor gradient is
    sharded over (none for a dense tensor)."""
    if not isinstance(g, DTensor):
        return ()
    mesh = g.device_mesh
    return tuple(i for i, p in enumerate(g.placements)
                 if p.is_shard() and mesh.size(i) > 1)


def _dtensor_norm(grads, norms):
    """The norm of the whole gradients from their shards' norms: the
    squares of the gradients sharded over the same mesh dimensions are
    summed, then over those dimensions."""
    groups = {}
    for g, n in zip(grads, norms):
        key = (g.device_mesh, _split_dims(g)) if isinstance(g, DTensor) \
            else (None, ())
        groups.setdefault(key, []).append(n)
    total = None
    for (mesh, dims), ns in groups.items():
        sq = torch.stack(ns).square().sum()
        if dims:
            sq = DTensor.from_local(
                sq, mesh, [Partial() if i in dims else Replicate()
                           for i in range(mesh.ndim)],
                run_check=False).full_tensor()
        total = sq if total is None else total + sq
    return total.sqrt()


def _like(g, local):
    """``local`` as a shard of a DTensor laid out as ``g`` (or itself)."""
    if not isinstance(g, DTensor):
        return local
    return DTensor.from_local(local, g.device_mesh, g.placements,
                              shape=g.shape, stride=g.stride(),
                              run_check=False)


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
