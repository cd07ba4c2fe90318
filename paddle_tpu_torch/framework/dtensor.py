"""The DTensor seams of the port (auto-parallel, distributed/auto_parallel/).

After ``shard_layer`` a model's parameters are ``torch.distributed.tensor``
DTensors, and a plain tensor that meets one raises in torch, in the
forward and in the backward. The models, the loss, the optimizer, the
gradient clip and TrainStep meet DTensors through these helpers:

- ``lift(x, like)`` makes a plain tensor that holds the same global value
  on every rank (ids, labels, RoPE tables) a DTensor on ``like``'s mesh:
  replicated, or split as ``placements`` say (each rank keeps its slice;
  nothing is sent);
- ``replicated(t)`` redistributes a DTensor to Replicate on every mesh
  dimension (a loss, so that ``float(loss)`` and its backward see the
  whole value);
- ``reduced(t)`` settles a DTensor's pending Partial sums (Replicate in
  their place, shards kept): Megatron's all-reduce at a row-parallel
  projection's output, which ``shard_layer`` hooks on, so the residual
  stream stays replicated;
- ``grad_reduced(t)`` is the identity whose backward reduces the
  gradient's Partial placements: Megatron's all-reduce of a column
  projection's input gradient (``shard_layer``'s other hook), so the
  weights' gradients come out as their shards (torch would otherwise
  gather the activation and compute a partial whole gradient on every
  rank);
- ``as_param_placements(g, p)`` redistributes a gradient to its
  parameter's placements (a Partial sum over the data axis becomes the
  all-reduced gradient; a gradient that already matches is returned as
  it is);
- ``register_holder`` / ``replace_parameter``: Paddle's ``shard_tensor``
  shards a parameter in place, and torch cannot turn a tensor into a
  DTensor in place, so the new DTensor parameter replaces the old one in
  every live holder (an optimizer, a TrainStep) registered here.
"""
from __future__ import annotations

import weakref

import torch
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

__all__ = ["lift", "replicated", "reduced", "grad_reduced",
           "as_param_placements", "register_holder", "replace_parameter",
           "swapped", "moved_accumulators"]

_HOLDERS = weakref.WeakSet()


def lift(x, like, placements=None):
    """``x`` as a DTensor on the mesh of the DTensor ``like``: x itself
    when it is a DTensor or ``like`` is not one; else the global value x
    holds on every rank, Replicate on each mesh dimension unless
    ``placements`` (torch placements) say otherwise."""
    if isinstance(x, DTensor) or not isinstance(like, DTensor):
        return x
    mesh = like.device_mesh
    if placements is None or all(p.is_replicate() for p in placements):
        return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    return distribute_tensor(x, mesh, placements, src_data_rank=None)


def replicated(t):
    """A DTensor redistributed to Replicate on every mesh dimension
    (differentiable); any other tensor as it is."""
    if not isinstance(t, DTensor) or all(p.is_replicate()
                                         for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def reduced(t):
    """A DTensor with each Partial placement reduced to Replicate (the
    shards kept; differentiable); any other tensor as it is."""
    if not isinstance(t, DTensor) or not any(p.is_partial()
                                             for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in t.placements])


class _GradReduced(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return reduced(g)


def grad_reduced(t):
    """``t`` (a DTensor), whose gradient has its Partial placements
    reduced to Replicate; any other tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    return _GradReduced.apply(t)


def as_param_placements(g, p):
    """Gradient ``g`` laid out as parameter ``p`` (both DTensors), or g."""
    if not isinstance(g, DTensor) or not isinstance(p, DTensor) or \
            tuple(g.placements) == tuple(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def register_holder(obj):
    """Keep ``obj`` (weakly) among the holders whose parameters
    ``replace_parameter`` swaps; obj has ``_replace_parameter(old, new)``."""
    _HOLDERS.add(obj)


def replace_parameter(old, new):
    """Swap parameter ``old`` for ``new`` in every live holder."""
    for h in list(_HOLDERS):
        h._replace_parameter(old, new)


def swapped(seq, old, new):
    """``seq`` as a list with ``old`` replaced by ``new``."""
    return [new if x is old else x for x in seq]


def moved_accumulators(accs, old, new):
    """An optimizer's {(name, id(param)): state} with ``old``'s states
    re-keyed to ``new`` and laid out as it (each rank keeps its slice)."""
    out = {}
    for (name, pid), v in accs.items():
        if pid == id(old):
            if isinstance(new, DTensor) and not isinstance(v, DTensor):
                v = distribute_tensor(v, new.device_mesh, new.placements,
                                      src_data_rank=None)
            out[(name, id(new))] = v
        else:
            out[(name, pid)] = v
    return out
