"""MoE gates (counterpart of paddle_tpu/incubate/distributed/models/moe/
gate.py).

A gate maps token features [N, H] to (top-k probabilities [N, k], top-k
expert ids [N, k] int32) and leaves its auxiliary load-balance loss on
``.loss``. The random parts (Switch's logit jitter, GShard's random drop
of the second expert) draw from the gate's ``generator``, a
torch.Generator on its device (seeded 0 when none is given), where the
JAX gates draw from the package's global key. ``world_size`` multiplies
the experts: the gate scores ``world_size * num_expert`` of them.

Under expert parallelism each rank gates its own rows. The JAX package's
aux loss is one over the whole batch, ``E * sum_e mean(prob_e) *
mean(onehot_e)``, so a gate with a ``group`` (GShardGate's argument, or
the data world MoELayer gives it) averages the two [E] means over that
group before the product (a mean of per-rank products is another
number); the average is differentiable, its backward the same average
of the gradients. It is taken only in training with gradients enabled:
an eval or no_grad forward (evaluation or generation on some of the
ranks) gives this rank's own aux loss and calls no collective. For the
same reason a gate with a group draws its random numbers for the whole
batch (group rank r's rows are block r of it) and keeps its rows: the
ranks together draw what one process draws, whatever the split. That
costs each rank ``group.nranks`` times its own draw (Switch: [nranks *
N, E] uniforms; GShard: [nranks * N]), less than the gate's own N x H x
E product while nranks < H. The routing telemetry is not ported.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from .....framework.device import resolve_device, seed
from .....nn.layer.common import linear

__all__ = ["BaseGate", "NaiveGate", "SwitchGate", "GShardGate"]


class BaseGate(nn.Module):
    def __init__(self, num_expert, world_size=1):
        super().__init__()
        self.world_size = world_size
        # the group whose rows the aux loss averages over (None: this
        # rank's rows only)
        self.group = None
        self.num_expert = num_expert
        self.tot_expert = world_size * num_expert
        self.loss = None

    def set_loss(self, loss):
        self.loss = loss

    def _loss_group(self):
        """The group the aux loss averages over: ``group`` in training
        with gradients enabled, else None (this rank's rows)."""
        if self.training and torch.is_grad_enabled():
            return self.group
        return None

    def get_loss(self, clear=True):
        loss = self.loss
        if clear:
            self.loss = None
        return loss


def _topk(scores, k):
    vals, idx = torch.topk(scores, k, dim=-1)
    return vals, idx.to(torch.int32)


def _balance_loss(gate_prob, top1, num_expert, group=None):
    """num_expert * sum(mean routed fraction * mean probability), the two
    means over ``group``'s rows (every rank passes as many rows)."""
    me = gate_prob.mean(0)
    ce = F.one_hot(top1.long(), num_expert).float().mean(0)
    if group is not None and group.nranks > 1:
        from .dispatch import group_mean
        me = group_mean(me, group)
        ce = group_mean(ce.detach(), group)
    return (me * ce).sum() * num_expert


class NaiveGate(BaseGate):
    """Top-k softmax gate."""

    def __init__(self, d_model, num_expert, world_size=1, topk=2,
                 device=None, dtype=None, generator=None):
        super().__init__(num_expert, world_size)
        dev = resolve_device(device)
        self.generator = seed(0, dev) if generator is None else generator
        self.gate = linear(d_model, self.tot_expert, dev, dtype,
                           self.generator)
        self.top_k = topk

    def _uniform(self, shape, like):
        """Uniforms in [0, 1) of ``like``'s dtype from the gate's
        generator."""
        return torch.rand(shape, generator=self.generator,
                          device=like.device, dtype=like.dtype)

    def _uniform_rows(self, shape, like):
        """``_uniform`` for this rank's rows (dim 0) of the group's whole
        batch: the group's draw, cut to block ``group.rank``."""
        g = self.group
        if g is None or g.nranks == 1:
            return self._uniform(shape, like)
        n = shape[0]
        every = self._uniform((g.nranks * n,) + tuple(shape[1:]), like)
        return every[g.rank * n:(g.rank + 1) * n]

    def forward(self, inp, return_all_scores=False):
        gate_logits = self.gate(inp)
        gate_prob = F.softmax(gate_logits, dim=-1)
        val, idx = _topk(gate_prob, self.top_k)
        if return_all_scores:
            return val, idx, gate_logits
        return val, idx


class SwitchGate(NaiveGate):
    """Top-1 gate with the Switch load-balance loss; in training the
    logits are jittered by uniform noise in [1 - eps, 1 + eps]."""

    def __init__(self, d_model, num_expert, world_size=1, topk=1,
                 switch_eps=0.1, capacity=None, device=None, dtype=None,
                 generator=None):
        if topk != 1:
            raise ValueError("SwitchGate expects topk=1")
        super().__init__(d_model, num_expert, world_size, topk=1,
                         device=device, dtype=dtype, generator=generator)
        self.switch_eps = switch_eps

    def forward(self, inp):
        gate_logits = self.gate(inp)
        if self.training:
            noise = self._uniform_rows(gate_logits.shape, gate_logits) \
                * (2 * self.switch_eps) + (1.0 - self.switch_eps)
            gate_logits = gate_logits * noise
        gate_prob = F.softmax(gate_logits, dim=-1)
        val, idx = _topk(gate_prob, 1)
        self.set_loss(_balance_loss(gate_prob, idx[:, 0], self.tot_expert,
                                    self._loss_group()))
        return val, idx


class GShardGate(NaiveGate):
    """Top-2 gate with the GShard loss; in training with random_routing
    the second route of a token is kept when 2 p2 > r, r uniform."""

    def __init__(self, d_model, num_expert, world_size=1, topk=2,
                 random_routing=True, group=None, device=None, dtype=None,
                 generator=None):
        if topk != 2:
            raise ValueError("GShardGate expects topk=2")
        super().__init__(d_model, num_expert, world_size, topk=2,
                         device=device, dtype=dtype, generator=generator)
        self.random_routing = random_routing
        self.group = group

    def forward(self, x):
        val, idx, gate_logits = super().forward(x, return_all_scores=True)
        gate_prob = F.softmax(gate_logits, dim=-1)
        self.set_loss(_balance_loss(gate_prob, idx[:, 0], self.tot_expert,
                                    self._loss_group()))
        if self.random_routing and self.training:
            r = self._uniform_rows(val[:, 1].shape, val)
            keep = (val[:, 1] * 2.0 > r).to(val.dtype)
            val = torch.stack([val[:, 0], val[:, 1] * keep], dim=1)
        return val, idx
