"""MoE-aware global-norm gradient clipping (counterpart of
paddle_tpu/incubate/distributed/models/moe/grad_clip.py).

The global norm counts every gradient once. A dense parameter's gradient
is the same on every rank, but under expert parallelism each rank of the
expert group holds other experts, so the expert gradients' squared norm
is summed over ``moe_group`` before it joins the dense one; which
parameters are experts ``is_expert_param_func(param)`` says, as in the
reference (without it every parameter counts as dense, so a ``moe_group``
of more than one rank needs it). The scale is the JAX package's,
min(clip_norm / (norm + 1e-6), 1), in float32 on the device. The JAX
package holds every expert on one controller, so it ignores
``moe_group`` and ``is_expert_param_func``. ``sum_squares`` (the ZeRO
optimizers pass it) sums both squared norms over the ranks that hold the
other slices of the gradients.
"""
from __future__ import annotations

import torch

from .....nn.clip import ClipGradBase, _clipped, _scaled

__all__ = ["ClipGradForMOEByGlobalNorm"]


def _sq_sum(grads, like):
    if not grads:
        return torch.zeros((), dtype=torch.float32, device=like.device)
    norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
    return torch.stack(norms).square().sum()


class ClipGradForMOEByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, is_expert_param_func=None,
                 moe_group=None, group_name="default_moe_group"):
        if moe_group is not None and moe_group.nranks > 1 and \
                is_expert_param_func is None:
            raise ValueError("ClipGradForMOEByGlobalNorm with a moe_group of "
                             "more than one rank needs is_expert_param_func")
        self.clip_norm = float(clip_norm)
        self.is_expert_param_func = is_expert_param_func
        self.moe_group = moe_group
        self.group_name = group_name

    def _is_expert(self, p):
        return self.is_expert_param_func is not None and \
            bool(self.is_expert_param_func(p))

    def _dygraph_clip(self, params_grads, sum_squares=None):
        live = [(p, g) for p, g in params_grads if _clipped(p, g)]
        if not live:
            return params_grads
        dense = [g for p, g in live if not self._is_expert(p)]
        expert = [g for p, g in live if self._is_expert(p)]
        sq = torch.stack([_sq_sum(dense, live[0][1]),
                          _sq_sum(expert, live[0][1])])
        if sum_squares is not None:
            sq = sum_squares(sq)
        g = self.moe_group
        if g is not None and g.nranks > 1:
            from .....distributed.collective import _ar
            import torch.distributed as tdist
            _ar(sq[1:], tdist.ReduceOp.SUM, g)
        norm = sq.sum().sqrt()
        coef = (self.clip_norm / (norm + 1e-6)).clamp(max=1.0)
        return [(p, _scaled(g, coef) if _clipped(p, g) else g)
                for p, g in params_grads]
