"""Activations (counterpart of paddle_tpu/nn/functional/activation.py).

``gelu`` is ``jax.nn.gelu`` in the JAX package, an XLA element-wise op with
no Pallas kernel, so here it is torch's own: the exact erf form, or with
``approximate=True`` the tanh form 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715
x^3))), which ``jax.nn.gelu(approximate=True)`` computes too.
"""
from __future__ import annotations

from torch.nn import functional as F

__all__ = ["gelu"]


def gelu(x, approximate=False, name=None):
    return F.gelu(x, approximate="tanh" if approximate else "none")
