"""Activations (counterpart of paddle_tpu/nn/functional/activation.py).

``gelu`` is ``jax.nn.gelu`` and ``relu`` ``jnp.maximum(x, 0)`` in the JAX
package, XLA element-wise ops with no Pallas kernel, so here they are
torch's own. gelu: the exact erf form, or with ``approximate=True`` the
tanh form 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))), which
``jax.nn.gelu(approximate=True)`` computes too. relu's gradient at
exactly 0 is torch's 0 where JAX's maximum splits the tie (0.5).
"""
from __future__ import annotations

from torch.nn import functional as F

__all__ = ["gelu", "relu"]


def gelu(x, approximate=False, name=None):
    return F.gelu(x, approximate="tanh" if approximate else "none")


def relu(x, name=None):
    return F.relu(x)
