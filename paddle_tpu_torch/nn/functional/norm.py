"""Layer normalisation (counterpart of the layer_norm in
paddle_tpu/nn/functional/norm.py).

The JAX package normalises over the trailing ``normalized_shape`` axes with
jnp (XLA, no Pallas kernel); the port calls ``torch.nn.functional.
layer_norm``. In float32 the two agree to rounding. In bfloat16 they
differ: the JAX function takes the mean and variance in x's dtype, torch
in float32 (tests/test_torch_nn_layers.py holds the gap). A missing weight
acts as ones and a missing bias as zeros, as in the JAX package.
"""
from __future__ import annotations

from torch.nn import functional as F

__all__ = ["layer_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    return F.layer_norm(x, list(normalized_shape), weight, bias, epsilon)
