"""The expert activations (counterpart of the `_ACTS` table in
paddle_tpu/incubate/distributed/models/moe/dispatch.py). gelu is the
exact erf form, as paddle's default. The expert-parallel all-to-all
exchange of that module is not ported."""
from __future__ import annotations

import functools

import torch
from torch.nn import functional as F

__all__ = ["_ACTS"]

_ACTS = {
    "gelu": functools.partial(F.gelu, approximate="none"),
    "relu": F.relu,
    "silu": F.silu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
}
