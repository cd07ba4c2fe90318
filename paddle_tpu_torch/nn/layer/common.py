"""Linear and Embedding with paddle's default initialisers, drawn from an
explicit generator (counterpart of the parameter creation in
paddle_tpu/nn/layer/common.py).

The modules are torch's own; only their initial values follow paddle:
a Linear weight XavierUniform and its bias 0, an Embedding weight
XavierNormal. torch keeps a Linear weight as [out, in] where paddle keeps
[in, out]; convert.py owns that transpose.
"""
from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["linear", "embedding"]


def linear(n_in, n_out, device, dtype, generator, bias=True):
    """nn.Linear(n_in, n_out) with weight ~ U(-a, a), a = sqrt(6 / (n_in +
    n_out)), and a zero bias."""
    lin = nn.utils.skip_init(nn.Linear, n_in, n_out, bias=bias,
                             device=device, dtype=dtype)
    a = math.sqrt(6.0 / (n_in + n_out))
    with torch.no_grad():
        lin.weight.uniform_(-a, a, generator=generator)
        if bias:
            lin.bias.zero_()
    return lin


def embedding(num, dim, device, dtype, generator):
    """nn.Embedding(num, dim) with weight ~ N(0, 2 / (num + dim))."""
    emb = nn.utils.skip_init(nn.Embedding, num, dim, device=device,
                             dtype=dtype)
    with torch.no_grad():
        emb.weight.normal_(0.0, math.sqrt(2.0 / (num + dim)),
                           generator=generator)
    return emb
