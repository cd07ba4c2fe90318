"""Layer and batch normalisation (counterparts of the layer_norm and
batch_norm in paddle_tpu/nn/functional/norm.py).

The JAX package normalises with jnp (XLA, no Pallas kernel); the port
calls ``torch.nn.functional.layer_norm`` and ``batch_norm`` (cuDNN on the
card). In float32 the two agree to rounding. In bfloat16 layer_norm
differs: the JAX function takes the mean and variance in x's dtype, torch
in float32 (tests/test_torch_nn_layers.py holds the gap). A missing
weight acts as ones and a missing bias as zeros, as in the JAX package.

``batch_norm`` keeps the reference's running-statistics convention, which
is not torch's: in training, ``running = momentum * running + (1 -
momentum) * batch`` with the biased batch variance (``jnp.var``), where
torch weights the other way round and stores the unbiased variance. So
torch's kernel is handed scratch buffers at momentum 1, which it fills
with the batch mean and unbiased variance, and the running buffers are
updated here from those, the variance scaled back by (n - 1) / n. Eval
mode and ``use_global_stats`` normalise with the running buffers and
leave them alone. The channel axis is 1, or the last for a channels-last
``data_format`` of rank above 2; a 2-D input normalises axis 1.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

__all__ = ["layer_norm", "batch_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    return F.layer_norm(x, list(normalized_shape), weight, bias, epsilon)


def batch_norm(x, running_mean, running_var, weight, bias, training=False,
               momentum=0.9, epsilon=1e-05, data_format="NCHW",
               use_global_stats=None, name=None):
    axis = x.dim() - 1 if data_format[-1] == "C" and len(data_format) > 2 \
        else 1
    if x.dim() == 2:
        axis = 1
    xc = x.movedim(axis, 1) if axis != 1 else x
    if not (training and not use_global_stats):
        out = F.batch_norm(xc, running_mean, running_var, weight, bias,
                           training=False, eps=epsilon)
    else:
        # zeros: momentum 1 still adds 0 x the buffer's old value
        batch_mean = torch.zeros_like(running_mean)
        batch_var = torch.zeros_like(running_var)
        out = F.batch_norm(xc, batch_mean, batch_var, weight, bias,
                           training=True, momentum=1.0, eps=epsilon)
        n = xc.numel() // xc.shape[1]
        with torch.no_grad():
            running_mean.mul_(momentum).add_(batch_mean, alpha=1 - momentum)
            # (torch's backward keeps the scratch buffers: not in place)
            running_var.mul_(momentum).add_(batch_var * ((n - 1) / n),
                                            alpha=1 - momentum)
    return out.movedim(1, axis) if axis != 1 else out
