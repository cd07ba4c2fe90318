"""Dropout and the quantized linear (counterpart of the dropout and
``quant_linear`` in paddle_tpu/nn/functional/common.py).

The JAX package draws each mask with ``jax.random.bernoulli`` from a key
the framework hands it. torch's ``F.dropout`` takes no generator and
draws from torch's global RNG, so the port draws the keep mask itself
from an explicit ``torch.Generator`` (the trailing ``generator`` keyword)
and leaves the global RNG alone. The arithmetic is the JAX package's:
``upscale_in_train`` keeps x / (1 - p) where the mask is set and 0
elsewhere in training, and is the identity otherwise; ``downscale_in_infer``
keeps x (no rescale) in training and scales by 1 - p in inference.
``axis`` draws one mask entry per index of the listed axes and broadcasts
it over the others. A CPU and a CUDA generator seeded alike draw
different masks.
"""
from __future__ import annotations

import torch

__all__ = ["dropout", "quant_linear"]

_MODES = ("upscale_in_train", "downscale_in_infer")


# the generator of an active RNG tracker region, which every dropout draws
# from in place of its own (fleet.meta_parallel.random_ctrl.rng_state)
_REGION_GENERATOR = [None]


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, *, generator=None):
    """paddle.nn.functional.dropout with the mask drawn from ``generator``
    (a torch.Generator on x's device). A call that draws a mask (training
    with p > 0) raises ValueError without one."""
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"p must be in [0, 1], got {p}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if _REGION_GENERATOR[0] is not None:
        # inside an RNG tracker region (fleet.meta_parallel.random_ctrl)
        generator = _REGION_GENERATOR[0]
    if generator is None:
        raise ValueError(
            "dropout draws its mask from an explicit torch.Generator (the "
            "port never reads torch's global RNG); pass generator=")
    keep = 1.0 - p
    if axis is None:
        mshape = x.shape
    else:
        axes = [a % x.dim() for a in
                (axis if isinstance(axis, (list, tuple)) else (axis,))]
        mshape = [s if i in axes else 1 for i, s in enumerate(x.shape)]
    mask = torch.rand(mshape, generator=generator, device=x.device) < keep
    kept = x / keep if mode == "upscale_in_train" else x
    return torch.where(mask, kept, torch.zeros((), dtype=x.dtype,
                                               device=x.device))


def quant_linear(x, weight, qdtype="int8", name=None):
    """y = x @ weight^T with ``weight`` [out, in] (torch.nn.Linear's
    layout) quantized per block on each call and the product run by the
    quant_matmul kernel; the gradients are full precision (the
    straight-through estimator, kernels.quant_matmul.quantized_linear).
    Bias-free, as the reference's: the mp layers add their bias after."""
    from ...kernels.quant_matmul import quantized_linear
    return quantized_linear(x, weight, qdtype=str(qdtype))
