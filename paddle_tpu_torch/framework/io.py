"""paddle.save / paddle.load (counterpart of paddle_tpu/framework/io.py).

The same pickle payload as the JAX package's: a tensor is saved as a
numpy array with its dtype name, whether it is a parameter, its name and
its stop_gradient flag; nested dicts, lists and tuples (state dicts,
optimizer states) round-trip by structure. ``load`` gives CPU tensors
(``nn.Parameter`` for a saved parameter), or the arrays with
``return_numpy``. A bfloat16 tensor is saved widened to float32 (numpy has
no bfloat16) and narrowed back on load.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch
from torch import nn

__all__ = ["save", "load"]

_PROTOCOL = 4


class _TensorPayload:
    """A saved tensor: load() tells it from a plain ndarray."""

    def __init__(self, array, dtype_name, is_param, name, stop_gradient):
        self.array = array
        self.dtype_name = dtype_name
        self.is_param = is_param
        self.name = name
        self.stop_gradient = stop_gradient


def _pack(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        name = str(t.dtype).replace("torch.", "")
        arr = (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()
        return _TensorPayload(arr, name, isinstance(obj, nn.Parameter),
                              getattr(obj, "param_name", None),
                              not obj.requires_grad)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _unpack(obj, return_numpy=False):
    if isinstance(obj, _TensorPayload):
        if return_numpy:
            return obj.array
        t = torch.from_numpy(np.array(obj.array, copy=True)).to(
            getattr(torch, obj.dtype_name))
        if obj.is_param:
            t = nn.Parameter(t, requires_grad=not obj.stop_gradient)
            if obj.name:
                t.param_name = obj.name
        return t
    if isinstance(obj, dict):
        return {k: _unpack(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, return_numpy) for v in obj)
    return obj


def save(obj, path, protocol=_PROTOCOL, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_pack(obj), f, protocol=protocol)


def load(path, return_numpy=False, **configs):
    with open(path, "rb") as f:
        obj = pickle.load(f)
    return _unpack(obj, return_numpy=return_numpy)
