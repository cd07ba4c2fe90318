"""``paddle.flops`` and ``paddle.summary`` (counterpart of
paddle_tpu/hapi/summary.py).

Both run the network once on zeros in eval mode with forward hooks on
every sublayer, on the device its parameters lie on, and restore its
training mode after. ``flops`` counts as the reference does: 2 · out ·
in for a Linear, 2 · out · (in / groups · prod(k)) for a convolution (its
weight's size per output channel), 5 · out for a batch norm or a
LayerNorm, ``custom_ops[type](layer, inputs, output)`` for a listed type,
and 0 for anything else; a layer called twice is counted once.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..nn.layer.conv import _ConvNd
from ..nn.layer.norm import LayerNorm, _BatchNormBase

__all__ = ["flops", "summary"]


def _sublayers(net):
    return [(name, m) for name, m in net.named_modules() if m is not net]


def _run_eval(net, inputs):
    was = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(*inputs)
    finally:
        net.train(was)


def _device(net):
    p = next(net.parameters(), None)
    return p.device if p is not None else torch.device("cpu")


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Forward flops of ``net`` on one float32 input of ``input_size``."""
    counts = {}

    def hook(layer, inputs, output):
        out = output[0] if isinstance(output, (tuple, list)) else output
        n_out = out.numel()
        fl = 0
        if isinstance(layer, nn.Linear):
            fl = 2 * n_out * layer.in_features
        elif isinstance(layer, _ConvNd):
            fl = 2 * n_out * math.prod(layer.weight.shape[1:])
        elif isinstance(layer, (_BatchNormBase, LayerNorm)):
            fl = 5 * n_out
        elif custom_ops and type(layer) in custom_ops:
            fl = custom_ops[type(layer)](layer, inputs, out)
        counts[id(layer)] = (type(layer).__name__, fl)

    handles = [m.register_forward_hook(hook) for _, m in _sublayers(net)]
    try:
        _run_eval(net, [torch.zeros(list(input_size), dtype=torch.float32,
                                    device=_device(net))])
    finally:
        for h in handles:
            h.remove()
    total = sum(fl for _, fl in counts.values())
    if print_detail:
        for name, fl in counts.values():
            print(f"  {name:<24} {fl:>14,}")
        print(f"Total FLOPs: {total:,}")
    return total


def summary(net, input_size=None, dtypes=None, input=None):
    """Print each sublayer's output shape and parameter count; return the
    total and trainable parameter counts."""
    rows = []

    def make_hook(name):
        def hook(layer, inputs, output):
            params = sum(p.numel() for p in layer.parameters(recurse=False))
            out = output[0] if isinstance(output, (list, tuple)) and output \
                else output
            shape = list(out.shape) if isinstance(out, torch.Tensor) \
                else None
            rows.append((name or type(layer).__name__, type(layer).__name__,
                         shape, params))
        return hook

    handles = [m.register_forward_hook(make_hook(name))
               for name, m in _sublayers(net)]
    if input is not None:
        x = list(input) if isinstance(input, (list, tuple)) else [input]
    else:
        sizes = input_size if isinstance(input_size, list) and \
            isinstance(input_size[0], (list, tuple)) else [input_size]
        dt = getattr(torch, dtypes or "float32")
        x = [torch.zeros(list(s), dtype=dt, device=_device(net))
             for s in sizes]
    try:
        _run_eval(net, x)
    finally:
        for h in handles:
            h.remove()
    total = sum(p.numel() for p in net.parameters())
    trainable = sum(p.numel() for p in net.parameters() if p.requires_grad)
    width = 72
    print("-" * width)
    print(f"{'Layer (type)':<34}{'Output Shape':<22}{'Param #':<12}")
    print("=" * width)
    for name, cls, shape, params in rows:
        print(f"{name + ' (' + cls + ')':<34}{str(shape):<22}{params:<12}")
    print("=" * width)
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    print(f"Non-trainable params: {total - trainable:,}")
    print("-" * width)
    return {"total_params": total, "trainable_params": trainable}
