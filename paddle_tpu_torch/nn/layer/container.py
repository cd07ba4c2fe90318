"""Containers (counterpart of paddle_tpu/nn/layer/container.py), on
torch's own: ``Sequential`` also takes the reference's single list of
(name, layer) pairs; ``LayerList``, ``LayerDict`` and ``ParameterList``
take their contents under the reference's argument names."""
from __future__ import annotations

from collections import OrderedDict

from torch import nn

__all__ = ["Sequential", "LayerList", "LayerDict", "ParameterList"]


class Sequential(nn.Sequential):
    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                len(layers[0]) > 0 and isinstance(layers[0][0], tuple):
            super().__init__(OrderedDict(layers[0]))
        else:
            super().__init__(*layers)


class LayerList(nn.ModuleList):
    def __init__(self, sublayers=None):
        super().__init__(sublayers)


class LayerDict(nn.ModuleDict):
    def __init__(self, sublayers=None):
        super().__init__(sublayers)


class ParameterList(nn.ParameterList):
    def __init__(self, parameters=None):
        super().__init__(parameters)
