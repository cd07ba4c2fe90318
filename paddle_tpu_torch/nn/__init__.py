"""Layers, functionals and gradient clipping."""
from . import functional
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .layer.common import Dropout
from .layer.loss import CrossEntropyLoss
from .layer.norm import LayerNorm, RMSNorm

__all__ = ["functional", "LayerNorm", "RMSNorm", "Dropout",
           "CrossEntropyLoss", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_", "clip_grad_value_"]
