"""Layers, functionals and gradient clipping."""
from . import functional
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .layer.activation import *  # noqa: F401,F403
from .layer.activation import __all__ as _activations
from .layer.common import Dropout
from .layer.container import LayerDict, LayerList, ParameterList, Sequential
from .layer.conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose,
                         Conv3D, Conv3DTranspose)
from .layer.loss import CrossEntropyLoss, MSELoss
from .layer.norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                         LayerNorm, RMSNorm, SyncBatchNorm)
from .layer.pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,
                            AdaptiveAvgPool3D, AdaptiveMaxPool1D,
                            AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
                            AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D,
                            MaxPool3D)

__all__ = ["functional", "LayerNorm", "RMSNorm", "Dropout",
           "CrossEntropyLoss", "MSELoss", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_", "clip_grad_value_",
           "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
           "Sequential", "LayerList", "LayerDict",
           "ParameterList"] + list(_activations)
