"""Loss layers (counterpart of paddle_tpu/nn/layer/loss.py): the
CrossEntropyLoss layer over the port's ``cross_entropy``, which raises on
the options it has not ported (class weights, soft labels), and MSELoss
over ``mse_loss``."""
from __future__ import annotations

from torch import nn

from ..functional.loss import cross_entropy, mse_loss

__all__ = ["CrossEntropyLoss", "MSELoss"]


class MSELoss(nn.Module):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return mse_loss(input, label, self.reduction)


class CrossEntropyLoss(nn.Module):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return cross_entropy(input, label, weight=self.weight,
                             ignore_index=self.ignore_index,
                             reduction=self.reduction,
                             soft_label=self.soft_label, axis=self.axis,
                             use_softmax=self.use_softmax,
                             label_smoothing=self.label_smoothing)
