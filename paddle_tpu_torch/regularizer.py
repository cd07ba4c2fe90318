"""Weight-decay regularizers (counterpart of paddle_tpu/regularizer.py).

An optimizer's ``weight_decay`` takes an ``L2Decay`` as its coefficient,
folded into the gradient as ``coeff * param``. The reference reads the
``coeff`` of any regularizer and folds it in the same way, so there an
``L1Decay(c)`` trains as ``L2Decay(c)``; the port's optimizers refuse an
``L1Decay`` (and the bare base class) instead of copying that. A
regularizer per parameter (ParamAttr's) is not ported.
"""
from __future__ import annotations

import torch

__all__ = ["L1Decay", "L2Decay", "WeightDecayRegularizer"]


class WeightDecayRegularizer:
    """Base class: ``coeff`` and the gradient term ``self(param)``."""

    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff

    def __call__(self, param):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self._coeff})"


class L1Decay(WeightDecayRegularizer):
    """loss += coeff * sum(|param|): gradient term coeff * sign(param)."""

    def __call__(self, param):
        return self._coeff * torch.sign(param)


class L2Decay(WeightDecayRegularizer):
    """loss += 0.5 * coeff * sum(param^2): gradient term coeff * param."""

    def __call__(self, param):
        return self._coeff * param
