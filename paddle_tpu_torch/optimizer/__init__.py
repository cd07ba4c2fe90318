"""Optimizers of the PyTorch port (counterpart of paddle_tpu/optimizer)."""
from . import lr
from .optimizer import Optimizer
from .optimizers import SGD, Adam, AdamW, Momentum

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "lr"]
