"""Optimizers of the PyTorch port (counterpart of paddle_tpu/optimizer)."""
from . import lr
from .optimizer import Optimizer
from .optimizers import Adam, AdamW

__all__ = ["Optimizer", "Adam", "AdamW", "lr"]
