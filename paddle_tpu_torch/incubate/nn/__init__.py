"""Incubating layers' functionals (counterpart of paddle_tpu/incubate/nn;
only ``functional`` is ported)."""
from . import functional

__all__ = ["functional"]
