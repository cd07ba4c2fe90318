"""Layers and functionals."""
from . import functional

__all__ = ["functional"]
