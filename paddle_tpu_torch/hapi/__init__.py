"""High-level helpers (counterpart of paddle_tpu/hapi): ``flops`` and
``summary``."""
from .summary import flops, summary

__all__ = ["flops", "summary"]
