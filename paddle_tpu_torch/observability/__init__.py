"""Measurement helpers of the PyTorch port (counterpart of
paddle_tpu/observability)."""
from .hardware import model_flops_per_token

__all__ = ["model_flops_per_token"]
