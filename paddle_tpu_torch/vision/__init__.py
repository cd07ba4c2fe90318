"""Vision models (counterpart of paddle_tpu/vision): the ResNet family."""
from . import models

__all__ = ["models"]
