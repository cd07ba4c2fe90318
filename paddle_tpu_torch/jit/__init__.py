"""The training step of the PyTorch port (counterpart of paddle_tpu/jit)."""
from .train_step import TrainStep

__all__ = ["TrainStep"]
