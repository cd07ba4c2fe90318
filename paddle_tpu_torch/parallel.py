"""paddle.parallel (counterpart of paddle_tpu/parallel.py): the
data-parallel helpers of distributed/ at top level."""
from .distributed.env import ParallelEnv  # noqa: F401
from .distributed.parallel import DataParallel, init_parallel_env  # noqa: F401

__all__ = ["DataParallel", "init_parallel_env", "ParallelEnv"]
