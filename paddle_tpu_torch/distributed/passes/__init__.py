"""Distributed passes (counterpart of paddle_tpu/distributed/passes/): the
pipeline scheduler family, as per-rank instruction streams and the
dependency simulator that validates them."""
from .pipeline_scheduler import (  # noqa: F401
    PipelineSchedule, FThenB, OneFOneB, Eager1F1B, InterleavedOneFOneB,
    ZeroBubbleH1, simulate_schedule, F, B, W)

__all__ = ["PipelineSchedule", "FThenB", "OneFOneB", "Eager1F1B",
           "InterleavedOneFOneB", "ZeroBubbleH1", "simulate_schedule",
           "F", "B", "W"]
