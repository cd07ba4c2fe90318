"""Resilience: the seeded fault-injection harness (``faults``)."""
from . import faults

__all__ = ["faults"]
