"""Serving loop, admission queue, replay tracker and radix prefix cache."""
from .batcher import serve_loop
from .cache import PrefixMatch, RadixPrefixCache, plan_prefix
from .scheduler import AdmissionQueue, ReplayTracker

__all__ = ["serve_loop", "AdmissionQueue", "ReplayTracker",
           "RadixPrefixCache", "PrefixMatch", "plan_prefix"]
