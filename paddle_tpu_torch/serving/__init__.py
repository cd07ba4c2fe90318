"""Serving loop and admission queue."""
from .batcher import serve_loop
from .scheduler import AdmissionQueue

__all__ = ["serve_loop", "AdmissionQueue"]
