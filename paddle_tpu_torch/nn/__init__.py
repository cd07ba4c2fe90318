"""Layers and functionals."""
