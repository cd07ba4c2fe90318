"""Functionals."""
