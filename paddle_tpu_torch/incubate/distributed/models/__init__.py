"""Distributed model components."""
