"""Incubating APIs (counterpart of paddle_tpu/incubate)."""
