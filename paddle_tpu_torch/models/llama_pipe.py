"""The pipeline-parallel Llama decoder stack, per rank (counterpart of
paddle_tpu/models/llama_pipe.py).

Each stage runs the port's LlamaDecoderLayer (models/llama.py), with the
tensor-parallel layers when ``tensor_parallel=True``, so its attention
takes the route ``flash_attention`` takes (the dense flash kernels at
D 64/128 in bfloat16 with S a multiple of 128). The reference's
stacked-weight names (``ln1``, ``wq`` ... ``wd``, [L, ...] with paddle's
[in, out] layout) stay the names the converters and placement_factors
speak. ``recompute_policy`` other than None (the selective policies)
raises; whole-layer or whole-stage recompute is ``recompute_granularity``.
"""
from __future__ import annotations

from ._stacked_pipe import StackedDecoderBase

__all__ = ["LlamaStackedDecoder"]


def _qd(c):
    return c.num_attention_heads * c.head_dim


def _kvd(c):
    return c.num_key_value_heads * c.head_dim


# weight-kind -> (the reference's per-layer shape fn(config), its mp dim)
_WEIGHT_SPECS = {
    "ln1": (lambda c: (c.hidden_size,), None),
    "wq": (lambda c: (c.hidden_size, _qd(c)), 1),
    "wk": (lambda c: (c.hidden_size, _kvd(c)), 1),
    "wv": (lambda c: (c.hidden_size, _kvd(c)), 1),
    "wo": (lambda c: (_qd(c), c.hidden_size), 0),
    "ln2": (lambda c: (c.hidden_size,), None),
    "wg": (lambda c: (c.hidden_size, c.intermediate_size), 1),
    "wu": (lambda c: (c.hidden_size, c.intermediate_size), 1),
    "wd": (lambda c: (c.intermediate_size, c.hidden_size), 0),
}


class LlamaStackedDecoder(StackedDecoderBase):
    """This rank's Llama decoder layers (the math of
    LayerList([LlamaDecoderLayer] * L), one stage of it)."""

    _WEIGHT_SPECS = _WEIGHT_SPECS
    _LAYER_ATTRS = {
        "ln1": ("input_layernorm", "weight"),
        "wq": ("self_attn", "q_proj", "weight"),
        "wk": ("self_attn", "k_proj", "weight"),
        "wv": ("self_attn", "v_proj", "weight"),
        "wo": ("self_attn", "o_proj", "weight"),
        "ln2": ("post_attention_layernorm", "weight"),
        "wg": ("mlp", "gate_proj", "weight"),
        "wu": ("mlp", "up_proj", "weight"),
        "wd": ("mlp", "down_proj", "weight"),
    }
    _TRANSPOSED = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")

    def __init__(self, config, device=None, dtype=None):
        from .llama import LlamaDecoderLayer
        if config.recompute and config.recompute_policy is not None:
            raise NotImplementedError(
                f"pipeline recompute_policy={config.recompute_policy!r} is "
                f"not ported to the PyTorch package yet; recompute=True "
                f"with recompute_granularity 'layer' or 'stage' is")
        super().__init__(
            config, lambda l: LlamaDecoderLayer(config, device, dtype))
