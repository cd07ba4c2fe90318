"""The pipeline-parallel GPT block stack, per rank (counterpart of
paddle_tpu/models/gpt_pipe.py).

Same design as models/llama_pipe.py: each stage runs the port's GPTBlock
(models/gpt.py). As the reference's, the pipeline runs dropout-free
(GPTConfig(dropout=0) is required), so no random stream crosses stages.
The blocks draw their weights from the model's generator as they are
built, so every rank builds every block in order and keeps its own: each
rank's weights are the one-rank model's from the same seed.
"""
from __future__ import annotations

from ._stacked_pipe import StackedDecoderBase

__all__ = ["GPTStackedDecoder"]

# weight-kind -> (the reference's per-layer shape fn(config), its mp dim)
_WEIGHT_SPECS = {
    "ln1_w": (lambda c: (c.hidden_size,), None),
    "ln1_b": (lambda c: (c.hidden_size,), None),
    "wqkv": (lambda c: (c.hidden_size, 3 * c.hidden_size), 1),
    "bqkv": (lambda c: (3 * c.hidden_size,), 0),
    "wo": (lambda c: (c.hidden_size, c.hidden_size), 0),
    "bo": (lambda c: (c.hidden_size,), None),
    "ln2_w": (lambda c: (c.hidden_size,), None),
    "ln2_b": (lambda c: (c.hidden_size,), None),
    "wfc": (lambda c: (c.hidden_size, c.intermediate_size), 1),
    "bfc": (lambda c: (c.intermediate_size,), 0),
    "wproj": (lambda c: (c.intermediate_size, c.hidden_size), 0),
    "bproj": (lambda c: (c.hidden_size,), None),
}


class GPTStackedDecoder(StackedDecoderBase):
    """This rank's GPT blocks (one stage of the pre-LN block stack)."""

    _WEIGHT_SPECS = _WEIGHT_SPECS
    _LAYER_ATTRS = {
        "ln1_w": ("ln_1", "weight"), "ln1_b": ("ln_1", "bias"),
        "wqkv": ("attn", "qkv_proj", "weight"),
        "bqkv": ("attn", "qkv_proj", "bias"),
        "wo": ("attn", "out_proj", "weight"),
        "bo": ("attn", "out_proj", "bias"),
        "ln2_w": ("ln_2", "weight"), "ln2_b": ("ln_2", "bias"),
        "wfc": ("mlp", "fc_in", "weight"), "bfc": ("mlp", "fc_in", "bias"),
        "wproj": ("mlp", "fc_out", "weight"),
        "bproj": ("mlp", "fc_out", "bias"),
    }
    _TRANSPOSED = ("wqkv", "wo", "wfc", "wproj")

    def __init__(self, config, device, dtype, generator):
        from .gpt import GPTBlock
        if config.dropout:
            raise ValueError(
                "pipeline_parallel GPT runs dropout-free: build the "
                "config with dropout=0")
        super().__init__(
            config, lambda l: GPTBlock(config, device, dtype, generator),
            build_all=True)
