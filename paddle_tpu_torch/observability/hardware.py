"""The model-FLOPs formula behind MFU (counterpart of
paddle_tpu/observability/hardware.py, whose formula this copies; the
peaks there are TPU chips', not the port's)."""
from __future__ import annotations

__all__ = ["model_flops_per_token"]


def model_flops_per_token(cfg, seq_len, n_params):
    """6N (forward and backward matmuls) + 12 * L * (heads * head_dim) * S
    (attention scores and values, forward and backward): the PaLM
    appendix formula the JAX package uses for MFU."""
    attn_width = cfg.num_attention_heads * cfg.head_dim
    return 6.0 * n_params + 12.0 * cfg.num_hidden_layers * attn_width \
        * seq_len
