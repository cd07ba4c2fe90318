"""Functionals: attention (dense flash, packed varlen, FlashMask and the
packed-qkv forms), the loss, gelu, dropout and layer_norm."""
from .activation import gelu
from .common import dropout
from .extras import (flash_attention_with_sparse_mask, flash_attn_qkvpacked,
                     flash_attn_varlen_qkvpacked)
from .flash_attention import (ATTENTION_ROUTES, attention_route,
                              flash_attention, flash_attn_unpadded,
                              scaled_dot_product_attention)
from .loss import cross_entropy
from .norm import layer_norm

__all__ = ["flash_attention", "scaled_dot_product_attention",
           "flash_attn_unpadded", "flash_attn_varlen_qkvpacked",
           "flash_attn_qkvpacked", "flash_attention_with_sparse_mask",
           "cross_entropy", "attention_route", "ATTENTION_ROUTES", "gelu",
           "dropout", "layer_norm"]
