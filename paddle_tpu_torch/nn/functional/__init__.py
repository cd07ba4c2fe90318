"""Functionals: attention (dense flash, packed varlen, FlashMask and the
packed-qkv forms) and the loss."""
from .extras import (flash_attention_with_sparse_mask, flash_attn_qkvpacked,
                     flash_attn_varlen_qkvpacked)
from .flash_attention import (ATTENTION_ROUTES, attention_route,
                              flash_attention, flash_attn_unpadded,
                              scaled_dot_product_attention)
from .loss import cross_entropy

__all__ = ["flash_attention", "scaled_dot_product_attention",
           "flash_attn_unpadded", "flash_attn_varlen_qkvpacked",
           "flash_attn_qkvpacked", "flash_attention_with_sparse_mask",
           "cross_entropy", "attention_route", "ATTENTION_ROUTES"]
