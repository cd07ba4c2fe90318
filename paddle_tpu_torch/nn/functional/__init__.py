"""Functionals: attention (dense flash, packed varlen, FlashMask and the
packed-qkv forms), the losses, gelu, relu, dropout, quant_linear, layer_norm and
batch_norm, the convolutions and the pools."""
from .activation import gelu, relu
from .common import dropout, quant_linear
from .conv import (conv1d, conv1d_transpose, conv2d, conv2d_transpose,
                   conv3d, conv3d_transpose)
from .extras import (flash_attention_with_sparse_mask, flash_attn_qkvpacked,
                     flash_attn_varlen_qkvpacked)
from .flash_attention import (ATTENTION_ROUTES, attention_route,
                              flash_attention, flash_attn_unpadded,
                              scaled_dot_product_attention)
from .loss import cross_entropy, mse_loss
from .norm import batch_norm, layer_norm
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, max_pool1d, max_pool2d,
                      max_pool3d)

__all__ = ["flash_attention", "scaled_dot_product_attention",
           "flash_attn_unpadded", "flash_attn_varlen_qkvpacked",
           "flash_attn_qkvpacked", "flash_attention_with_sparse_mask",
           "cross_entropy", "mse_loss", "attention_route", "ATTENTION_ROUTES", "gelu",
           "relu", "dropout", "quant_linear", "layer_norm", "batch_norm", "conv1d", "conv2d",
           "conv3d", "conv1d_transpose", "conv2d_transpose",
           "conv3d_transpose", "avg_pool1d", "avg_pool2d", "avg_pool3d",
           "max_pool1d", "max_pool2d", "max_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d"]
