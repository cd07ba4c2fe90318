"""Llama and its serving engines."""
from .decode import CachedDecoder
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,
                    LlamaPretrainingCriterion, llama_2_7b, llama_tiny)
from .paged_decode import BlockAllocator, PagedDecoder

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "LlamaPretrainingCriterion", "llama_tiny",
           "llama_2_7b", "CachedDecoder", "PagedDecoder", "BlockAllocator"]
