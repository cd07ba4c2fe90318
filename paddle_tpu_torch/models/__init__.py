"""Llama and its serving engines, and the GPT-MoE of the MoE benchmark."""
from .decode import CachedDecoder
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,
                    LlamaPretrainingCriterion, llama_2_7b, llama_tiny)
from .gpt_moe import GPTMoEConfig, MoEGPT, gpt_moe_config, gpt_moe_tiny
from .paged_decode import BlockAllocator, PagedDecoder

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "LlamaPretrainingCriterion", "llama_tiny",
           "llama_2_7b", "CachedDecoder", "PagedDecoder", "BlockAllocator",
           "GPTMoEConfig", "MoEGPT", "gpt_moe_config", "gpt_moe_tiny"]
