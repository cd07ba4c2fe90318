"""PyTorch/CUDA port of paddle_tpu, beside the JAX package.

The port runs on an NVIDIA Hopper card: plain tensor code is PyTorch, and
every Pallas kernel of the JAX package on a ported path is a CUDA C++
kernel written for sm_90a (``csrc/``), built with nvcc at first use
(``kernels/_build.py``). Entry points run on ``cuda`` unless the caller
asks for the CPU (``device="cpu"``), where each kernel wrapper takes its
plain PyTorch version. Seven slices are ported: serving, greedy or
sampled (LlamaForCausalLM, CachedDecoder's fused decode chunks and
PagedDecoder with the zero-sync pipelined continuous-batching loop, each
decode chunk a CUDA graph on the card, its radix prefix cache and the
quarantine and replay of non-finite logits), the pretraining step (TrainStep over
LlamaForCausalLM, LlamaPretrainingCriterion and AdamW), quantized and
long-context serving (the decoders' weight_quant, kv_quant and
attn_shards options), mixture-of-experts training on one device (the
GPT-MoE of benchmarks/gpt_moe_ep.py through MoELayer's capacity and
dropless grouped dispatch, models/gpt_moe.py), and packed and masked
attention, forward and backward (``nn.functional.flash_attn_unpadded``,
``flash_attn_varlen_qkvpacked``, ``flash_attn_qkvpacked`` and
``flash_attention_with_sparse_mask``), and the row-wise incubate
functionals, forward and backward (``incubate.nn.functional.
fused_rms_norm``, ``fused_rotary_position_embedding`` and
``incubate.softmax_mask_fuse_upper_triangle``), and GPT-2 pretraining
(GPTForCausalLM with LayerNorm, GELU and generator-driven dropout, under
TrainStep with the LRScheduler learning rates of ``optimizer.lr`` and the
gradient clipping of ``nn.clip``).
"""
from . import nn
from .framework.device import resolve_device, seed
from .jit import TrainStep
from .models.decode import CachedDecoder
from .models.llama import (LlamaConfig, LlamaForCausalLM,
                           LlamaPretrainingCriterion, llama_2_7b, llama_tiny)
from .models.gpt import GPTConfig, GPTForCausalLM, gpt2_124m, gpt_tiny
from .models.gpt_moe import GPTMoEConfig, MoEGPT, gpt_moe_config, moe_loss
from .models.paged_decode import BlockAllocator, PagedDecoder
from . import optimizer
from .optimizer import Adam, AdamW

__all__ = ["nn", "resolve_device", "seed", "LlamaConfig", "LlamaForCausalLM",
           "LlamaPretrainingCriterion", "llama_tiny", "llama_2_7b",
           "CachedDecoder", "PagedDecoder", "BlockAllocator", "TrainStep",
           "Adam", "AdamW", "GPTMoEConfig", "MoEGPT", "gpt_moe_config",
           "moe_loss", "GPTConfig", "GPTForCausalLM", "gpt2_124m", "gpt_tiny",
           "optimizer"]
