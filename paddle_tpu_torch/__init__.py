"""PyTorch/CUDA port of paddle_tpu, beside the JAX package.

The port runs on an NVIDIA Hopper card: plain tensor code is PyTorch, and
every Pallas kernel of the JAX package on a ported path is a CUDA C++
kernel written for sm_90a (``csrc/``), built with nvcc at first use
(``kernels/_build.py``). Entry points run on ``cuda`` unless the caller
asks for the CPU (``device="cpu"``), where each kernel wrapper takes its
plain PyTorch version. Four slices are ported: greedy serving
(LlamaForCausalLM, CachedDecoder and PagedDecoder with the
continuous-batching serve loop), the pretraining step (TrainStep over
LlamaForCausalLM, LlamaPretrainingCriterion and AdamW), quantized and
long-context serving (the decoders' weight_quant, kv_quant and
attn_shards options), and mixture-of-experts training on one device (the
GPT-MoE of benchmarks/gpt_moe_ep.py through MoELayer's capacity and
dropless grouped dispatch, models/gpt_moe.py).
"""
from .framework.device import resolve_device, seed
from .jit import TrainStep
from .models.decode import CachedDecoder
from .models.llama import (LlamaConfig, LlamaForCausalLM,
                           LlamaPretrainingCriterion, llama_2_7b, llama_tiny)
from .models.gpt_moe import GPTMoEConfig, MoEGPT, gpt_moe_config, moe_loss
from .models.paged_decode import BlockAllocator, PagedDecoder
from .optimizer import Adam, AdamW

__all__ = ["resolve_device", "seed", "LlamaConfig", "LlamaForCausalLM",
           "LlamaPretrainingCriterion", "llama_tiny", "llama_2_7b",
           "CachedDecoder", "PagedDecoder", "BlockAllocator", "TrainStep",
           "Adam", "AdamW", "GPTMoEConfig", "MoEGPT", "gpt_moe_config",
           "moe_loss"]
