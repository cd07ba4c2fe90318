"""PyTorch/CUDA port of paddle_tpu, beside the JAX package.

The port runs on an NVIDIA Hopper card: plain tensor code is PyTorch, and
every Pallas kernel of the JAX package on a ported path is a CUDA C++
kernel written for sm_90a (``csrc/``), built with nvcc at first use
(``kernels/_build.py``). Entry points run on ``cuda`` unless the caller
asks for the CPU (``device="cpu"``), where each kernel wrapper takes its
plain PyTorch version. The first slice is greedy serving: LlamaForCausalLM,
CachedDecoder and PagedDecoder with the continuous-batching serve loop.
"""
from .framework.device import resolve_device, seed
from .models.decode import CachedDecoder
from .models.llama import (LlamaConfig, LlamaForCausalLM, llama_2_7b,
                           llama_tiny)
from .models.paged_decode import BlockAllocator, PagedDecoder

__all__ = ["resolve_device", "seed", "LlamaConfig", "LlamaForCausalLM",
           "llama_tiny", "llama_2_7b", "CachedDecoder", "PagedDecoder",
           "BlockAllocator"]
