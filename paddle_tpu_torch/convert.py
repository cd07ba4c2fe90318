"""Weights from the JAX package into the port.

``params_from_jax`` turns a ``paddle_tpu`` LlamaForCausalLM ``state_dict()``
(converted to numpy arrays by the caller) into the state dict of this
package's LlamaForCausalLM. Parameter names are the same in both packages;
the layouts differ in one place: paddle's ``Linear.weight`` is
[in, out] and the JAX decoders compute ``x @ w``, while
``torch.nn.Linear.weight`` is [out, in]. Every projection and the LM head
are therefore transposed here, and nowhere else.
"""
from __future__ import annotations

import numpy as np
import torch

from .framework.device import torch_dtype

__all__ = ["params_from_jax"]

_LINEAR_SUFFIXES = ("q_proj.weight", "k_proj.weight", "v_proj.weight",
                    "o_proj.weight", "gate_proj.weight", "up_proj.weight",
                    "down_proj.weight")


def _is_linear(name):
    return name == "lm_head.weight" or name.endswith(_LINEAR_SUFFIXES)


def params_from_jax(state_dict_numpy, cfg):
    """{name: numpy array} of the JAX model -> {name: torch tensor} for
    ``LlamaForCausalLM(cfg).load_state_dict``, in the config's dtype.
    Shapes are checked against ``cfg`` so a mismatched config fails
    here rather than inside a matmul."""
    dtype = torch_dtype(cfg.dtype)
    h, hd = cfg.hidden_size, cfg.head_dim
    expect = {
        "q_proj.weight": (h, cfg.num_attention_heads * hd),
        "k_proj.weight": (h, cfg.num_key_value_heads * hd),
        "v_proj.weight": (h, cfg.num_key_value_heads * hd),
        "o_proj.weight": (cfg.num_attention_heads * hd, h),
        "gate_proj.weight": (h, cfg.intermediate_size),
        "up_proj.weight": (h, cfg.intermediate_size),
        "down_proj.weight": (cfg.intermediate_size, h),
        "lm_head.weight": (h, cfg.vocab_size),
        "embed_tokens.weight": (cfg.vocab_size, h),
    }
    out = {}
    for name, arr in state_dict_numpy.items():
        a = np.asarray(arr)
        for suffix, shape in expect.items():
            if name.endswith(suffix) and a.shape != shape:
                raise ValueError(f"{name}: JAX shape {a.shape}, config "
                                 f"expects {shape}")
        if _is_linear(name):
            a = a.T
        out[name] = torch.from_numpy(np.array(a, np.float32)).to(dtype)
    return out
