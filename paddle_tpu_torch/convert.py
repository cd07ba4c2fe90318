"""Weights and optimizer state from the JAX package into the port.

``params_from_jax`` turns a ``paddle_tpu`` LlamaForCausalLM ``state_dict()``
(converted to numpy arrays by the caller) into the state dict of this
package's LlamaForCausalLM. Parameter names are the same in both packages;
the layouts differ in one place: paddle's ``Linear.weight`` is
[in, out] and the JAX decoders compute ``x @ w``, while
``torch.nn.Linear.weight`` is [out, in]. Every projection and the LM head
are therefore transposed here, and nowhere else.

``optimizer_state_from_jax`` does the same for the JAX TrainStep's
optimizer accumulators (Adam's moments are laid out as their parameter,
so a Linear's moments are transposed too), so that a run can go on in the
port from a JAX run's state.
"""
from __future__ import annotations

import numpy as np
import torch

from .framework.device import torch_dtype

__all__ = ["params_from_jax", "optimizer_state_from_jax"]

_LINEAR_SUFFIXES = ("q_proj.weight", "k_proj.weight", "v_proj.weight",
                    "o_proj.weight", "gate_proj.weight", "up_proj.weight",
                    "down_proj.weight")


def _is_linear(name):
    return name == "lm_head.weight" or name.endswith(_LINEAR_SUFFIXES)


def _check_shape(name, a, cfg):
    """Raise unless the JAX array ``a`` of parameter ``name`` (or of one of
    its optimizer moments) has the shape ``cfg`` gives that parameter, so
    a mismatched config fails here rather than inside a matmul."""
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
    for suffix, shape in expect.items():
        if name.endswith(suffix) and a.shape != shape:
            raise ValueError(f"{name}: JAX shape {a.shape}, config expects "
                             f"{shape}")


def _to_torch(name, a, dtype):
    if _is_linear(name):
        a = a.T
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def params_from_jax(state_dict_numpy, cfg):
    """{name: numpy array} of the JAX model -> {name: torch tensor} for
    ``LlamaForCausalLM(cfg).load_state_dict``, in the config's dtype."""
    dtype = torch_dtype(cfg.dtype)
    out = {}
    for name, arr in state_dict_numpy.items():
        a = np.asarray(arr)
        _check_shape(name, a, cfg)
        out[name] = _to_torch(name, a, dtype)
    return out


def optimizer_state_from_jax(named_accums_numpy, cfg, step):
    """The JAX TrainStep's accumulators, ``{"<param>::<accumulator>":
    numpy array}`` (``TrainStep._accums_to_named()``, converted to numpy by
    the caller), and its optimizer's step count -> a state dict for the
    port's ``Optimizer.set_state_dict`` on a LlamaForCausalLM(cfg), whose
    parameters carry their qualified names. Each accumulator keeps its
    dtype (a bfloat16 moment stays bfloat16)."""
    out = {}
    for key, arr in named_accums_numpy.items():
        pname, acc = key.split("::", 1)
        a = np.asarray(arr)
        _check_shape(pname, a, cfg)
        dtype = torch_dtype("bfloat16" if a.dtype.name == "bfloat16"
                            else "float32")
        out[f"{pname}__{acc}"] = _to_torch(pname, a, dtype)
    out["@step"] = int(step)
    return out
