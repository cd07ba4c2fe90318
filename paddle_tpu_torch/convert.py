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

``gpt_params_from_jax`` does it for GPT-2 (models/gpt.py): the fused qkv,
the attention output and the two MLP Linears are transposed; ``wte`` (which
the tied head reads as it is), ``wpe``, the biases and the LayerNorms
convert as they are, and there is no head entry to convert.
``optimizer_state_from_jax`` takes a GPTConfig too.

``moe_params_from_jax`` does it for the GPT-MoE of models/gpt_moe.py (or
one of its MoELayers): the attention projections, the gate's Linear, the
dense lane's fc1/fc2 and the head are transposed; the expert stacks keep
the JAX package's [E, K, N] layout, and biases, the embedding and the
LayerNorms convert as they are.
"""
from __future__ import annotations

import numpy as np
import torch

from .framework.device import torch_dtype
from .models.gpt import GPTConfig

__all__ = ["params_from_jax", "optimizer_state_from_jax",
           "gpt_params_from_jax", "moe_params_from_jax"]

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
    _check_suffixes(name, a, expect)


def _check_suffixes(name, a, expect):
    for suffix, shape in expect.items():
        if name.endswith(suffix) and a.shape != shape:
            raise ValueError(f"{name}: JAX shape {a.shape}, config expects "
                             f"{shape}")


def _to_torch(name, a, dtype, is_linear=_is_linear):
    if is_linear(name):
        a = a.T
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


_GPT_LINEAR_SUFFIXES = ("qkv_proj.weight", "out_proj.weight",
                        "fc_in.weight", "fc_out.weight")


def _gpt_is_linear(name):
    return name.endswith(_GPT_LINEAR_SUFFIXES)


def _gpt_check_shape(name, a, cfg):
    """Raise unless the JAX array ``a`` of parameter ``name`` (or of one of
    its optimizer moments) has the shape the GPTConfig ``cfg`` gives it. A
    head entry raises: the head is tied to wte and has none."""
    if "lm_head" in name:
        raise ValueError(f"{name}: GPT's head is tied to gpt.wte.weight and "
                         f"has no parameter of its own")
    h, f = cfg.hidden_size, cfg.intermediate_size
    expect = {
        "qkv_proj.weight": (h, 3 * h), "qkv_proj.bias": (3 * h,),
        "out_proj.weight": (h, h), "out_proj.bias": (h,),
        "fc_in.weight": (h, f), "fc_in.bias": (f,),
        "fc_out.weight": (f, h), "fc_out.bias": (h,),
        "wte.weight": (cfg.vocab_size, h),
        "wpe.weight": (cfg.max_position_embeddings, h),
    }
    expect.update({f"{ln}.{w}": (h,) for ln in ("ln_1", "ln_2", "ln_f")
                   for w in ("weight", "bias")})
    _check_suffixes(name, a, expect)


def _layout(cfg):
    """(is_linear, check_shape) of the model a config builds."""
    if isinstance(cfg, GPTConfig):
        return _gpt_is_linear, _gpt_check_shape
    return _is_linear, _check_shape


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
    port's ``Optimizer.set_state_dict`` on a LlamaForCausalLM(cfg) or,
    for a GPTConfig, a GPTForCausalLM(cfg), whose parameters carry their
    qualified names. Each accumulator keeps its
    dtype (a bfloat16 moment stays bfloat16)."""
    is_linear, check_shape = _layout(cfg)
    out = {}
    for key, arr in named_accums_numpy.items():
        pname, acc = key.split("::", 1)
        a = np.asarray(arr)
        check_shape(pname, a, cfg)
        dtype = torch_dtype("bfloat16" if a.dtype.name == "bfloat16"
                            else "float32")
        out[f"{pname}__{acc}"] = _to_torch(pname, a, dtype, is_linear)
    out["@step"] = int(step)
    return out


def gpt_params_from_jax(state_dict_numpy, cfg):
    """{name: numpy array} of the JAX GPTForCausalLM -> {name: torch
    tensor} for the port's ``GPTForCausalLM(cfg).load_state_dict``, in the
    config's dtype: the four Linear weights of each block transposed once,
    everything else (wte included) as it is."""
    dtype = torch_dtype(cfg.dtype)
    out = {}
    for name, arr in state_dict_numpy.items():
        a = np.asarray(arr)
        _gpt_check_shape(name, a, cfg)
        out[name] = _to_torch(name, a, dtype, _gpt_is_linear)
    return out


_MOE_LINEAR_SUFFIXES = ("q_proj.weight", "k_proj.weight", "v_proj.weight",
                        "out_proj.weight", "gate.gate.weight", "fc1.weight",
                        "fc2.weight")


def _moe_is_linear(name):
    return name == "head.weight" or name.endswith(_MOE_LINEAR_SUFFIXES)


def _moe_check_shape(name, a, cfg):
    """Raise unless the JAX array ``a`` of parameter ``name`` has the
    shape the GPTMoEConfig ``cfg`` gives it."""
    h, e, f, v = (cfg.hidden_size, cfg.num_experts, cfg.d_hidden,
                  cfg.vocab_size)
    expect = {
        "q_proj.weight": (h, h), "k_proj.weight": (h, h),
        "v_proj.weight": (h, h), "out_proj.weight": (h, h),
        "gate.gate.weight": (h, e), "gate.gate.bias": (e,),
        "experts.w1": (e, h, f), "experts.b1": (e, 1, f),
        "experts.w2": (e, f, h), "experts.b2": (e, 1, h),
        "fc1.weight": (h, 4 * h), "fc2.weight": (4 * h, h),
        "emb.weight": (v, h), "head.weight": (h, v), "head.bias": (v,),
    }
    _check_suffixes(name, a, expect)


def moe_params_from_jax(state_dict_numpy, cfg):
    """{name: numpy array} of the JAX GPT-MoE (or of one MoELayer of its
    widths) -> {name: torch tensor} for the port's ``load_state_dict``, in
    the config's dtype: every Linear weight transposed once, everything
    else as it is."""
    dtype = torch_dtype(cfg.dtype)
    out = {}
    for name, arr in state_dict_numpy.items():
        a = np.asarray(arr)
        _moe_check_shape(name, a, cfg)
        out[name] = _to_torch(name, a, dtype, _moe_is_linear)
    return out
