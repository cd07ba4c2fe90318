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

``tp_params_from_jax`` gives one rank's shard for a model built with
``tensor_parallel=True`` (Llama or GPT-2) over ``mp_degree`` ranks: the
full parameters converted as above, then each sharded one sliced as the
port's mp layers hold it (fleet/meta_parallel/mp_layers.py): the vocab
rows of the embedding, the output rows of a column projection (and of
its bias; GPT's fused qkv takes its heads of each of q, k and v), the
input columns of a row projection, and everything else whole.

``pp_params_from_jax`` gives one rank's stage for a model built with
``pipeline_parallel=True``: the JAX model's stacked (natural-order
``decoder_stack.<key>``, [L, ...]) or per-layer weights become the
per-layer weights of the layers the stage holds
(``decoder_stack.layers.<l>``), with the embeddings, norm and head of its
ends, then sliced as ``tp_params_from_jax`` slices for tensor
parallelism. ``pp_params_to_jax`` gathers the stages (and the mp shards)
back into the JAX model's natural-order state dict on stage 0.

``moe_ep_params_from_jax`` gives one expert-parallel rank of the GPT-MoE
(or of one MoELayer) its expert slice, rows ep_rank * E / ep ... of each
expert stack, with the dense weights whole; ``moe_ep_params_to_jax``
gathers a rank's model back (a collective over the expert group: the
expert slices concatenated, every Linear transposed back) into the JAX
model's state dict, and ``zero_params_to_jax`` does it for a
GroupShardedStage3 model (its whole state dict, gathered).

``semi_auto_params_to_jax`` gathers an auto-parallel Llama (its DTensor
parameters after ``distributed.shard_layer``, each made whole by
``full_tensor``, a collective of the mesh) into the JAX model's names and
layout. Loading one stays ``params_from_jax`` followed by ``shard_layer``.

``resnet_params_from_jax`` does it for the ResNet family
(vision/models/resnet.py): the convolution weights ([out, in / groups, *k]
in both packages) and the batch norms' ``weight``, ``bias``, ``_mean`` and
``_variance`` convert as they are, and ``fc.weight`` is transposed; every
name and shape is checked against the port's model.
``optimizer_state_from_jax`` takes that model in place of a config, for
Momentum's ``velocity`` (the fc's transposed too).
"""
from __future__ import annotations

import numpy as np
import torch

from .framework.device import torch_dtype
from .models.gpt import GPTConfig
from .vision.models.resnet import ResNet

__all__ = ["params_from_jax", "optimizer_state_from_jax",
           "gpt_params_from_jax", "moe_params_from_jax",
           "resnet_params_from_jax", "tp_params_from_jax", "tp_shard",
           "pp_params_from_jax", "pp_params_to_jax",
           "moe_ep_params_from_jax", "moe_ep_params_to_jax",
           "zero_params_to_jax", "semi_auto_params_to_jax"]

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
    """(is_linear, check_shape) of the model a config builds (or of a
    port ResNet, given itself)."""
    if isinstance(cfg, GPTConfig):
        return _gpt_is_linear, _gpt_check_shape
    if isinstance(cfg, ResNet):
        return _resnet_is_linear, _resnet_checker(cfg)
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
    for a GPTConfig, a GPTForCausalLM(cfg), or for a port ResNet ``cfg``
    that model, whose parameters carry their qualified names. Each
    accumulator keeps its dtype (a bfloat16 moment stays bfloat16)."""
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


def _is_expert_stack(name):
    return name.split(".")[-2:-1] == ["experts"] and \
        name.rsplit(".", 1)[-1] in ("w1", "b1", "w2", "b2")


def moe_ep_params_from_jax(state_dict_numpy, cfg, ep_rank, ep_degree):
    """moe_params_from_jax for rank ``ep_rank`` of ``ep_degree``: each
    expert stack [E, ...] cut to this rank's E / ep_degree rows, the dense
    weights whole."""
    full = moe_params_from_jax(state_dict_numpy, cfg)
    el = cfg.num_experts // ep_degree
    return {k: (v[ep_rank * el:(ep_rank + 1) * el].clone()
                if _is_expert_stack(k) else v) for k, v in full.items()}


def moe_ep_params_to_jax(model, ep_group=None):
    """The JAX state dict ({name: float32 numpy array}, paddle's layout)
    of an expert-parallel GPT-MoE or MoELayer rank ``model``: the expert
    stacks gathered over ``ep_group`` (the model's own by default) in
    group-rank order. A collective: every rank of the group calls it."""
    from .distributed.collective import all_gather_object
    sd = {k: v.detach().float().cpu().numpy()
          for k, v in model.state_dict().items()}
    if ep_group is None:
        ep_group = next((m.ep_group for m in model.modules()
                         if getattr(m, "ep_group", None) is not None), None)
    if ep_group is not None and ep_group.nranks > 1:
        parts = []
        all_gather_object(parts, {k: v for k, v in sd.items()
                                  if _is_expert_stack(k)}, group=ep_group)
        for k in parts[0]:
            sd[k] = np.concatenate([p[k] for p in parts])
    return {k: (v.T if _moe_is_linear(k) else v) for k, v in sd.items()}


def _sd_to_jax(sd, is_linear):
    return {k: (v.detach().float().cpu().numpy().T if is_linear(k)
                else v.detach().float().cpu().numpy())
            for k, v in sd.items()}


def zero_params_to_jax(model, is_linear=_moe_is_linear):
    """The JAX state dict of a model under a ZeRO wrapper (the whole
    parameters, gathered by the wrapper's state_dict: a collective), with
    the Linear weights ``is_linear`` names transposed back."""
    return _sd_to_jax(model.state_dict(), is_linear)


def semi_auto_params_to_jax(model):
    """The JAX state dict of a Llama whose parameters are DTensors (each
    gathered whole on every rank by ``full_tensor``: a collective)."""
    from torch.distributed.tensor import DTensor
    return _sd_to_jax({k: v.full_tensor() if isinstance(v, DTensor) else v
                       for k, v in model.state_dict().items()}, _is_linear)


def _resnet_is_linear(name):
    return name == "fc.weight"


def _resnet_checker(model):
    """check_shape against the port ResNet ``model``: the JAX shape of
    each entry must be the model's (transposed for fc.weight), and the
    name one of the model's."""
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}

    def check(name, a, _cfg=None):
        if name not in shapes:
            raise ValueError(f"{name}: the port's model has no such entry")
        expect = shapes[name][::-1] if _resnet_is_linear(name) \
            else shapes[name]
        if a.shape != expect:
            raise ValueError(f"{name}: JAX shape {a.shape}, the port's "
                             f"model expects {expect}")
    return check


def resnet_params_from_jax(state_dict_numpy, model):
    """{name: numpy array} of the JAX ResNet (parameters and the batch
    norms' ``_mean`` / ``_variance``) -> {name: torch tensor} for the port
    ResNet ``model``'s ``load_state_dict``, in its dtype: ``fc.weight``
    transposed, everything else as it is. Raises for a name the model
    lacks, a shape it does not have, or an entry of the model missing."""
    check = _resnet_checker(model)
    missing = set(model.state_dict()) - set(state_dict_numpy)
    if missing:
        raise ValueError(f"entries of the port's model missing from the JAX "
                         f"state: {sorted(missing)}")
    dtype = next(model.parameters()).dtype
    out = {}
    for name, arr in state_dict_numpy.items():
        a = np.asarray(arr)
        check(name, a)
        out[name] = _to_torch(name, a, dtype, _resnet_is_linear)
    return out


# "module.parameter" -> (split dim, fused parts) of the tensor-parallel
# shards, in the port's layout; a parameter not named here is whole on
# every rank
_TP_SPLITS = {
    "embed_tokens.weight": (0, 1), "lm_head.weight": (0, 1),
    "q_proj.weight": (0, 1), "k_proj.weight": (0, 1),
    "v_proj.weight": (0, 1), "gate_proj.weight": (0, 1),
    "up_proj.weight": (0, 1), "o_proj.weight": (1, 1),
    "down_proj.weight": (1, 1),
    "wte.weight": (0, 1), "qkv_proj.weight": (0, 3),
    "qkv_proj.bias": (0, 3), "fc_in.weight": (0, 1), "fc_in.bias": (0, 1),
    "out_proj.weight": (1, 1), "fc_out.weight": (1, 1),
}


def tp_shard(name, full, mp_rank, mp_degree):
    """Rank ``mp_rank``'s shard of the port-layout tensor ``full`` of
    parameter ``name`` over ``mp_degree`` ranks."""
    from .distributed.fleet.meta_parallel.mp_layers import shard_of
    split = _TP_SPLITS.get(".".join(name.split(".")[-2:]))
    if split is None:
        return full
    dim, parts = split
    if full.shape[dim] % (mp_degree * parts):
        raise ValueError(f"{name}: dim {dim} of {tuple(full.shape)} does "
                         f"not split over mp {mp_degree}")
    return shard_of(full, dim, mp_degree, mp_rank, parts).contiguous()


def tp_params_from_jax(state_dict_numpy, cfg, mp_rank, mp_degree):
    """{name: numpy array} of the JAX Llama or GPT-2 (full parameters) ->
    {name: torch tensor}: rank ``mp_rank``'s shard of each, in the port's
    layout, for the port's model built with ``tensor_parallel=True`` over
    ``mp_degree`` ranks."""
    full = gpt_params_from_jax(state_dict_numpy, cfg) \
        if isinstance(cfg, GPTConfig) else params_from_jax(state_dict_numpy,
                                                           cfg)
    return {k: tp_shard(k, v, mp_rank, mp_degree) for k, v in full.items()}


def _pp_family(cfg):
    """(root module, the one-rank model's layer list, stacked decoder
    class, whole-model converter) of the family a config builds."""
    if isinstance(cfg, GPTConfig):
        from .models.gpt_pipe import GPTStackedDecoder
        return "gpt", "h", GPTStackedDecoder, gpt_params_from_jax
    from .models.llama_pipe import LlamaStackedDecoder
    return "llama", "layers", LlamaStackedDecoder, params_from_jax


def _pp_keeps(root, name, cfg, first, last):
    """Whether a stage holds the non-layer entry ``name``."""
    leaf = name[len(root) + 1:] if name.startswith(root + ".") else name
    if root == "gpt":
        if leaf.startswith("wte."):
            return first or last
        if leaf.startswith("wpe."):
            return first
        return last                       # ln_f
    if leaf.startswith("embed_tokens."):
        return first or (last and cfg.tie_word_embeddings)
    return last                           # norm, lm_head


def pp_params_from_jax(state_dict_numpy, cfg, pp_rank, pp_degree, mp_rank=0,
                       mp_degree=1):
    """{name: numpy array} of the JAX Llama or GPT-2, pipelined (the
    natural-order stacked ``decoder_stack.<key>`` arrays, [L, ...]) or not
    (the one-rank model's per-layer names) -> {name: torch tensor} of the
    stage ``pp_rank`` of ``pp_degree`` holds (``cfg.virtual_pp_degree``
    chunks: models/_stacked_pipe.py's assignment), in the port's layout
    (Linear weights transposed) and sliced to rank ``mp_rank`` of
    ``mp_degree`` as tp_shard slices, for that rank's pipelined model's
    ``load_state_dict``."""
    from .models._stacked_pipe import stage_layers
    root, plain, stack, convert = _pp_family(cfg)
    L = cfg.num_hidden_layers
    V = int(getattr(cfg, "virtual_pp_degree", 1) or 1)
    mine = {l for chunk in stage_layers(L, pp_degree, V, pp_rank)
            for l in chunk}
    first, last = pp_rank == 0, pp_rank == pp_degree - 1
    stacked, per_layer = f"{root}.decoder_stack.", f"{root}.{plain}."
    flat = {}
    for name, arr in state_dict_numpy.items():
        a = np.asarray(arr)
        if name.startswith(stacked):
            key = name[len(stacked):]
            path = ".".join(stack._LAYER_ATTRS[key])
            if a.shape[0] != L:
                raise ValueError(f"{name}: {a.shape[0]} stacked layers, the "
                                 f"config has {L}")
            for l in sorted(mine):
                flat[f"{stacked}layers.{l}.{path}"] = a[l]
        elif name.startswith(per_layer):
            l, rest = name[len(per_layer):].split(".", 1)
            if int(l) in mine:
                flat[f"{stacked}layers.{l}.{rest}"] = a
        elif _pp_keeps(root, name, cfg, first, last):
            flat[name] = a
    return {k: tp_shard(k, v, mp_rank, mp_degree)
            for k, v in convert(flat, cfg).items()}


def _tp_unshard(name, shards):
    """The whole port-layout tensor of parameter ``name`` from its mp
    shards in rank order (tp_shard's inverse)."""
    split = _TP_SPLITS.get(".".join(name.split(".")[-2:]))
    if split is None or len(shards) == 1:
        return shards[0]
    dim, parts = split
    if parts == 1:
        return np.concatenate(shards, dim)
    sections = [np.split(s, parts, dim) for s in shards]
    return np.concatenate([np.concatenate([sec[p] for sec in sections], dim)
                           for p in range(parts)], dim)


def pp_params_to_jax(model):
    """The inverse of pp_params_from_jax, a collective over the pipelined
    ``model``'s pp and mp groups (every rank calls it): on pp stage 0 the
    JAX package's natural-order state dict of the pipelined model
    ({name: float32 numpy array}, paddle's layout, the decoder weights
    stacked [L, ...] as ``decoder_stack.<key>``); None on the other
    stages."""
    from .distributed.collective import all_gather_object
    cfg = model.config
    root, _, stack, _ = _pp_family(cfg)
    hcg = model._pp_stack()._hcg
    sd = {k: v.detach().float().cpu().numpy()
          for k, v in model.state_dict().items()}
    mp = hcg.get_model_parallel_group()
    if mp.nranks > 1:
        parts = []
        all_gather_object(parts, sd, group=mp)
        sd = {k: _tp_unshard(k, [p[k] for p in parts]) for k in sd}
    stages = []
    all_gather_object(stages, sd, group=hcg.get_pipe_parallel_group())
    if hcg.get_stage_id() != 0:
        return None
    merged = {}
    for part in stages:
        for k, v in part.items():
            merged.setdefault(k, v)
    is_linear = _gpt_is_linear if root == "gpt" else _is_linear
    prefix = f"{root}.decoder_stack."
    out = {k: (v.T if is_linear(k) else v) for k, v in merged.items()
           if not k.startswith(prefix)}
    for key, attrs in stack._LAYER_ATTRS.items():
        path = ".".join(attrs)
        mats = [merged[f"{prefix}layers.{l}.{path}"]
                for l in range(cfg.num_hidden_layers)]
        if key in stack._TRANSPOSED:
            mats = [m.T for m in mats]
        out[prefix + key] = np.stack(mats)
    return out
