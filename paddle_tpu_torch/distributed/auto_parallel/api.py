"""Auto-parallel user API on torch.distributed.tensor: shard_tensor /
reshard / shard_layer / shard_optimizer / shard_dataloader / to_static
(counterpart of paddle_tpu/distributed/auto_parallel/api.py).

A distributed tensor is a DTensor: each rank holds its shard, the global
shape and the placements ride with it, and torch's sharding propagation
runs every op on the shards with the collectives it needs (the role the
JAX package gives GSPMD). Placements are Paddle's (placement.py), one a
mesh dimension, mapped onto torch's.

Two things differ from the reference, which holds one global array:

- ``shard_tensor`` on a dense tensor trusts every rank to hold the same
  value and keeps this rank's slice, sending nothing (``src_data_rank=
  None``), as Paddle's eager replicated-to-sharded reshard does; the
  port's models draw the same weights on every rank from one seed.
- torch cannot turn a tensor into a DTensor in place. ``shard_tensor`` on
  a parameter returns a new DTensor parameter and swaps it for the old one
  in every optimizer and TrainStep built earlier; ``shard_layer`` also
  swaps it into the layer's modules, so a ``shard_fn`` written for Paddle
  (which discards the return value) works. Outside ``shard_layer`` the
  caller assigns the returned parameter to its module.

Paddle's layout is the contract of ``shard_fn``: a Paddle Linear weight
is [in, out], the port's (torch.nn.Linear's) [out, in]. ``shard_layer``
marks each nn.Linear weight, and ``shard_tensor`` maps tensor dim d of a
marked 2-D weight to 1 - d, so the reference's megatron ``shard_fn``
(column: Shard(1), row: Shard(0)) splits the output rows of a column
projection and the input columns of a row projection.
``paddle_placements(t)`` reads placements back in Paddle's layout; the
DTensor's own ``placements`` are torch's, of the tensor as stored.
``shard_layer`` then hooks Megatron's all-reduces onto the split Linears
(a row projection's output, a column projection's input gradient), so a
model needs no code of its own for them.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from ...framework.dtensor import (grad_reduced, reduced, replace_parameter,
                                  replicated)
from ..misc import ShardingStage1
from .placement import Partial, Replicate, Shard, from_torch

__all__ = ["shard_tensor", "reshard", "dtensor_from_fn", "shard_layer",
           "shard_optimizer", "shard_dataloader", "to_static", "DistModel",
           "DistAttr", "Strategy", "unshard_dtensor", "paddle_placements",
           "placements_to_torch"]


def _normalize_placements(placements, mesh):
    out = list(placements)
    while len(out) < mesh.ndim:
        out.append(Replicate())
    return out


def _transposed(t):
    return bool(getattr(t, "_paddle_transposed", False)) and t.dim() == 2


def placements_to_torch(placements, ndim, transposed=False):
    """torch placements of Paddle ``placements`` on a tensor of rank
    ``ndim`` (the counterpart of the reference's placements_to_spec). With
    ``transposed`` (a 2-D weight stored [out, in]) Shard(d) becomes
    Shard(1 - d)."""
    out = []
    for p in placements:
        if isinstance(p, Shard) and transposed:
            p = Shard(1 - p.get_dim() % ndim)
        out.append(p._to_torch())
    return out


def paddle_placements(t):
    """The Paddle placements of DTensor ``t``, in Paddle's layout (a
    weight stored transposed reports the dims of its Paddle [in, out]
    form); None for a dense tensor."""
    if not isinstance(t, DTensor):
        return None
    out = [from_torch(p) for p in t.placements]
    if _transposed(t):
        out = [Shard(1 - p.get_dim()) if isinstance(p, Shard) else p
               for p in out]
    return out


def _no_partial(placements, what):
    if any(isinstance(p, Partial) for p in placements):
        raise NotImplementedError(
            f"{what} to Partial placements is not supported on eager "
            f"tensors: a dense tensor holds the global value, so there is "
            f"no pending per-shard sum to track (as in the reference)")


def _attach(t, mesh):
    t.process_mesh = mesh
    return t


def _check_mesh(mesh, t):
    dm = mesh.device_mesh()
    if t.device_mesh != dm:
        raise NotImplementedError(
            "reshard across meshes is not ported: the tensor lies on "
            f"{t.device_mesh}, the target mesh is {mesh}")
    return dm


def shard_tensor(data, mesh, placements, dtype=None, place=None,
                 stop_gradient=None):
    """A DTensor placed on ``mesh`` as ``placements`` say (reference
    api.py:130). ``data`` holds the global value on every rank (a tensor,
    numpy array or nested list); a DTensor is redistributed. A parameter
    becomes a new DTensor parameter that replaces it in every optimizer
    and TrainStep (and, under shard_layer, every module) that holds it.
    ``place`` is accepted and unused (the world's device type places the
    mesh)."""
    placements = _normalize_placements(placements, mesh)
    _no_partial(placements, "shard_tensor")
    orig, is_param = data, isinstance(data, nn.Parameter)
    if not isinstance(data, torch.Tensor):
        data = torch.as_tensor(np.asarray(data))
    if dtype is not None:
        from ...framework.device import torch_dtype
        data = data.to(torch_dtype(dtype) if isinstance(dtype, str)
                       else dtype)
    dm = mesh.device_mesh()
    tplc = placements_to_torch(placements, data.dim(), _transposed(data))
    if isinstance(data, DTensor):
        _check_mesh(mesh, data)
        out = data.redistribute(dm, tplc)
    else:
        out = distribute_tensor(data.detach(), dm, tplc, src_data_rank=None)
    if is_param:
        new = nn.Parameter(out.detach(), requires_grad=data.requires_grad)
        # the parameter's own attributes (its name, the layout mark)
        new.__dict__.update({k: v for k, v in orig.__dict__.items()
                             if k != "process_mesh"})
        if _REPLACING is not None:
            _REPLACING[id(orig)] = (orig, new)
        replace_parameter(orig, new)
        return _attach(new, mesh)
    if stop_gradient is not None:
        out.requires_grad_(not stop_gradient)
    elif not isinstance(data, DTensor) and data.requires_grad:
        out.requires_grad_(True)
    return _attach(out, mesh)


def reshard(dist_tensor, mesh, placements):
    """Redistribute to ``placements`` on ``mesh``, differentiably (torch
    picks the collective: s -> r all-gather, p -> r all-reduce, s -> s'
    all-to-all, r -> s a local slice). A dense tensor is taken as the
    global value on every rank. Partial raises, as in the reference."""
    placements = _normalize_placements(placements, mesh)
    _no_partial(placements, "reshard")
    if not isinstance(dist_tensor, DTensor):
        return shard_tensor(dist_tensor, mesh, placements)
    dm = _check_mesh(mesh, dist_tensor)
    tplc = placements_to_torch(placements, dist_tensor.dim(),
                               _transposed(dist_tensor))
    return _attach(dist_tensor.redistribute(dm, tplc), mesh)


def dtensor_from_fn(fn, mesh, placements, *args, **kwargs):
    """fn(*args, **kwargs) on every rank (the same value from the same
    seed), then sharded."""
    return shard_tensor(fn(*args, **kwargs), mesh, placements)


def unshard_dtensor(dist_tensor):
    """The whole value as a dense tensor on every rank (a gather), with
    ``process_mesh`` None; differentiable."""
    t = dist_tensor.full_tensor() if isinstance(dist_tensor, DTensor) \
        else dist_tensor
    t.process_mesh = None
    return t


# -- shard_layer ---------------------------------------------------------------

# {id(old parameter): (old, new)} while shard_layer runs its shard_fn
_REPLACING = None


def _swap_module_params(layer, swaps):
    for m in layer.modules():
        for k, p in list(m._parameters.items()):
            hit = swaps.get(id(p)) if p is not None else None
            if hit is not None and hit[0] is p:
                m._parameters[k] = hit[1]


def _replicate_rest(layer, mesh):
    """A parameter the shard_fn left dense is replicated on the mesh (a
    dense tensor cannot meet a DTensor in torch)."""
    for m in layer.modules():
        for k, p in list(m._parameters.items()):
            if p is not None and not isinstance(p, DTensor):
                shard_tensor(p, mesh, [Replicate()])


def _megatron_hooks(layer):
    """Megatron's two all-reduces, placed by how each nn.Linear's weight
    ([out, in] as torch stores it) is split. A weight split on its input
    dim (a row projection) leaves partial sums, reduced at its output; one
    split on its output dim (a column projection) leaves a partial
    gradient of its input, reduced in the backward. Without them torch
    gathers the activation and every rank computes a partial whole
    gradient of the weight; with them each split weight's gradient is its
    shard. Column projections called one after another on one input (q, k
    and v; gate and up) share one reduction of its gradient."""
    last = [None]       # (input, its grad_reduced view), both weak

    def column(mod, args):
        x, hit = args[0], last[0]
        y = hit[1]() if hit is not None and hit[0]() is x else None
        if y is None:
            y = grad_reduced(x)
            last[0] = (weakref.ref(x), weakref.ref(y))
        return (y,) + tuple(args[1:])

    def row(mod, args, out):
        return reduced(out)

    for m in layer.modules():
        w = getattr(m, "weight", None)
        if not isinstance(m, nn.Linear) or not isinstance(w, DTensor):
            continue
        split = {p.dim for p in w.placements if p.is_shard()}
        if 1 in split:
            m.register_forward_hook(row)
        if 0 in split:
            m.register_forward_pre_hook(column)


def shard_layer(layer, process_mesh, shard_fn=None, input_fn=None,
                output_fn=None):
    """Shard ``layer``'s parameters in place (reference api.py:445):
    ``shard_fn(name, sublayer, mesh)`` runs on every sublayer (the layer
    itself first, as "") and calls ``shard_tensor`` on the parameters it
    places, in Paddle's layout; the default and every parameter it leaves
    are replicated. Each nn.Linear whose weight comes out split gets
    Megatron's all-reduce as a hook (``_megatron_hooks``).
    ``input_fn(inputs, mesh)`` and ``output_fn(outputs, mesh)`` become
    forward pre- and post-hooks. Returns ``layer``."""
    global _REPLACING

    def default_fn(name, sublayer, mesh):
        for pname, p in sublayer._parameters.items():
            if p is not None:
                shard_tensor(p, mesh, [Replicate()])

    for m in layer.modules():
        if isinstance(m, nn.Linear) and m.weight is not None:
            m.weight._paddle_transposed = True
    fn = shard_fn or default_fn
    outer, _REPLACING = _REPLACING, {}
    try:
        for name, sub in layer.named_modules():
            fn(name, sub, process_mesh)
            _swap_module_params(sub, _REPLACING)
        _swap_module_params(layer, _REPLACING)
        _replicate_rest(layer, process_mesh)
        _swap_module_params(layer, _REPLACING)
    finally:
        _REPLACING = outer
    _megatron_hooks(layer)
    if input_fn is not None:
        layer.register_forward_pre_hook(
            lambda l, inp: input_fn(inp, process_mesh))
    if output_fn is not None:
        layer.register_forward_hook(
            lambda l, inp, out: output_fn(out, process_mesh))
    return layer


# -- shard_optimizer -----------------------------------------------------------

class _ShardOptimizer:
    """reference api.py:1120 shard_optimizer: the optimizer's states follow
    their parameter's placements (they are created zeros_like it, so a
    DTensor parameter's moments are DTensors laid out as it, and each rank
    updates its shard). A ``shard_fn(accumulator_name, param,
    accumulator)`` runs on every state after each step and may re-place
    it (its return value, when not None, replaces the state)."""

    def __init__(self, optimizer, shard_fn=None):
        if isinstance(shard_fn, ShardingStage1):
            raise NotImplementedError(
                f"shard_optimizer(shard_fn={type(shard_fn).__name__}(...)): "
                f"the ShardingStage markers have no call in the reference "
                f"either (its step fails on them); pass a callable "
                f"shard_fn(accumulator_name, param, accumulator), or use "
                f"fleet's ZeRO stages (distributed.sharding)")
        self._inner = optimizer
        self._shard_fn = shard_fn

    def __getattr__(self, item):
        return getattr(self._inner, item)

    def _apply_state_sharding(self):
        if self._shard_fn is None:
            return
        by_id = {id(p): p for p in self._inner._parameter_list}
        for (accname, pid), acc in list(self._inner._accumulators.items()):
            param = by_id.get(pid)
            if param is None:
                continue
            out = self._shard_fn(accname, param, acc)
            if out is not None:
                self._inner._accumulators[(accname, pid)] = out

    def step(self, grads=None):
        self._inner.step(grads=grads)
        self._apply_state_sharding()

    def clear_grad(self, *a, **k):
        self._inner.clear_grad(*a, **k)


def shard_optimizer(optimizer, shard_fn=None):
    """Wrap ``optimizer`` (reference api.py:1120). The reference's
    ShardingStage1/2/3 markers raise NotImplementedError here: they have
    no ``__call__``, and the reference fails on them at the first step."""
    return _ShardOptimizer(optimizer, shard_fn)


# -- shard_dataloader ----------------------------------------------------------

def shard_dataloader(dataloader, meshes, shard_dims=None,
                     is_dataset_splitted=False):
    """Wrap an iterable of batches so that each tensor of a batch is split
    along its dim 0 over the mesh axis ``shard_dims`` names, or the first
    axis when it names none (reference api.py:2325). Every rank iterates
    the whole batch and keeps its rows."""
    mesh = meshes[0] if isinstance(meshes, (list, tuple)) else meshes
    dim = shard_dims if isinstance(shard_dims, str) else None

    class _Wrapper:
        def __init__(self, dl):
            self._dl = dl

        def __iter__(self):
            for batch in self._dl:
                items = batch if isinstance(batch, (list, tuple)) else [batch]
                out = []
                for t in items:
                    if isinstance(t, torch.Tensor):
                        axis = dim or mesh.dim_names[0]
                        pl = [Replicate()] * mesh.ndim
                        pl[mesh.dim_names.index(axis)] = Shard(0)
                        out.append(shard_tensor(t, mesh, pl))
                    else:
                        out.append(t)
                yield out if isinstance(batch, (list, tuple)) else out[0]

        def __len__(self):
            return len(self._dl)

    return _Wrapper(dataloader)


# -- to_static / DistModel -----------------------------------------------------

class Strategy:
    """reference auto_parallel/strategy.py: pass-config container."""

    def __init__(self, config=None):
        config = config or {}
        self.sharding = _Cfg(config.get("sharding", {}))
        self.fused_passes = _Cfg(config.get("fused_passes", {}))
        self.gradient_merge = _Cfg(config.get("gradient_merge", {}))
        self.pipeline = _Cfg(config.get("pipeline", {}))
        self.amp = _Cfg(config.get("amp", {}))
        self.recompute = _Cfg(config.get("recompute", {}))


class _Cfg(dict):
    def __init__(self, d):
        super().__init__(d)
        self.__dict__ = self
        self.setdefault("enable", False)


class DistAttr:
    """Legacy DistAttr facade (reference dist_attr) mapping to placements."""

    def __init__(self, mesh, sharding_specs):
        self.process_mesh = mesh
        self.sharding_specs = sharding_specs


class DistModel:
    """reference api.py:1631 DistModel: the model, its loss and optimizer
    as one train or eval step. Training runs the port's TrainStep (the
    strategy's gradient_merge gives accum_steps and avg, amp.master_grad
    master_grad); eval runs the network and the loss under no_grad, and
    with no loss every argument is a network input."""

    def __init__(self, layer, loader=None, loss=None, optimizer=None,
                 strategy=None):
        self.network = layer
        self._loss = loss
        self._opt = optimizer
        self._strategy = strategy
        self._mode = "train"
        self._step = None

    def train(self):
        self._mode = "train"
        self.network.train()

    def eval(self):
        self._mode = "eval"
        self.network.eval()

    def _build_step(self):
        if self._step is None:
            from ...jit.train_step import TrainStep
            accum, mean = 1, True
            s = self._strategy
            gm = getattr(s, "gradient_merge", None) if s else None
            if gm is not None and gm.get("enable"):
                accum = int(gm.get("k_steps", 1) or 1)
                mean = bool(gm.get("avg", True))
            amp_cfg = getattr(s, "amp", None) if s else None
            mg = bool(amp_cfg is not None and amp_cfg.get("enable")
                      and amp_cfg.get("master_grad"))
            self._step = TrainStep(self.network, self._loss, self._opt,
                                   accum_steps=accum, accum_mean=mean,
                                   master_grad=mg)
        return self._step

    def __call__(self, *args):
        if self._mode == "train" and self._opt is not None:
            inputs, labels = args[:-1], args[-1:]
            return self._build_step()(inputs, labels)
        with torch.no_grad():
            if self._loss is None:
                return self.network(*args)
            out = self.network(*args[:-1])
            return replicated(self._loss(out, *args[-1:]))

    def state_dict(self, *a, **k):
        return self.network.state_dict(*a, **k)

    def set_state_dict(self, sd, *a, **k):
        load = getattr(self.network, "set_state_dict",
                       self.network.load_state_dict)
        return load(sd, *a, **k)


def to_static(layer, loader=None, loss=None, optimizer=None, strategy=None):
    """reference api.py:2096: returns (DistModel, loader)."""
    if isinstance(optimizer, _ShardOptimizer):
        optimizer = optimizer._inner
    return DistModel(layer, loader, loss, optimizer, strategy), loader

