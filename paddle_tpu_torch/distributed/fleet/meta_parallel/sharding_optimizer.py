"""ZeRO sharding stages 1-3 on torch.distributed (counterpart of
paddle_tpu/distributed/fleet/meta_parallel/sharding_optimizer.py).

The JAX package expresses each stage as a GSPMD placement of the state
over its 'sharding' mesh axis: one controller, the whole batch. Here each
rank runs its own rows and keeps its own share of the state, and the step
computes the same update: N ranks with N row blocks equal one process on
the concatenated batch.

A parameter's shard is a flat slice: with L values and N ranks of the
sharding group, rank r owns values [r c, min(L, (r + 1) c)), c =
ceil(L / N) (the reference picks a dimension with ``shard_spec_for``; the
values do not depend on it). The update is the wrapped optimizer's own
element-wise ``_apply_one`` run on that slice, so a sharded step is the
unsharded one bit for bit on the same gradient.

- ``DygraphShardingOptimizer`` (stage 1): the moments exist for this
  rank's slice only. ``step`` all-reduces the full gradients (clipping
  sees them whole), steps the slice, then all-gathers the updated
  parameters.
- ``GroupShardedOptimizerStage2``: as stage 1, but the gradients are
  reduce-scattered into the slice instead of all-reduced, and the full
  gradient is freed. Over a ``GroupShardedStage2`` model it takes the
  slices that model's buckets reduced in backward; over a bare model (as
  benchmarks/gpt_moe_ep.py composes it) it reduce-scatters every gradient
  in its step, one buffer per dtype.
- ``GroupShardedStage2`` (the model wrapper): its parameters, last first
  (backward produces the last layers' gradients first), are cut into
  buckets of at most ``buffer_max_size`` values. A per-parameter hook
  marks each gradient as backward accumulates it; once a bucket is
  complete it is reduce-scattered as one buffer and its full gradients
  freed. Buckets go strictly in order, and the step sends whatever
  backward left (a gradient that never came counts as zeros), so every
  rank issues the same reduce-scatters in the same order even where a
  parameter goes unreached on some ranks.
- ``GroupShardedStage3``: the parameters rest as padded 1/N slices. Before
  a block's forward its parameters are all-gathered (a differentiable
  gather whose backward reduce-scatters the gradient into the slice) and
  after it they are freed; the tensors backward needs are not kept but
  gathered again when backward reaches them (saved-tensor hooks). The
  blocks are the items of the model's ModuleLists, and the rest of the
  model is one block around them (a model without a ModuleList is one
  block).

Gradient scale: each rank's loss is the mean over its own rows. A dense
gradient is summed over the data world (every rank with rows of its own:
dp x sharding x ep) and divided by its size; an expert parameter (marked
``expert`` by ExpertMLP under expert parallelism) has already received its
expert group's share through the backward all-to-all, so it is summed over
its replicas (dp x sharding) and divided by the size of the whole data
world. A reduce-scatter over the sharding group followed by an all-reduce
over the rest of that set (fleet's ``get_sharding_complement_group``) is
the same sum.

The sharding group is fleet's sharding group (or the dp group when the
sharding degree is 1, as the JAX package falls back), the given ``group``,
or the world without fleet. Not ported, raising NotImplementedError:
``offload=True``, the gradient sync's ``grad_compress`` /
``grad_bucket_mb`` on the sharding axis, ClipGradByNorm with sharded
gradients (stages 2 and 3; the global-norm clips sum their squares over
the sharding group, ClipGradByValue needs nothing), and sharding combined
with tensor or pipeline parallelism (fleet.init refuses it).
"""
from __future__ import annotations

import weakref

import torch
import torch.distributed as tdist
from torch import nn

from ...collective import Group, _ag, _ar, _group_of, _rs

__all__ = ["DygraphShardingOptimizer", "GroupShardedOptimizerStage2",
           "GroupShardedStage2", "GroupShardedStage3", "zero_state_bytes"]


def _is_expert(p):
    return bool(getattr(p, "expert", False))


class _ZeroGroups:
    """The sharding group, the group each kind of parameter is summed over
    after the reduce-scatter (dense, expert), and the data world's size
    (the divisor)."""

    def __init__(self, hcg=None, group=None):
        from ...env import get_rank
        from ..fleet import live_hcg
        hcg = hcg if hcg is not None else live_hcg()
        alone = Group([get_rank()], None, name="zero_alone")
        if hcg is not None and hcg.get_expert_parallel_world_size() > 1:
            sharding = hcg.get_sharding_parallel_group()
            if group is not None and list(group.ranks) != \
                    list(sharding.ranks):
                raise NotImplementedError(
                    "sharding over a group other than fleet's sharding "
                    "group under expert parallelism is not ported to the "
                    "PyTorch package yet")
            self.sharding = sharding
            self.dense = hcg.get_sharding_complement_group()
            self.expert = hcg.get_sharding_complement_group(expert=True)
            self.n_data = hcg.get_data_world_group().nranks
            return
        if group is None and hcg is not None:
            group = hcg.get_sharding_parallel_group()
            if group.nranks == 1:
                group = hcg.get_data_parallel_group()
        self.sharding = _group_of(group)
        world = hcg.get_data_world_group() if hcg is not None else None
        if world is not None and world.nranks > self.sharding.nranks:
            if list(self.sharding.ranks) != list(
                    hcg.get_sharding_parallel_group().ranks):
                raise NotImplementedError(
                    "sharding over a group that is neither fleet's "
                    "sharding group nor its data world is not ported")
            self.dense = hcg.get_sharding_complement_group()
            self.n_data = world.nranks
        else:
            self.dense = alone
            self.n_data = self.sharding.nranks
        self.expert = alone

    def outer(self, p):
        return self.expert if _is_expert(p) else self.dense


def _chunk(numel, n):
    return -(-int(numel) // n)


def _padded_rows(flat, n, c):
    """``flat`` zero-padded to n * c values, viewed [n, c]."""
    pad = n * c - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(n, c)


def _reduce_scatter_flat(tensors, group):
    """[this rank's summed slice of each tensor] (each [c], c = its
    chunk), one reduce-scatter of one buffer per dtype."""
    n = group.nranks
    out = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        rows = [_padded_rows(tensors[i].reshape(-1), n,
                             _chunk(tensors[i].numel(), n)) for i in idx]
        buf = torch.cat(rows, dim=1).contiguous()           # [n, sum c]
        mine = buf.new_empty(buf.shape[1])
        _rs(mine, buf.reshape(-1), tdist.ReduceOp.SUM, group)
        off = 0
        for i, row in zip(idx, rows):
            out[i] = mine[off:off + row.shape[1]]
            off += row.shape[1]
    return out


def _all_gather_flat(slices, numels, group):
    """The whole flat tensor of each [c]-value slice (one all-gather of
    one buffer per dtype)."""
    n = group.nranks
    out = [None] * len(slices)
    by_dtype = {}
    for i, t in enumerate(slices):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        buf = torch.cat([slices[i].reshape(-1) for i in idx]).contiguous()
        whole = buf.new_empty(n * buf.numel())
        _ag(whole, buf, group)
        whole = whole.view(n, -1)
        off = 0
        for i in idx:
            c = slices[i].numel()
            out[i] = whole[:, off:off + c].reshape(-1)[:numels[i]]
            off += c
    return out


def _sum_outer(shards, params, zg, whole=False):
    """Sum each slice over its parameter's outer group (each whole
    gradient over the sharding group too, ``whole``) and divide by the
    data world's size, one all-reduce per (group, dtype)."""
    buckets = {}
    for i, p in enumerate(params):
        g = zg.outer(p)
        buckets.setdefault((id(g), shards[i].dtype), (g, []))[1].append(i)
    for g, idx in buckets.values():
        flat = torch.cat([shards[i].reshape(-1) for i in idx])
        if whole:
            _ar(flat, tdist.ReduceOp.SUM, zg.sharding)
        _ar(flat, tdist.ReduceOp.SUM, g)
        flat.div_(zg.n_data)
        off = 0
        for i in idx:
            c = shards[i].numel()
            shards[i] = flat[off:off + c].view_as(shards[i])
            off += c
    return shards


class _Shard:
    """Parameter ``p``'s slice on this rank: ``view`` aliases p's values
    [lo, hi) (the optimizer steps it in place)."""

    def __init__(self, p, n, r):
        self.numel = p.numel()
        self.c = _chunk(self.numel, n)
        self.lo = min(r * self.c, self.numel)
        self.hi = min(self.lo + self.c, self.numel)
        self.view = p.data.view(-1)[self.lo:self.hi]


def _accumulator_names(inner):
    """The accumulators every parameter of ``inner`` has (the same list on
    every rank, whichever slices are empty here)."""
    from ....optimizer import Adam, Momentum
    if isinstance(inner, Adam):
        return ("moment1", "moment2")
    if isinstance(inner, Momentum):
        return ("velocity",)
    return ()


class DygraphShardingOptimizer:
    """Stage 1 (module docstring). Wraps one of the port's optimizers;
    every attribute it does not hold passes through to the inner one."""

    STAGE = 1
    _shards_grads = True
    _SELF_ATTRS = ("_inner", "_zg", "_shards", "_rest", "_grad_shards",
                   "_buckets")

    def __init__(self, optimizer, hcg=None, group=None, offload=False,
                 grad_sync_config=None, grad_compress=None,
                 grad_bucket_mb=None):
        object.__setattr__(self, "_inner", optimizer)
        if offload:
            raise NotImplementedError(
                "offload=True (optimizer state in host memory) is not "
                "ported to the PyTorch package yet")
        if grad_sync_config or grad_compress or grad_bucket_mb:
            raise NotImplementedError(
                "grad_compress / grad_bucket_mb on the sharding axis are "
                "not ported to the PyTorch package yet")
        self._zg = _ZeroGroups(hcg, group)
        g = self._zg.sharding
        self._shards = {}
        self._rest = {}            # id -> (shape, numel, c): stage-3 slices
        self._grad_shards = {}     # id -> this rank's summed gradient slice
        self._buckets = None       # GroupShardedStage2's (held weakly)
        for p in optimizer._parameter_list:
            self._add_shard(p, g)

    def _add_shard(self, p, g):
        sh = _Shard(p, g.nranks, g.rank)
        self._shards[id(p)] = sh
        self._inner._names[id(sh.view)] = self._inner._names[id(p)]

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_inner"), name)

    def __setattr__(self, name, value):
        if name in type(self)._SELF_ATTRS:
            object.__setattr__(self, name, value)
        else:
            setattr(object.__getattribute__(self, "_inner"), name, value)

    @property
    def _sharding_group(self):
        return self._zg.sharding

    # -- stage 3 hands its resting slices over --------------------------------
    def _adopt_resting(self, p, shape, numel, c):
        """``p`` now rests as its padded [c] slice (GroupShardedStage3):
        its gradient arrives reduce-scattered and it is stepped whole."""
        sh = self._shards.pop(id(p), None)
        if sh is not None:
            self._inner._names.pop(id(sh.view), None)
        self._rest[id(p)] = (tuple(shape), int(numel), int(c))

    def _note_grad_shard(self, p, g):
        """Add ``g`` (p's gradient slice, summed over the sharding group)
        to what this step applies."""
        have = self._grad_shards.get(id(p))
        self._grad_shards[id(p)] = g if have is None else have.add_(g)

    # -- the step -----------------------------------------------------------
    def _full_grads(self, params, grads):
        out = []
        for p in params:
            g = grads.get(id(p), p.grad)
            out.append(torch.zeros_like(p) if g is None else g)
        return out

    def _reduced_slices(self, params, grads):
        """{id(p): this rank's gradient slice, the data world's mean}.
        Which path a parameter takes depends only on the parameter lists,
        so every rank issues the same collectives in the same order."""
        zg, inner = self._zg, self._inner
        mine = {}
        buckets = self._buckets() if self._buckets is not None else None
        hooked = {}
        if buckets is not None:
            buckets.flush_for_step()
            hooked = buckets.index
        rest = [p for p in params if id(p) in self._rest]
        done = [p for p in params if id(p) in hooked]
        whole = [p for p in params
                 if id(p) not in self._rest and id(p) not in hooked]
        if whole and self.STAGE == 1:
            # the full gradient, averaged over the data world on every rank
            red = _sum_outer(self._full_grads(whole, grads), whole, zg,
                             whole=True)
            if inner._grad_clip is not None:
                red = [g for _, g in inner._grad_clip(list(zip(whole, red)))]
            for p, g in zip(whole, red):
                p.grad = g.view_as(p)
                sh = self._shards[id(p)]
                mine[id(p)] = g.reshape(-1)[sh.lo:sh.hi]
        elif whole:
            full = self._full_grads(whole, grads)
            sl = _reduce_scatter_flat(full, zg.sharding)
            for p, s in zip(whole, sl):
                sh = self._shards[id(p)]
                self._note_grad_shard(p, s[:sh.hi - sh.lo])
                p.grad = None                   # the full gradient is freed
            done = done + whole
        if rest:
            sl = _sum_outer([p.grad if p.grad is not None
                             else torch.zeros_like(p) for p in rest],
                            rest, zg)
            for p, s in zip(rest, sl):
                p.grad = s
                mine[id(p)] = s
        if done:
            sl = _sum_outer([self._grad_shards[id(p)] for p in done], done,
                            zg)
            for p, s in zip(done, sl):
                mine[id(p)] = s
        if (done or rest) and inner._grad_clip is not None:
            mine.update(self._clip_slices(done + rest, mine))
        return mine

    def _clip_slices(self, params, mine):
        """The inner optimizer's clip on this rank's gradient slices: the
        global norms' squares are summed over the sharding group (every
        other rank holds the other slices)."""
        from ....incubate.distributed.models.moe.grad_clip import (
            ClipGradForMOEByGlobalNorm)
        from ....nn.clip import ClipGradByGlobalNorm, ClipGradByValue
        clip = self._inner._grad_clip
        pairs = [(p, mine[id(p)]) for p in params]
        if isinstance(clip, ClipGradByValue):
            clipped = clip(pairs)
        elif isinstance(clip, (ClipGradByGlobalNorm,
                               ClipGradForMOEByGlobalNorm)):
            def sum_squares(t):
                t = t.contiguous()
                _ar(t, tdist.ReduceOp.SUM, self._zg.sharding)
                return t
            clipped = clip._dygraph_clip(pairs, sum_squares=sum_squares)
        else:
            raise NotImplementedError(
                f"{type(clip).__name__} with sharded gradients (stages 2 "
                f"and 3) is not ported to the PyTorch package yet")
        return {id(p): g for p, g in clipped}

    @torch.no_grad()
    def step(self, grads=None):
        """Reduce the gradients into this rank's slices, step the slices
        with the inner optimizer's update, then all-gather the parameters
        that rest whole. ``grads`` ({id(param): tensor}) replaces p.grad
        where given, as the inner optimizer's step."""
        inner = self._inner
        params = [p for grp in inner._param_groups for p in grp["params"]
                  if p.requires_grad]
        mine = self._reduced_slices(params, grads or {})
        lr_base = inner.get_lr()
        for grp in inner._param_groups:
            lr = lr_base if grp["learning_rate"] is None \
                else float(grp["learning_rate"])
            wd = grp["weight_decay"] if grp["weight_decay"] is not None \
                else inner._weight_decay
            for p in grp["params"]:
                g = mine.get(id(p))
                if g is None:
                    continue
                target = p if id(p) in self._rest \
                    else self._shards[id(p)].view
                if target.numel() == 0:
                    continue
                g = g.reshape(target.shape)
                if g.dtype == torch.bfloat16:
                    g = g.float()
                inner._apply_one(target, g, lr, wd)
        inner._step_count += 1
        self._gather_params(params)

    def _gather_params(self, params):
        whole = [p for p in params if id(p) in self._shards]
        if not whole or self._zg.sharding._local:
            return
        g = self._zg.sharding
        slices = []
        for p in whole:
            sh = self._shards[id(p)]
            pad = sh.c - (sh.hi - sh.lo)
            v = sh.view
            slices.append(torch.cat([v, v.new_zeros(pad)]) if pad else v)
        full = _all_gather_flat(slices, [p.numel() for p in whole], g)
        for p, f in zip(whole, full):
            p.data.view(-1).copy_(f)

    def clear_grad(self, set_to_zero=True):
        self._grad_shards.clear()
        buckets = self._buckets() if self._buckets is not None else None
        if buckets is not None:
            buckets.sent = 0
        return self._inner.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def minimize(self, loss, *a, **k):
        loss.backward()
        self.step()
        return None, None

    # -- state ---------------------------------------------------------------
    def _slice_of(self, p):
        return p if id(p) in self._rest else self._shards[id(p)].view

    def state_dict(self):
        """The inner optimizer's state dict with every moment gathered to
        its parameter's full shape (a collective: every rank of the
        sharding group calls it)."""
        inner = self._inner
        state = {}
        g = self._zg.sharding
        names = _accumulator_names(inner)
        for p in inner._parameter_list:
            name = inner._names[id(p)]
            s = self._slice_of(p)
            if id(p) in self._rest:
                shape, numel, c = self._rest[id(p)]
            else:
                shape, numel, c = tuple(p.shape), p.numel(), \
                    self._shards[id(p)].c
            for acc in names:
                v = inner._accumulators.get((acc, id(s)))
                if v is None:       # an empty slice has no accumulators
                    v = torch.zeros(s.shape, dtype=p.dtype, device=p.device)
                flat = v.reshape(-1)
                pad = c - flat.numel()
                if pad:
                    flat = torch.cat([flat, flat.new_zeros(pad)])
                whole = _all_gather_flat([flat], [numel], g)[0]
                state[f"{name}__{acc}"] = whole.reshape(shape).clone()
        if inner._lr_scheduler is not None:
            state["LR_Scheduler"] = inner._lr_scheduler.state_dict()
        state["@step"] = inner._step_count
        return state

    def set_state_dict(self, state_dict):
        """Load a full (unsharded) state dict: each moment's slice is this
        rank's."""
        inner = self._inner
        by_name = {inner._names[id(p)]: p for p in inner._parameter_list}
        for key, v in state_dict.items():
            if key == "LR_Scheduler" and inner._lr_scheduler is not None:
                inner._lr_scheduler.set_state_dict(v)
            elif key == "@step":
                inner._step_count = int(v)
            elif "__" in key:
                pname, acc = key.rsplit("__", 1)
                p = by_name.get(pname)
                if p is None:
                    continue
                full = torch.as_tensor(v, device=p.device).reshape(-1)
                s = self._slice_of(p)
                if id(p) in self._rest:
                    _, numel, c = self._rest[id(p)]
                    r = self._zg.sharding.rank
                    part = full[r * c:min(numel, (r + 1) * c)]
                    piece = torch.zeros(c, dtype=full.dtype,
                                        device=full.device)
                    piece[:part.numel()] = part
                else:
                    sh = self._shards[id(p)]
                    piece = full[sh.lo:sh.hi]
                inner._accumulators[(acc, id(s))] = piece.clone()


class GroupShardedOptimizerStage2(DygraphShardingOptimizer):
    """Stage 2 (module docstring): the gradients are reduce-scattered into
    this rank's slice."""

    STAGE = 2

    def __init__(self, params=None, optim=None, group=None, offload=False,
                 device=None, grad_compress=None, grad_bucket_mb=None,
                 **kw):
        if params is not None:
            # a parameter SUBSET would silently be ignored: only the
            # optimizer's own full list is sharded
            inner_ids = {id(p) for p in
                         getattr(optim, "_parameter_list", None) or ()}
            if inner_ids and {id(p) for p in params} != inner_ids:
                raise NotImplementedError(
                    "GroupShardedOptimizerStage2 shards the wrapped "
                    "optimizer's full parameter list; passing a different "
                    "params subset is not supported")
        super().__init__(optim, group=group, offload=offload,
                         grad_compress=grad_compress,
                         grad_bucket_mb=grad_bucket_mb)


class _Wrapper(nn.Module):
    """A model wrapper whose parameters are the wrapped model's, under
    their own names."""

    def __init__(self, layer):
        super().__init__()
        self._layers = layer

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def named_parameters(self, prefix="", include_sublayers=True):
        return self._layers.named_parameters(prefix, include_sublayers)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)


def _zero_opt(optimizer):
    while optimizer is not None and \
            not isinstance(optimizer, DygraphShardingOptimizer):
        optimizer = getattr(optimizer, "_inner_opt", None)
    if optimizer is None:
        raise TypeError("the GroupSharded model wrappers need the "
                        "GroupShardedOptimizerStage2 of the same parameters")
    return optimizer


class _Stage2Buckets:
    """GroupShardedStage2's gradient buckets (module docstring): ``params``
    last first, cut into runs of at most ``max_numel`` values."""

    def __init__(self, opt, params, max_numel):
        self.opt = opt
        self.buckets, cur, size = [], [], 0
        for p in reversed(params):
            if cur and size + p.numel() > max_numel:
                self.buckets.append(cur)
                cur, size = [], 0
            cur.append(p)
            size += p.numel()
        if cur:
            self.buckets.append(cur)
        self.index = {id(p): i for i, b in enumerate(self.buckets)
                      for p in b}
        self.ready = [set() for _ in self.buckets]
        self.next = 0              # the bucket to send next
        self.sent = 0              # buckets sent since the last clear_grad

    def on_grad(self, p):
        self.ready[self.index[id(p)]].add(id(p))
        while self.next < len(self.buckets) and \
                len(self.ready[self.next]) == len(self.buckets[self.next]):
            self._send()
        self.next %= len(self.buckets)

    def _send(self):
        opt, bucket = self.opt, self.buckets[self.next]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in bucket]
        for p, s in zip(bucket, _reduce_scatter_flat(grads,
                                                     opt._zg.sharding)):
            sh = opt._shards[id(p)]
            opt._note_grad_shard(p, s[:sh.hi - sh.lo])
            p.grad = None                       # the full gradient is freed
        self.ready[self.next].clear()
        self.next += 1
        self.sent += 1

    def flush_for_step(self):
        """Send the rest of a cycle backward left open, or every bucket
        when none went since the last clear_grad."""
        if self.next == 0 and self.sent and not any(self.ready):
            return
        while self.next < len(self.buckets):
            self._send()
        self.next = 0


class GroupShardedStage2(_Wrapper):
    """Stage-2 model wrapper (module docstring): the gradients are
    reduce-scattered over the sharding group in buckets of at most
    ``buffer_max_size`` values as backward produces them, their slices
    handed to the stage-2 optimizer, the full gradients freed."""

    _grads_in_backward = True

    def __init__(self, layer, sharding_optimizer, group=None,
                 sync_buffers=False, buffer_max_size=2 ** 23,
                 auto_refresh_trainable=True, device=None,
                 grad_compress=None, grad_bucket_mb=None, **kw):
        super().__init__(layer)
        if grad_compress or grad_bucket_mb:
            raise NotImplementedError(
                "grad_compress / grad_bucket_mb on the sharding axis are "
                "not ported to the PyTorch package yet")
        self._opt = _zero_opt(sharding_optimizer)
        params = [p for p in layer.parameters()
                  if p.requires_grad and id(p) in self._opt._shards]
        self._buckets = _Stage2Buckets(self._opt, params,
                                       int(buffer_max_size))
        # the optimizer and the hooks hold the buckets weakly: a strong
        # reference from a parameter's hook back to the wrapper would keep
        # both alive
        self._opt._buckets = mine = weakref.ref(self._buckets)
        self._hooks = [p.register_post_accumulate_grad_hook(
            lambda p: GroupShardedStage2._hook(mine(), p)) for p in params]

    @staticmethod
    def _hook(buckets, p):
        if buckets is not None:
            buckets.on_grad(p)


class _GatherParam(torch.autograd.Function):
    """The whole parameter from its resting [c] slices; the backward
    reduce-scatters the gradient back into the slice."""

    @staticmethod
    def forward(ctx, piece, group, shape, numel):
        ctx.group = group
        return _gather_whole(piece, group, shape, numel)

    @staticmethod
    def backward(ctx, dy):
        return _reduce_scatter_flat([dy.contiguous()], ctx.group)[0], \
            None, None, None


def _gather_whole(piece, group, shape, numel):
    return _all_gather_flat([piece], [numel], group)[0].view(shape)


class GroupShardedStage3(_Wrapper):
    """Stage 3 (module docstring): parameters rest as padded 1/N slices and
    are gathered per block around its forward, and again in backward."""

    _grads_in_backward = True

    def __init__(self, layer, optimizer=None, group=None, sync_buffers=False,
                 device=None, segment_size=2 ** 20, pretrain_sync_models=True,
                 offload=False, **kw):
        super().__init__(layer)
        if offload:
            raise NotImplementedError(
                "offload=True (parameter slices in host memory) is not "
                "ported to the PyTorch package yet")
        opt = _zero_opt(optimizer) if optimizer is not None else None
        self._zg = opt._zg if opt is not None else _ZeroGroups(None, group)
        g = self._zg.sharding
        self._meta = {}           # id(p) -> (owner, name, shape, numel, c)
        self._live = {}           # storage ptr -> p of a gathered whole
        self._all_gathered = False
        if pretrain_sync_models:
            self._sync(layer)
        with torch.no_grad():
            for mod in layer.modules():
                for name, p in list(mod._parameters.items()):
                    if p is None or id(p) in self._meta:
                        continue
                    c = _chunk(p.numel(), g.nranks)
                    flat = _padded_rows(p.data.reshape(-1), g.nranks, c)
                    self._meta[id(p)] = (mod, name, tuple(p.shape),
                                         p.numel(), c)
                    p.data = flat[g.rank].clone()
                    if opt is not None:
                        opt._adopt_resting(p, *self._meta[id(p)][2:])
        self._units = self._blocks(layer)
        # each block's own parameters, fixed now: while a block runs its
        # modules hold the gathered wholes in place of the parameters
        inner = {id(p) for u in self._units[1:] for p in u.parameters()}
        self._unit_params = {
            id(u): [p for p in u.parameters() if id(p) in self._meta
                    and (u is not layer or id(p) not in inner)]
            for u in self._units}
        for unit in self._units[1:]:
            unit.register_forward_pre_hook(
                lambda m, a: self._gather_unit(m))
            unit.register_forward_hook(
                lambda m, a, out: self._release_unit(m))

    @staticmethod
    def _blocks(layer):
        """[the model, each item of its ModuleLists]."""
        items = [m for mod in layer.modules()
                 if isinstance(mod, (nn.ModuleList, nn.Sequential))
                 for m in mod.children()]
        return [layer] + items

    @staticmethod
    def _sync(layer):
        """Every replica starts from the first rank's values: dense
        parameters over the data world, experts over their replicas."""
        from ...parallel import sync_params_buffers
        from ..fleet import live_hcg
        hcg = live_hcg()
        if hcg is None:
            return
        ep = hcg.get_expert_parallel_world_size() > 1
        sync_params_buffers(
            layer, hcg.get_data_world_group(),
            expert_group=hcg.get_expert_replica_group() if ep else None)

    def _gather_unit(self, unit):
        if self._all_gathered:
            return
        g = self._zg.sharding
        for p in self._unit_params[id(unit)]:
            owner, name, shape, numel, _ = self._meta[id(p)]
            whole = _GatherParam.apply(p, g, shape, numel)
            self._live[whole.untyped_storage().data_ptr()] = p
            owner._parameters[name] = whole

    def _release_unit(self, unit):
        if self._all_gathered:
            return
        for p in self._unit_params[id(unit)]:
            owner, name = self._meta[id(p)][:2]
            whole = owner._parameters[name]
            self._live.pop(whole.untyped_storage().data_ptr(), None)
            owner._parameters[name] = p

    def _pack(self, t):
        p = self._live.get(t.untyped_storage().data_ptr()) \
            if t.device.type != "meta" else None
        if p is None:
            return t
        return (p, tuple(t.shape), tuple(t.stride()), t.storage_offset())

    def _unpack(self, packed):
        if isinstance(packed, torch.Tensor):
            return packed
        p, size, stride, offset = packed
        _, _, shape, numel, _ = self._meta[id(p)]
        with torch.no_grad():
            whole = _gather_whole(p.detach(), self._zg.sharding, shape, numel)
        return whole.as_strided(size, stride, offset)

    def forward(self, *inputs, **kwargs):
        if self._all_gathered:
            return self._layers(*inputs, **kwargs)
        with torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                      self._unpack):
            self._gather_unit(self._layers)
            try:
                return self._layers(*inputs, **kwargs)
            finally:
                self._release_unit(self._layers)

    def _whole(self, p):
        _, _, shape, numel, _ = self._meta[id(p)]
        with torch.no_grad():
            return _gather_whole(p.detach(), self._zg.sharding, shape, numel)

    def state_dict(self, *args, **kwargs):
        """The whole state: every parameter gathered (a collective)."""
        sd = self._layers.state_dict(*args, **kwargs)
        if self._all_gathered:
            return sd
        by_id = {id(p): n for n, p in self._layers.named_parameters()}
        for p in self._layers.parameters():
            if id(p) in self._meta:
                sd[by_id[id(p)]] = self._whole(p)
        return sd

    def get_all_parameters(self, convert2cpu=False):
        """Gather every parameter whole into place (the reference's end of
        training: the model then runs unsharded) and return them; with
        ``convert2cpu`` the whole values land in host memory."""
        if not self._all_gathered:
            wholes = {id(p): self._whole(p)
                      for p in self._layers.parameters()
                      if id(p) in self._meta}
            with torch.no_grad():
                for p in self._layers.parameters():
                    if id(p) in wholes:
                        w = wholes[id(p)]
                        p.data = w.cpu() if convert2cpu else w
            self._all_gathered = True
        return list(self._layers.parameters())


def zero_state_bytes(optimizer, model=None):
    """This rank's bytes of optimizer moments, gradients (whole gradients
    in ``.grad``, gradient slices held for the step) and parameters at
    rest."""
    opt = optimizer
    while "_inner_opt" in getattr(opt, "__dict__", {}):
        opt = opt._inner_opt
    inner = getattr(opt, "_inner", opt)
    moments = sum(v.numel() * v.element_size()
                  for v in inner._accumulators.values())
    params = list(model.parameters()) if model is not None \
        else inner._parameter_list
    grads = sum(p.grad.numel() * p.grad.element_size() for p in params
                if p.grad is not None)
    grads += sum(g.numel() * g.element_size()
                 for g in getattr(opt, "_grad_shards", {}).values())
    at_rest = sum(p.numel() * p.element_size() for p in params)
    return {"moments": moments, "grads": grads, "params": at_rest}
