"""TrainStep: forward, backward and the optimizer in one call (counterpart
of paddle_tpu/jit/train_step.py).

The JAX package traces the whole step into one XLA executable. PyTorch
runs eagerly, so here a step is the same sequence run op by op: drop the
gradients, run the model and the loss, backpropagate, apply the
optimizer. What the JAX step guarantees is kept:

- ``accum_steps > 1`` splits the leading batch dim of every input and
  label into that many microbatches, sums their gradients (divided by
  ``accum_steps`` when ``accum_mean``), applies the optimizer once, and
  returns the mean of the microbatch losses;
- ``master_grad`` keeps the gradients, and their accumulation, in
  float32 for low-precision parameters;
- the returned loss is a float32 tensor on the device: the call does not
  wait for the device;
- the optimizer's learning rate is read on each call (its ``step()``
  calls ``get_lr``), so an LRScheduler the caller steps between calls
  sets each step's rate, and its ``grad_clip`` clips the gradients the
  step hands it, the accumulated float32 master gradients included.

Data parallelism: ``grad_sync`` (a fleet GradBucketScheduler) averages
the gradients over its group, bucket by bucket during the backward; with
``accum_steps > 1`` the hooks stay quiet through the microbatches and the
accumulated gradients are synced once. The scheduler is the argument, or
one built from the gradient-sync config that fleet's
``distributed_optimizer`` carries (its ``grad_compress`` and
``grad_bucket_mb``), or the model wrapper's own (DataParallel,
TensorParallel), in that order of precedence; the one chosen is handed to
the wrapper or hooked on the model. Fleet's optimizer wrapper is
unwrapped, so the step reads and writes the inner optimizer.

Pipeline parallelism: on a model with an internal pipeline (Llama or
GPT with ``pipeline_parallel=True``, bare or inside fleet's wrapper) a
step runs this rank's schedule over the whole batch (the model's
``forward_backward``: its microbatches' forwards and backwards over
send/recv), sums the tied weights' gradients over the first and last
stage, syncs each stage's gradients over its dp group once (the
scheduler above, or one over fleet's dp group), and steps the optimizer
on this rank's parameters. The loss it returns is the batch's, the same
on every rank of the pp group. ``accum_steps``, ``master_grad``,
``with_outputs`` and gradient clipping do not combine with it.

Sharding: with a ZeRO optimizer (fleet/meta_parallel/
sharding_optimizer.py) the optimizer reduces the gradients itself (or
takes the slices GroupShardedStage2 / GroupShardedStage3 reduced in
backward) and steps this rank's slice; ``accum_steps > 1`` over those two
model wrappers is not ported. Under expert parallelism the model wrapper
(DataParallel over the data world) or the sharding optimizer sums the
expert gradients over their replicas.

Auto-parallel: over DTensor parameters (distributed.shard_layer) the
step is the same sequence. The loss is replicated over the mesh before
its backward and returned as this rank's (whole) value; a DTensor input
split over dim 0 is cut into microbatches on each rank's own rows; the
gradients accumulate as backward leaves them (a Partial sum over the
data axis stays pending) and the optimizer lays each out as its
parameter once a step. A parameter that shard_tensor replaces after the
step was built is replaced here too.

Capturing the step in a CUDA graph and an auto-parallel plan
(``plan=``, which waits for the auto-tuner's cost model) are not ported.
"""
from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor

from ..framework.device import check_device
from ..framework.dtensor import register_holder, replicated, swapped

__all__ = ["TrainStep"]


def _chunks(x, n):
    """``x`` cut into ``n`` microbatches along dim 0; a DTensor split over
    dim 0 is cut on each rank's own rows."""
    if not isinstance(x, DTensor) or not any(
            p.is_shard(0) for p in x.placements):
        return x.chunk(n, dim=0)
    rows = x.to_local()
    if rows.shape[0] % n:
        raise ValueError(f"accum_steps {n} must divide each rank's rows, "
                         f"got {rows.shape[0]}")
    shape = torch.Size((x.shape[0] // n,) + tuple(x.shape[1:]))
    stride = torch.empty(shape, device="meta").stride()
    return [DTensor.from_local(c, x.device_mesh, x.placements, shape=shape,
                               stride=stride, run_check=False)
            for c in rows.chunk(n, dim=0)]


def _pipelined(model):
    """The model with an internal pipeline under ``model``'s wrappers, or
    None."""
    while model is not None:
        if getattr(model, "_internal_pipeline", False) and \
                hasattr(model, "forward_backward"):
            return model
        model = getattr(model, "_layers", None)
    return None


class TrainStep:
    def __init__(self, model, loss_fn, optimizer, accum_steps=1,
                 accum_mean=True, master_grad=False, with_outputs=False,
                 grad_sync=None, plan=None):
        if plan is not None:
            raise NotImplementedError("TrainStep(plan=...) is not ported "
                                      "to the PyTorch package yet")
        # fleet's facade carries the strategy's grad-sync config; read it
        # and step the inner optimizer
        gs_cfg = None
        while "_inner_opt" in getattr(optimizer, "__dict__", {}):
            gs_cfg = gs_cfg or optimizer.__dict__.get("_grad_sync_config")
            optimizer = optimizer._inner_opt
        if hasattr(optimizer, "inner_optimizer"):
            raise NotImplementedError("GradientMergeOptimizer is not ported "
                                      "to the PyTorch package yet")
        self.accum_steps = int(accum_steps)
        if self.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.model = model
        self.loss_fn = loss_fn
        self.opt = optimizer
        self.accum_mean = bool(accum_mean)
        self.master_grad = bool(master_grad)
        self.with_outputs = with_outputs
        self.last_outputs = None
        self._named = [(n, p) for n, p in model.named_parameters()
                       if p.requires_grad]
        self._params = [p for _, p in self._named]
        if not self._params:
            raise ValueError("the model has no trainable parameters")
        self.device = check_device(self._params[0].device)
        self._grad_sync = self._grad_sync_of(model, grad_sync, gs_cfg)
        self._pipe = _pipelined(model)
        if self._pipe is not None:
            self._check_pipeline(optimizer)
        if self.accum_steps > 1 and getattr(model, "_grads_in_backward",
                                            False):
            raise NotImplementedError(
                "TrainStep with accum_steps > 1 over a GroupShardedStage2 / "
                "GroupShardedStage3 model (gradients reduce-scattered in "
                "backward) is not ported to the PyTorch package yet")
        register_holder(self)

    def _replace_parameter(self, old, new):
        """Step ``new`` where ``old`` was (shard_tensor on a parameter of
        this step's model)."""
        self._params = swapped(self._params, old, new)
        self._named = [(n, new if p is old else p) for n, p in self._named]

    def _check_pipeline(self, optimizer):
        for what, bad in (("accum_steps > 1", self.accum_steps > 1),
                          ("master_grad", self.master_grad),
                          ("with_outputs", self.with_outputs),
                          ("gradient clipping",
                           getattr(optimizer, "_grad_clip", None)
                           is not None)):
            if bad:
                raise NotImplementedError(
                    f"TrainStep with {what} on a pipeline-parallel model "
                    f"is not ported to the PyTorch package yet")
        if self._grad_sync is None:
            from ..distributed.fleet.grad_buckets import GradBucketScheduler
            dp = self._pipe._pp_stack()._hcg.get_data_parallel_group()
            if dp is not None and dp.nranks > 1:
                self._grad_sync = GradBucketScheduler(self._named, group=dp)

    def _grad_sync_of(self, model, grad_sync, gs_cfg):
        """The scheduler this step syncs through (None: no sync), hooked
        on the model's parameters."""
        from ..distributed.fleet.grad_buckets import GradBucketScheduler
        if grad_sync is not None and \
                not isinstance(grad_sync, GradBucketScheduler):
            raise TypeError(f"grad_sync must be a fleet GradBucketScheduler, "
                            f"got {type(grad_sync).__name__}")
        own = getattr(model, "_grad_sync", None)
        sched = grad_sync
        if sched is None and gs_cfg is not None:
            from ..distributed.fleet.grad_buckets import DEFAULT_BUCKET_MB
            sched = GradBucketScheduler(
                self._named,
                bucket_mb=gs_cfg.get("bucket_mb") or DEFAULT_BUCKET_MB,
                compress=gs_cfg.get("compress"),
                axis=gs_cfg.get("axis", "dp"),
                group=getattr(own, "group", None),
                expert_group=getattr(own, "expert_group", None))
        if sched is None or sched is own:
            return own
        if own is not None:
            model._install_grad_sync(sched)
        else:
            sched.attach(self._named)
        return sched

    def _as_tensors(self, xs):
        if isinstance(xs, torch.Tensor):
            xs = (xs,)
        out = []
        for x in xs:
            t = torch.as_tensor(x, device=self.device) \
                if not isinstance(x, torch.Tensor) else x
            if t.device != self.device:
                raise ValueError(f"an input lies on {t.device}, the model "
                                 f"on {self.device}")
            out.append(t)
        return out

    def _forward_backward(self, inputs, labels):
        out = self.model(*inputs)
        loss = replicated(self.loss_fn(out, *labels).float())
        loss.backward()
        loss = loss.detach()
        return (loss.to_local() if isinstance(loss, DTensor) else loss), out

    def _quiet(self):
        """The microbatches' backward passes sync nothing."""
        if self._grad_sync is None:
            return contextlib.nullcontext()
        return self._grad_sync.disarmed()

    def _microbatches(self, xs):
        n = self.accum_steps
        for x in xs:
            if x.shape[0] % n != 0:
                raise ValueError(f"accum_steps {n} must divide the leading "
                                 f"batch dim, got shape {tuple(x.shape)}")
        return [_chunks(x, n) for x in xs]

    def _pipeline_step(self, inputs, labels):
        """The schedule's forwards and backwards, then the tied and the dp
        gradient sums."""
        with self._quiet():
            loss = self._pipe.forward_backward(inputs, labels, self.loss_fn)
        self._pipe.allreduce_shared_weight_gradients()
        if self._grad_sync is not None:
            self._grad_sync.sync_grads({name: p.grad
                                        for name, p in self._named})
        return loss

    def __call__(self, inputs, labels=()):
        """One step: loss = loss_fn(model(*inputs), *labels), its
        gradients, and one optimizer update. Returns the float32 loss."""
        inputs = self._as_tensors(inputs)
        labels = self._as_tensors(labels)
        self.opt.clear_grad()
        master = None
        if self._pipe is not None:
            loss = self._pipeline_step(inputs, labels)
            outs = []
        elif self.accum_steps == 1:
            # (master_grad changes nothing here: the optimizer casts a
            # bfloat16 gradient to float32 before it uses it)
            loss, out = self._forward_backward(inputs, labels)
            outs = [out]
        else:
            n = self.accum_steps
            mb_in, mb_lab = self._microbatches(inputs), \
                self._microbatches(labels)
            # master_grad: each microbatch's gradient is summed in float32
            # beside the parameter (torch keeps p.grad in p's dtype);
            # otherwise autograd sums them into p.grad in p's dtype
            master = {} if self.master_grad else None
            lsum = torch.zeros((), dtype=torch.float32, device=self.device)
            outs = []
            for i in range(n):
                with self._quiet():
                    loss_i, out = self._forward_backward(
                        [x[i] for x in mb_in], [x[i] for x in mb_lab])
                lsum = lsum + loss_i
                outs.append(out)
                if master is not None:
                    for p in self._params:
                        if p.grad is None:
                            continue
                        g = p.grad.float()
                        master[id(p)] = g if id(p) not in master \
                            else master[id(p)].add_(g)
                        p.grad = None
            loss = lsum / n
            if self.accum_mean:
                for g in (master.values() if master is not None else
                          (p.grad for p in self._params)):
                    if g is not None:
                        g.div_(n)
            if self._grad_sync is not None:
                # the accumulated gradients, synced once
                self._grad_sync.sync_grads(
                    {name: master.get(id(p)) if master is not None
                     else p.grad for name, p in self._named})
        for p in self._params:
            if getattr(self.opt, "_shards_grads", False):
                break       # the sharding optimizer reads None as zeros
            if p.grad is None and (master is None or id(p) not in master):
                # a parameter the loss does not reach: JAX's value_and_grad
                # gives it a zero gradient, and the optimizer still steps it
                p.grad = torch.zeros_like(p)
        self.opt.step(grads=master)
        if self.with_outputs:
            self.last_outputs = torch.cat([o.detach() for o in outs]) \
                if len(outs) > 1 else outs[0].detach()
        return loss
