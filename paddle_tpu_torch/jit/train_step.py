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

Capturing the step in a CUDA graph, gradient sync across devices, an
auto-parallel plan and fleet's optimizer wrappers are not ported.
"""
from __future__ import annotations

import torch

from ..framework.device import check_device

__all__ = ["TrainStep"]


class TrainStep:
    def __init__(self, model, loss_fn, optimizer, accum_steps=1,
                 accum_mean=True, master_grad=False, with_outputs=False,
                 grad_sync=None, plan=None):
        if grad_sync is not None:
            raise NotImplementedError("TrainStep(grad_sync=...) is not "
                                      "ported to the PyTorch package yet")
        if plan is not None:
            raise NotImplementedError("TrainStep(plan=...) is not ported "
                                      "to the PyTorch package yet")
        if hasattr(optimizer, "_inner_opt") or \
                hasattr(optimizer, "inner_optimizer"):
            raise NotImplementedError("fleet's optimizer wrappers are not "
                                      "ported to the PyTorch package yet")
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
        self._params = [p for p in model.parameters() if p.requires_grad]
        if not self._params:
            raise ValueError("the model has no trainable parameters")
        self.device = check_device(self._params[0].device)

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
        loss = self.loss_fn(out, *labels).float()
        loss.backward()
        return loss.detach(), out

    def _microbatches(self, xs):
        n = self.accum_steps
        for x in xs:
            if x.shape[0] % n != 0:
                raise ValueError(f"accum_steps {n} must divide the leading "
                                 f"batch dim, got shape {tuple(x.shape)}")
        return [x.chunk(n, dim=0) for x in xs]

    def __call__(self, inputs, labels=()):
        """One step: loss = loss_fn(model(*inputs), *labels), its
        gradients, and one optimizer update. Returns the float32 loss."""
        inputs = self._as_tensors(inputs)
        labels = self._as_tensors(labels)
        self.opt.clear_grad()
        master = None
        if self.accum_steps == 1:
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
        for p in self._params:
            if p.grad is None and (master is None or id(p) not in master):
                # a parameter the loss does not reach: JAX's value_and_grad
                # gives it a zero gradient, and the optimizer still steps it
                p.grad = torch.zeros_like(p)
        self.opt.step(grads=master)
        if self.with_outputs:
            self.last_outputs = torch.cat([o.detach() for o in outs]) \
                if len(outs) > 1 else outs[0].detach()
        return loss
