"""Optimizer base (counterpart of paddle_tpu/optimizer/optimizer.py).

Paddle's optimizer on torch parameters: parameter groups with their own
``learning_rate`` and ``weight_decay``, ``get_lr``/``set_lr``, one set of
named accumulators per parameter, ``step()`` (which casts a bfloat16
gradient to float32 first), ``clear_grad``, and a ``state_dict`` keyed
``"<param name>__<accumulator>"`` with the step count under ``"@step"``.

``learning_rate`` may be an ``LRScheduler`` (optimizer/lr.py): ``get_lr``
then reads the scheduler on every call, so each ``step()`` applies the
rate the caller last stepped it to, ``set_lr`` raises, and the state dict
carries the scheduler's state under ``"LR_Scheduler"``. ``grad_clip`` (one
of nn/clip.py's classes) clips the gradients inside ``step()`` before the
update, as the JAX package does.

A parameter's name is its ``param_name`` attribute when it has one (the
port's models name each parameter by its qualified name, as the JAX
TrainStep keys its accumulators); otherwise ``param_<i>`` by position.
Regularizer objects as ``weight_decay`` and per-parameter learning rates
(ParamAttr) are not ported.
"""
from __future__ import annotations

import torch

from ..framework.device import check_device
from ..nn.clip import ClipGradBase
from .lr import LRScheduler

__all__ = ["Optimizer"]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if isinstance(learning_rate, LRScheduler):
            self._lr_scheduler = learning_rate
        elif isinstance(learning_rate, (int, float)):
            self._lr_scheduler = None
        else:
            raise NotImplementedError(
                f"learning_rate must be a float or an LRScheduler of "
                f"optimizer/lr.py, got {type(learning_rate)}")
        if grad_clip is not None and not isinstance(grad_clip, ClipGradBase):
            raise NotImplementedError(
                f"grad_clip must be one of nn/clip.py's classes "
                f"(ClipGradByValue, ClipGradByNorm, ClipGradByGlobalNorm), "
                f"got {type(grad_clip)}")
        if parameters is None:
            raise ValueError("parameters is required: pass "
                             "model.parameters()")
        self._lr = learning_rate
        self._grad_clip = grad_clip
        self._param_groups = self._build_groups(parameters)
        self._weight_decay = self._wd_value(weight_decay)
        self._accumulators = {}
        self._step_count = 0
        self._names = {}
        for i, p in enumerate(self._parameter_list):
            check_device(p.device)
            self._names[id(p)] = getattr(p, "param_name", None) or f"param_{i}"

    # -- groups ------------------------------------------------------------
    def _build_groups(self, parameters):
        params = list(parameters)
        if params and isinstance(params[0], dict):
            return [{"params": list(g["params"]),
                     "learning_rate": g.get("learning_rate", None),
                     "weight_decay": self._wd_value(
                         g.get("weight_decay", None))}
                    for g in params]
        return [{"params": params, "learning_rate": None,
                 "weight_decay": None}]

    @staticmethod
    def _wd_value(wd):
        if wd is None:
            return 0.0
        if isinstance(wd, (int, float)):
            return float(wd)
        raise NotImplementedError(
            "a regularizer weight_decay is not ported to the PyTorch "
            "package yet; pass a float")

    @property
    def _parameter_list(self):
        return [p for g in self._param_groups for p in g["params"]]

    def param_name(self, p):
        return self._names[id(p)]

    # -- lr ----------------------------------------------------------------
    def get_lr(self):
        if self._lr_scheduler is not None:
            return float(self._lr_scheduler())
        return float(self._lr)

    def set_lr(self, value):
        if self._lr_scheduler is not None:
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

    @property
    def _step_plus1(self):
        return self._step_count + 1

    # -- accumulators ------------------------------------------------------
    def _get_accumulator(self, name, param, dtype=None):
        key = (name, id(param))
        if key not in self._accumulators:
            self._accumulators[key] = torch.zeros_like(
                param, dtype=dtype or param.dtype,
                memory_format=torch.contiguous_format)
        return self._accumulators[key]

    def _set_accumulator(self, name, param, value):
        self._accumulators[(name, id(param))] = value

    # -- step --------------------------------------------------------------
    @torch.no_grad()
    def step(self, grads=None):
        """Update every parameter that has a gradient. ``grads``
        ({id(param): tensor}) replaces ``p.grad`` where given: TrainStep's
        float32 master gradients of bfloat16 parameters, which torch does
        not store in ``p.grad``."""
        grads = grads or {}
        pgs = [(p, grads.get(id(p), p.grad), group)
               for group in self._param_groups for p in group["params"]
               if p.requires_grad]
        if self._grad_clip is not None:
            clipped = self._grad_clip([(p, g) for p, g, _ in pgs])
            pgs = [(p, cg, group) for (p, _, group), (_, cg)
                   in zip(pgs, clipped)]
        lr_base = self.get_lr()
        for p, g, group in pgs:
            if g is None:
                continue
            lr = lr_base if group["learning_rate"] is None else float(
                group["learning_rate"])
            wd = group["weight_decay"] \
                if group["weight_decay"] is not None \
                else self._weight_decay
            if g.dtype == torch.bfloat16:
                g = g.float()
            self._apply_one(p, g, lr, wd)
        self._step_count += 1

    def _apply_one(self, p, grad, lr, wd):
        raise NotImplementedError

    def clear_grad(self, set_to_zero=True):
        """Drop every parameter's gradient (the next backward writes a
        fresh one)."""
        for p in self._parameter_list:
            p.grad = None

    clear_gradients = clear_grad

    # -- state -------------------------------------------------------------
    def state_dict(self):
        """A snapshot: the accumulators are copied, since step() updates
        them in place."""
        state = {}
        for (acc, pid), v in self._accumulators.items():
            state[f"{self._names.get(pid, pid)}__{acc}"] = v.clone()
        if self._lr_scheduler is not None:
            state["LR_Scheduler"] = self._lr_scheduler.state_dict()
        state["@step"] = self._step_count
        return state

    def set_state_dict(self, state_dict):
        by_name = {self._names[id(p)]: p for p in self._parameter_list}
        for key, v in state_dict.items():
            if key == "LR_Scheduler" and self._lr_scheduler is not None:
                self._lr_scheduler.set_state_dict(v)
                continue
            if key == "@step":
                self._step_count = int(v)
                continue
            if "__" not in key:
                continue
            pname, acc = key.rsplit("__", 1)
            p = by_name.get(pname)
            if p is not None:
                self._accumulators[(acc, id(p))] = torch.as_tensor(
                    v, device=p.device).clone()
