"""SGD, Momentum, Adam and AdamW (counterpart of
paddle_tpu/optimizer/optimizers.py).

SGD and Momentum are the JAX package's ``_sgd_update`` and
``_momentum_update``: the gradient is cast to the parameter's dtype, the
L2 term ``weight_decay * param`` is folded into it, Momentum keeps a
``velocity`` laid out as its parameter in the parameter's dtype, v = mu v
+ g, and steps by v (or g + mu v with ``use_nesterov``). In float32 the
update runs in place on the parameter and the velocity; other dtypes
compute in float32 and store back.

The update math is the JAX package's ``_adam_update``/``_adamw_update``
exactly: float32 arithmetic whatever the parameter's dtype, moments
stored in ``moment_dtype``, bias correction by ``beta ** t`` with t =
step + 1, and for AdamW a decoupled weight decay p * (1 - lr * lr_ratio *
coeff) applied before the update. The scalars are formed in float32 as
the JAX functions form them (``1 - beta1``, ``lr * lr_ratio``), so a
float32 run agrees with the JAX package up to the rounding of the
element-wise operations. The JAX package has no kernel here (the update
is plain jnp under jax.jit), so neither has the port: the update is a
handful of element-wise PyTorch operations per parameter.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework.device import torch_dtype
from .optimizer import Optimizer

__all__ = ["SGD", "Momentum", "Adam", "AdamW"]

_f32 = np.float32


def _as_dtype(value, dtype):
    """A Python scalar rounded to ``dtype``, as JAX rounds a weak Python
    float that meets an array of that dtype."""
    return float(torch.tensor(value, dtype=dtype))


def _store(dst, value):
    """Write a float32 result back unless it is ``dst`` itself (a float32
    parameter or velocity updated in place)."""
    if value is not dst:
        dst.copy_(value)


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)

    def _apply_one(self, p, g, lr, wd):
        g32 = g.to(p.dtype).float()
        if wd:
            g32 = g32 + p.float() * float(_f32(wd))
        _store(p, p.float().sub_(g32, alpha=float(_f32(lr))))


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _apply_one(self, p, g, lr, wd):
        vel = self._get_accumulator("velocity", p)
        mu = float(_f32(self._momentum))
        g32 = g.to(p.dtype).float()
        if wd:
            g32 = g32 + p.float() * float(_f32(wd))
        v32 = vel.float().mul_(mu).add_(g32)
        upd = g32.add(v32, alpha=mu) if self._use_nesterov else v32
        _store(vel, v32)
        _store(p, p.float().sub_(upd, alpha=float(_f32(lr))))


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None, moment_dtype=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._multi_precision = multi_precision
        # explicit moment storage dtype ("bfloat16" halves optimizer state;
        # the update math stays float32). None keeps float32 moments for
        # bfloat16 parameters.
        self._moment_dtype_override = (
            torch_dtype(moment_dtype) if moment_dtype is not None else None)

    def _moment_dtype(self, p):
        if self._moment_dtype_override is not None:
            return self._moment_dtype_override
        if self._multi_precision or p.dtype == torch.bfloat16:
            return torch.float32
        return p.dtype

    def _moments(self, p):
        dt = self._moment_dtype(p)
        return (dt, self._get_accumulator("moment1", p, dtype=dt),
                self._get_accumulator("moment2", p, dtype=dt))

    def _update(self, p, g32, m, v, lr_scaled, decay):
        """The shared float32 update: p <- p * decay - lr_scaled * mhat /
        (sqrt(vhat) + eps), with the new moments stored in place."""
        t = self._step_plus1
        b1, b2 = _f32(self._beta1), _f32(self._beta2)
        bc1 = _f32(1) - _f32(self._beta1 ** t)
        bc2 = _f32(1) - _f32(self._beta2 ** t)
        m_new = m.float().mul(float(b1)).add_(g32 * float(_f32(1) - b1))
        v_new = v.float().mul(float(b2)).add_(
            g32.mul(float(_f32(1) - b2)).mul_(g32))
        denom = (v_new / float(bc2)).sqrt_().add_(float(_f32(self._eps)))
        step = (m_new / float(bc1)).mul_(float(lr_scaled)).div_(denom)
        p32 = p.float()
        if decay != 1:
            p32 = p32 * float(decay)
        p.copy_(p32 - step)
        m.copy_(m_new)
        v.copy_(v_new)

    def _apply_one(self, p, g, lr, wd):
        dt, m, v = self._moments(p)
        g_dt = g.to(dt)
        if wd:
            g_dt = g_dt + p.to(dt) * _as_dtype(wd, dt)
        self._update(p, g_dt.float(), m, v, _f32(lr), 1)


class AdamW(Adam):
    """Decoupled weight decay. ``apply_decay_param_fun(name)`` returning
    False exempts a parameter; ``lr_ratio(p)`` scales its learning rate.
    A parameter group's ``weight_decay`` does not apply here, as in the JAX
    package: the decay coefficient is AdamW's own."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 moment_dtype=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name,
                         moment_dtype=moment_dtype)
        self._coeff = float(weight_decay) if not callable(weight_decay) \
            else 0.01
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _apply_one(self, p, g, lr, wd):
        dt, m, v = self._moments(p)
        coeff = self._coeff
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(self.param_name(p)):
            coeff = 0.0
        ratio = 1.0 if self._lr_ratio is None else float(self._lr_ratio(p))
        lr_scaled = _f32(lr) * _f32(ratio)
        decay = _f32(1) - lr_scaled * _f32(coeff)
        # the gradient is rounded to the moment dtype first (a bfloat16
        # moment_dtype rounds it to bfloat16), then the math is float32
        self._update(p, g.to(dt).float(), m, v, lr_scaled, decay)
