"""Device resolution and seeded generators for the PyTorch port.

Counterpart of paddle_tpu/framework/device.py and framework/random.py.
The port runs on a CUDA card by default: an entry point given no device
resolves to ``cuda`` and raises when there is no card, so a run never
continues on the CPU by accident. The CPU is used only when a caller asks
for it (``device="cpu"``), as the tests do; there every kernel wrapper
takes its plain PyTorch version.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "check_device", "seed", "torch_dtype"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device=None):
    """The torch.device an entry point runs on: ``device`` when given,
    else ``cuda``. Raises RuntimeError when ``cuda`` is asked for (or
    implied) and no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def check_device(device):
    """Raise unless ``device`` is the CPU or a CUDA card that is present:
    code that receives tensors (an optimizer, a train step) runs where
    they lie, and only those two places have the port's kernels or their
    plain versions."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type == "cuda":
        return resolve_device(dev)
    raise RuntimeError(f"the port runs on a CUDA card, or on the CPU when "
                       f"asked (device='cpu'); got a tensor on {dev}")


def seed(seed_val, device=None):
    """A torch.Generator on ``device`` (default ``cuda``; raises without a
    card unless ``device="cpu"``) seeded with ``seed_val`` (the port
    passes generators explicitly instead of a global key)."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed_val))
    return gen


def torch_dtype(name):
    """torch dtype of a config dtype name ("float32" or "bfloat16")."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; the port serves "
                         f"float32 and bfloat16") from None
