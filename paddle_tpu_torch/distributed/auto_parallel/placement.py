"""Placement types: Shard(dim), Replicate() and Partial(reduce_type)
(counterpart of paddle_tpu/distributed/auto_parallel/placement.py).

One placement a mesh dimension, as in Paddle: ``Shard(d)`` splits tensor
dim d over that mesh axis, ``Replicate()`` leaves the axis unused and
``Partial`` marks a pending reduction over it. Each maps one to one onto
torch.distributed.tensor's placement of the same name (``_to_torch``,
``from_torch``), which the DTensors of the port carry.
"""
from __future__ import annotations

from torch.distributed.tensor import placement_types as _tp

__all__ = ["Placement", "Shard", "Replicate", "Partial", "from_torch"]


class Placement:
    def is_shard(self, dim=None):
        return False

    def is_replicate(self):
        return False

    def is_partial(self):
        return False


class Shard(Placement):
    def __init__(self, dim):
        self._dim = int(dim)

    def get_dim(self):
        return self._dim

    @property
    def dim(self):
        return self._dim

    def is_shard(self, dim=None):
        return dim is None or dim == self._dim

    def _to_torch(self):
        return _tp.Shard(self._dim)

    def __eq__(self, other):
        return isinstance(other, Shard) and other._dim == self._dim

    def __hash__(self):
        return hash(("shard", self._dim))

    def __repr__(self):
        return f"Shard(dim={self._dim})"


class Replicate(Placement):
    def is_replicate(self):
        return True

    def _to_torch(self):
        return _tp.Replicate()

    def __eq__(self, other):
        return isinstance(other, Replicate)

    def __hash__(self):
        return hash("replicate")

    def __repr__(self):
        return "Replicate()"


class Partial(Placement):
    def __init__(self, reduce_type="sum"):
        self._reduce_type = getattr(reduce_type, "name", reduce_type) \
            if not isinstance(reduce_type, str) else reduce_type

    @property
    def reduce_type(self):
        return self._reduce_type

    def is_partial(self):
        return True

    def _to_torch(self):
        return _tp.Partial(str(self._reduce_type).lower())

    def __eq__(self, other):
        return (isinstance(other, Partial)
                and other._reduce_type == self._reduce_type)

    def __hash__(self):
        return hash(("partial", self._reduce_type))

    def __repr__(self):
        return f"Partial(reduce_type={self._reduce_type})"


def from_torch(p):
    """The Paddle placement of torch's placement ``p``."""
    if p.is_shard():
        return Shard(p.dim)
    if p.is_partial():
        return Partial(p.reduce_op)
    return Replicate()
