"""The rendezvous key-value store (counterpart of
paddle_tpu/distributed/store.py's ``TCPStore``).

A thin class over ``torch.distributed.TCPStore``: the reference's
``set`` / ``get`` / ``add`` / ``wait`` / ``check`` / ``delete_key`` /
``num_keys`` and its counting ``barrier``, with a missing key raising
TimeoutError after the timeout as the reference's does. The server is
torch's; ``is_master=True`` hosts it in this process, and port 0 asks for
a free port (``.port`` gives the one taken).
"""
from __future__ import annotations

import datetime

import torch.distributed as dist

__all__ = ["TCPStore"]


def _delta(seconds):
    return datetime.timedelta(seconds=float(seconds))


class TCPStore:
    """Master/client store with blocking ``wait`` and ``barrier``."""

    def __init__(self, host="127.0.0.1", port=0, is_master=False,
                 world_size=1, timeout=300.0, use_native=None):
        if use_native:
            raise NotImplementedError(
                "TCPStore(use_native=True): the native store server is not "
                "ported; the store is torch.distributed.TCPStore")
        if not is_master and port == 0:
            raise ValueError("client TCPStore needs an explicit port")
        self.world_size = int(world_size)
        self.timeout = float(timeout)
        self.host = host
        self._store = dist.TCPStore(host, int(port), self.world_size,
                                    bool(is_master), _delta(timeout),
                                    wait_for_workers=False)
        self.port = self._store.port

    @property
    def store(self):
        """The torch store, for ``init_process_group(store=...)``."""
        return self._store

    def _wait(self, key, timeout):
        tmo = self.timeout if timeout is None else timeout
        try:
            self._store.wait([key], _delta(tmo))
        except RuntimeError as e:          # torch's DistStoreError
            raise TimeoutError(f"store wait({key!r}) timed out") from e

    def set(self, key, value):
        self._store.set(key, value.encode() if isinstance(value, str)
                        else bytes(value))

    def get(self, key, timeout=None):
        self._wait(key, timeout)
        return self._store.get(key)

    def add(self, key, delta=1):
        return int(self._store.add(key, int(delta)))

    def wait(self, key, timeout=None):
        self._wait(key, timeout)

    def check(self, key):
        return bool(self._store.check([key]))

    def delete_key(self, key):
        self._store.delete_key(key)

    def num_keys(self):
        return int(self._store.num_keys())

    def barrier(self, name="default", timeout=None):
        """Counting barrier across ``world_size`` participants."""
        arrived = self.add(f"__barrier/{name}/count", 1)
        if arrived == self.world_size:
            self.set(f"__barrier/{name}/release", b"1")
        self.wait(f"__barrier/{name}/release", timeout)

    def close(self):
        self._store = None
