"""The RNG state tracker of tensor parallelism (counterpart of
paddle_tpu/distributed/fleet/meta_parallel/random_ctrl.py).

Named torch.Generators. Inside ``with tracker.rng_state(name):`` every
dropout of the port draws its mask from that generator instead of its
own: dropout on mp-sharded activations needs a different stream on each
mp rank (``model_parallel_random_seed`` seeds it ``seed + 1024 + 100
mp_rank``, as Paddle's does), while dropout on replicated activations keeps the model's
generator, seeded alike on every rank.
"""
from __future__ import annotations

import contextlib

import torch

from ....framework.device import resolve_device
from ....nn.functional import common as _common

__all__ = ["RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed"]

MODEL_PARALLEL_RNG = "model_parallel_rng"


class RNGStatesTracker:
    def __init__(self):
        self.states_ = {}
        self.seeds_ = set()

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def add(self, name, seed, *, device=None):
        """A generator ``name`` seeded with ``seed`` on ``device`` (the
        card unless the caller asks for the CPU)."""
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already exists")
        if name in self.states_:
            raise ValueError(f"state {name} already exists")
        self.seeds_.add(seed)
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(int(seed))
        self.states_[name] = gen

    def get_states_tracker(self):
        return {k: g.get_state() for k, g in self.states_.items()}

    def set_states_tracker(self, states):
        for k, s in states.items():
            self.states_[k].set_state(s)

    @contextlib.contextmanager
    def rng_state(self, name=MODEL_PARALLEL_RNG):
        if name not in self.states_:
            raise ValueError(f"state {name} does not exist")
        saved = _common._REGION_GENERATOR[0]
        _common._REGION_GENERATOR[0] = self.states_[name]
        try:
            yield
        finally:
            _common._REGION_GENERATOR[0] = saved


_TRACKER = RNGStatesTracker()


def get_rng_state_tracker():
    return _TRACKER


def model_parallel_random_seed(seed=None, *, device=None):
    """Seed the tracker's model-parallel generator with ``seed + 1024 +
    100 * mp_rank`` (the local seed; the reference's at mp rank 0);
    returns the global seed, which the caller gives the model's own
    generator."""
    import random as pyrandom
    from ..fleet import fleet
    seed = seed or pyrandom.getrandbits(32)
    hcg = fleet.get_hybrid_communicate_group()
    mp_rank = hcg.get_model_parallel_rank() if hcg is not None else 0
    _TRACKER.reset()
    _TRACKER.add(MODEL_PARALLEL_RNG, seed + 1024 + 100 * mp_rank,
                 device=device)
    return seed
