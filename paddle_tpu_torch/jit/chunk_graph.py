"""Fused decode chunks as CUDA graphs (counterpart of the JAX package's
per-static-shape decode executables: ``PagedDecoder._paged_chunk_state_jit``
and ``CachedDecoder._chunk_jit`` / ``_sample_chunk_jit``).

A chunk of decode steps launches a few hundred kernels from Python. On the
card ``ChunkGraphs.run`` captures it once per static key into a
``torch.cuda.CUDAGraph`` over static device buffers and replays it after
that: one host call a chunk, as the JAX engine dispatches one compiled
executable. The chunk's body reads its state from the static buffers and
advances them in place, so chunk N+1 reads chunk N's outputs with no
upload. On the CPU ``run`` calls the same body eagerly, as the kernels'
plain versions run there.

Capture follows PyTorch's graph rules: each key's chunk is warmed up
eagerly on a side stream first (that builds the kernels and fills the
wrappers' caches), through a ``warmup`` closure that must leave the
engine's state as it found it. Every graph of one ``ChunkGraphs`` shares
one memory pool; a chunk's temporaries are dead when its replay ends, and
replays never overlap (one stream), so the sharing is safe in any order.

Launch counters: the kernel wrappers count on the host when they launch
(``ragged_paged_attention.launches``, ``quant_matmul.route_launches``, the
decoders' ``route_launches``...). Inside a capture nothing launches but
the counters still move. ``ChunkGraphs`` records each counter's change
over the capture, puts every counter back as it was before the warm-up,
and adds the recorded change at every replay, so a count reads as if each
replay had launched its kernels eagerly. The warm-up's launches are
preparation and are not counted.

There is no fallback: a capture or a replay that fails raises.
"""
from __future__ import annotations

import time

import torch

__all__ = ["ChunkGraphs"]


def _snapshot(counters):
    """{(i, key): value} of every counter: ``holder.name`` of counters[i]
    is an int (key None) or a dict of ints. Holders are re-read on every
    call, so a counter dict the caller replaced is followed."""
    out = {}
    for i, (holder, name) in enumerate(counters):
        val = getattr(holder, name)
        if isinstance(val, dict):
            for k, v in val.items():
                out[(i, k)] = v
        else:
            out[(i, None)] = val
    return out


def _add(counters, deltas, sign=1):
    for (i, k), d in deltas.items():
        if not d:
            continue
        holder, name = counters[i]
        if k is None:
            setattr(holder, name, getattr(holder, name) + sign * d)
        else:
            getattr(holder, name)[k] += sign * d


class ChunkGraphs:
    """One CUDA graph per static key of one engine, all in one memory
    pool. ``counters()`` lists the (holder, attribute name) pairs of the
    launch counters a chunk moves, always in the same order; the graphs
    keep no reference to a holder. ``captured`` is the number of graphs
    captured, ``capture_s`` the seconds spent warming up and capturing
    them, and ``replays`` the replays."""

    def __init__(self, device, counters):
        self.device = torch.device(device)
        self.counters = counters
        self._graphs = {}
        self._pool = None
        self.captured = 0
        self.capture_s = 0.0
        self.replays = 0

    def clear(self):
        """Drop every graph (their buffers' addresses are no longer the
        engine's)."""
        self._graphs.clear()
        self._pool = None

    def run(self, key, body, warmup):
        """Run one chunk: on the card, replay the graph of ``key``
        (capturing ``body`` first if there is none) and return the outputs
        ``body`` returned at capture, which each replay overwrites; on the
        CPU, call ``body()`` and return its outputs."""
        if self.device.type != "cuda":
            return body()
        ent = self._graphs.get(key)
        if ent is None:
            ent = self._capture(body, warmup)
            self._graphs[key] = ent
        graph, outs, delta = ent
        graph.replay()
        _add(self.counters(), delta)
        self.replays += 1
        return outs

    def _capture(self, body, warmup):
        t0 = time.perf_counter()
        counters = self.counters()
        before = _snapshot(counters)
        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            warmup()
        torch.cuda.current_stream(self.device).wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        mid = _snapshot(counters)
        with torch.cuda.graph(graph, pool=self._pool):
            outs = body()
        after = _snapshot(counters)
        delta = {k: after[k] - mid.get(k, 0) for k in after}
        # the warm-up and the capture launched nothing the caller asked for
        _add(counters, {k: after[k] - before.get(k, 0) for k in after},
             sign=-1)
        torch.cuda.synchronize(self.device)
        self.captured += 1
        self.capture_s += time.perf_counter() - t0
        return graph, outs, delta
