"""Deterministic, seeded fault injection (counterpart of
paddle_tpu/resilience/faults.py).

A named injection site is a one-line hook (``faults.fire("logits_poison")``)
that is a no-op until a fault plan is installed. A plan gives each site a
firing probability, a half-open invocation window and an optional cap:

    {"seed": 7,
     "sites": {"logits_poison": {"p": 0.25, "window": [0, 40],
                                 "max_fires": 3}}}

Whether invocation ``n`` of a site fires is a pure function of (seed,
site, n) (sha256 -> uniform in [0, 1)), not of the clock, the threads or
the order of calls across sites: the same seed and plan give the same
schedule on every run, and the same one as the JAX package's harness.
``schedule()`` lists the firings so far as (site, n) pairs.

``KNOWN_SITES`` are the reference's registry, so one plan reads the same
in both packages; a plan that names any other site raises. The port's
serving loop hooks ``logits_poison`` (one coin a live slot a decode
dispatch); the registry counters and trace spans of a firing, and the
``FLAGS_fault_plan`` pickup, wait for the port's observability and flags
modules: install a plan with ``install_plan``.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading

__all__ = ["KNOWN_SITES", "InjectedFault", "SitePlan", "FaultPlan",
           "FaultInjector", "install_plan", "clear", "reset", "active",
           "plan", "fire", "inject", "counts", "schedule"]

KNOWN_SITES = frozenset((
    "paged_kv_alloc", "headroom_pressure", "prefill_chunk",
    "decode_chunk", "logits_poison", "ckpt_shard_write",
    "compile_cache_read", "collective_dispatch", "watchdog_heartbeat",
    "jsonl_write", "flight_write",
))


class InjectedFault(RuntimeError):
    """An injected (not organic) failure."""


class SitePlan:
    """One site's firing policy: probability ``p`` over the half-open
    invocation window [window[0], window[1]), capped at ``max_fires``."""

    __slots__ = ("p", "lo", "hi", "max_fires")

    def __init__(self, p=1.0, window=None, max_fires=None):
        self.p = float(p)
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"p must be in [0, 1], got {self.p}")
        lo, hi = window if window is not None else (0, 1 << 62)
        self.lo, self.hi = int(lo), int(hi)
        if self.lo < 0 or self.hi < self.lo:
            raise ValueError(f"bad window [{lo}, {hi})")
        self.max_fires = None if max_fires is None else int(max_fires)

    def to_dict(self):
        return {"p": self.p, "window": [self.lo, self.hi],
                "max_fires": self.max_fires}


class FaultPlan:
    """seed + {site: SitePlan}; a site outside KNOWN_SITES raises."""

    def __init__(self, sites, seed=0):
        self.seed = int(seed)
        self.sites = {}
        for name, sp in dict(sites).items():
            if name not in KNOWN_SITES:
                raise ValueError(
                    f"unknown fault site {name!r}; registered sites: "
                    f"{sorted(KNOWN_SITES)}")
            if not isinstance(sp, SitePlan):
                sp = SitePlan(**dict(sp))
            self.sites[name] = sp

    @classmethod
    def parse(cls, spec, seed=None):
        """A dict, inline JSON or the path of a JSON file: the document
        {"seed": int, "sites": {...}} or a bare {site: policy} mapping.
        ``seed``, when given, overrides the document's."""
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, str):
            if os.path.exists(spec):
                with open(spec) as f:
                    spec = json.load(f)
            else:
                spec = json.loads(spec)
        if not isinstance(spec, dict):
            raise ValueError(f"fault plan must be a dict, got "
                             f"{type(spec).__name__}")
        if "sites" in spec:
            doc_seed = spec.get("seed", 0)
            sites = spec["sites"]
        else:
            doc_seed = 0
            sites = spec
        return cls(sites, seed=doc_seed if seed is None else seed)

    def to_dict(self):
        return {"seed": self.seed,
                "sites": {k: v.to_dict() for k, v in self.sites.items()}}


def _decision(seed, site, n):
    """The deterministic coin: uniform in [0, 1) from (seed, site, n)."""
    h = hashlib.sha256(f"{seed}|{site}|{n}".encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


class FaultInjector:
    """One plan's firing state: each site's invocation count, its fires
    and the schedule. Thread-safe; a decision depends only on (site,
    invocation index)."""

    def __init__(self, plan):
        self.plan = plan if isinstance(plan, FaultPlan) \
            else FaultPlan.parse(plan)
        self._lock = threading.Lock()
        self._invocations = {}
        self._fires = {}
        self._schedule = []

    def fire(self, site):
        """Advance ``site``'s invocation count and return whether this
        invocation fires under the plan."""
        if site not in KNOWN_SITES:
            raise ValueError(f"unknown fault site {site!r}")
        sp = self.plan.sites.get(site)
        with self._lock:
            n = self._invocations.get(site, 0)
            self._invocations[site] = n + 1
            if sp is None or not sp.lo <= n < sp.hi:
                return False
            fired = self._fires.get(site, 0)
            if sp.max_fires is not None and fired >= sp.max_fires:
                return False
            if _decision(self.plan.seed, site, n) >= sp.p:
                return False
            self._fires[site] = fired + 1
            self._schedule.append((site, n))
        return True

    def counts(self):
        with self._lock:
            return dict(self._fires)

    def invocations(self):
        with self._lock:
            return dict(self._invocations)

    def schedule(self):
        with self._lock:
            return list(self._schedule)

    def reset(self):
        """Zero the counts and the schedule, keeping the plan."""
        with self._lock:
            self._invocations.clear()
            self._fires.clear()
            del self._schedule[:]


# the process-wide plan every site hook reads
_LOCK = threading.Lock()
_INJECTOR = [None]


def install_plan(spec, seed=None):
    """Install a fault plan process-wide; returns its FaultInjector."""
    inj = FaultInjector(FaultPlan.parse(spec, seed=seed))
    with _LOCK:
        _INJECTOR[0] = inj
    return inj


def clear():
    """Remove the installed plan: every site reads clean again."""
    with _LOCK:
        _INJECTOR[0] = None


def reset():
    """Reset the installed plan's counts and schedule (no-op without
    one)."""
    inj = _INJECTOR[0]
    if inj is not None:
        inj.reset()


def active():
    return _INJECTOR[0] is not None


def plan():
    """The installed FaultPlan, or None."""
    inj = _INJECTOR[0]
    return None if inj is None else inj.plan


def fire(site):
    """The site hook: False with no plan installed."""
    inj = _INJECTOR[0]
    if inj is None:
        return False
    return inj.fire(site)


def inject(site, exc=InjectedFault):
    """Raise ``exc`` when ``site`` fires this invocation."""
    if fire(site):
        raise exc(f"injected fault at site {site!r}")


def counts():
    inj = _INJECTOR[0]
    return inj.counts() if inj is not None else {}


def schedule():
    inj = _INJECTOR[0]
    return inj.schedule() if inj is not None else []
