"""Admission queue for the serving loop (counterpart of
paddle_tpu/serving/scheduler.py's AdmissionQueue; the replay tracker of
the fault-recovery path is not ported)."""
from __future__ import annotations

__all__ = ["AdmissionQueue"]


class AdmissionQueue:
    """Arrival-ordered admission queue. Entries are
    ``(req_id, prompt, max_new, arrival_rel_s)`` quads where arrival is
    relative to ``t_start`` (serve entry). The pop side is the list tail
    (the queue is kept sorted by arrival descending), so admission pops
    in arrival order in O(1)."""

    def __init__(self, t_start):
        self.t_start = float(t_start)
        self._q = []

    def load(self, requests, default_max_new):
        """Normalize (rid, prompt[, max_new[, arrival_s]]) records and
        load them arrival-sorted. Returns the quads in arrival order."""
        quads = []
        for r in requests:
            mnt = r[2] if len(r) > 2 else default_max_new
            arr = float(r[3]) if len(r) > 3 else 0.0
            quads.append((r[0], r[1], mnt, arr))
        quads.sort(key=lambda q: q[3])      # stable: FIFO within a tie
        self._q = list(reversed(quads))
        return quads

    def push(self, rid, prompt, max_new, arrival_rel):
        self._q.append((rid, prompt, max_new, float(arrival_rel)))
        self._q.sort(key=lambda q: q[3], reverse=True)

    def head(self):
        return self._q[-1] if self._q else None

    def pop(self):
        return self._q.pop()

    def shed(self, now, *, never_fits, admission_timeout_s,
             reject_oversized, reject):
        """Pop and reject doomed arrived heads (can never fit, or queued
        past the admission timeout) so one doomed request cannot wedge
        the queue behind it; leaves the first viable or still-future
        head in place."""
        while self._q:
            rid, prompt, mnt, arr = self._q[-1]
            if self.t_start + arr > now:
                return                   # open loop: not arrived yet
            if reject_oversized and never_fits(prompt, mnt):
                self._q.pop()
                reject(rid, "rejected_oversized", now)
                continue
            if (admission_timeout_s is not None
                    and now - (self.t_start + arr)
                    > admission_timeout_s):
                self._q.pop()
                reject(rid, "rejected_timeout", now)
                continue
            return

    def __len__(self):
        return len(self._q)

    def __bool__(self):
        return bool(self._q)

    def __iter__(self):
        return iter(self._q)
