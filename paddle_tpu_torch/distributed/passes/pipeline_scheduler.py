"""Pipeline schedule generators and their dependency simulator (the
port's own copy of paddle_tpu/distributed/passes/pipeline_scheduler.py).

Reference: python/paddle/distributed/passes/pipeline_scheduler_pass/
(pipeline_fthenb.py, pipeline_1f1b.py:38, pipeline_eager_1f1b.py,
pipeline_vpp.py, pipeline_zero_bubble.py:32). The schedules are explicit
per-rank instruction streams; the port's pipeline executor
(fleet/meta_parallel/pipeline_spmd.py) runs ``OneFOneB`` or
``InterleavedOneFOneB`` streams rank by rank over send/recv, and the
simulator checks a stream's dependencies and counts its bubble slots.

Instruction = (kind, microbatch, chunk) with kind in {"F", "B", "W"}:
F = forward, B = backward-input (activation grad), W = backward-weight.
Plain schedules fuse W into B (W list empty).
"""
from __future__ import annotations

from collections import namedtuple

__all__ = ["PipelineSchedule", "FThenB", "OneFOneB", "Eager1F1B",
           "InterleavedOneFOneB", "ZeroBubbleH1", "simulate_schedule",
           "F", "B", "W"]

Instr = namedtuple("Instr", ["kind", "microbatch", "chunk"])


def F(m, chunk=0):
    return Instr("F", m, chunk)


def B(m, chunk=0):
    return Instr("B", m, chunk)


def W(m, chunk=0):
    return Instr("W", m, chunk)


class PipelineSchedule:
    """Base: subclasses emit the per-rank instruction stream."""

    name = "base"
    splits_backward = False  # True when B/W are separate (zero-bubble)

    def __init__(self, num_stages, num_micro, num_chunks=1):
        self.num_stages = int(num_stages)
        self.num_micro = int(num_micro)
        self.num_chunks = int(num_chunks)

    def rank_instructions(self, rank):
        raise NotImplementedError

    def all_instructions(self):
        return [self.rank_instructions(r) for r in range(self.num_stages)]


class FThenB(PipelineSchedule):
    """All forwards, then all backwards (reference pipeline_fthenb.py).
    Peak activation memory = M in-flight microbatches."""

    name = "FThenB"

    def rank_instructions(self, rank):
        M = self.num_micro
        return [F(m) for m in range(M)] + [B(m) for m in range(M)]


class OneFOneB(PipelineSchedule):
    """1F1B (reference pipeline_1f1b.py:38): rank r runs S-r warmup
    forwards, then alternates 1F/1B, then drains backwards. Peak
    in-flight microbatches = S - r (not M)."""

    name = "1F1B"

    def _warmup(self, rank):
        return min(self.num_stages - rank, self.num_micro)

    def rank_instructions(self, rank):
        M = self.num_micro
        warmup = self._warmup(rank)
        instrs = [F(m) for m in range(warmup)]
        fwd_next, bwd_next = warmup, 0
        while bwd_next < M:
            instrs.append(B(bwd_next))
            bwd_next += 1
            if fwd_next < M:
                instrs.append(F(fwd_next))
                fwd_next += 1
        return instrs


class Eager1F1B(OneFOneB):
    """Eager-1F1B (reference pipeline_eager_1f1b.py): one extra warmup
    forward per rank vs 1F1B (min(S - rank + 1, M)), trading a bit of
    activation memory for earlier steady state."""

    name = "Eager1F1B"

    def _warmup(self, rank):
        return min(self.num_stages - rank + 1, self.num_micro)


class InterleavedOneFOneB(PipelineSchedule):
    """Interleaved VPP (reference pipeline_vpp.py + Megatron interleaved
    1F1B): each rank owns `num_chunks` model chunks; warmup forwards run
    chunk-major in groups of S so chunk c of microbatch m runs before
    chunk c+1. M must be divisible by S (reference asserts the same)."""

    name = "VPP"

    def rank_instructions(self, rank):
        S, M, V = self.num_stages, self.num_micro, self.num_chunks
        if M % S != 0:
            raise ValueError("interleaved schedule needs M % S == 0")
        total = M * V

        def fwd_seq():
            # microbatch groups of S, cycling chunks: (g0,c0),(g0,c1)...
            order = []
            for g in range(0, M, S):
                for c in range(V):
                    for m in range(g, min(g + S, M)):
                        order.append((m, c))
            return order

        fwd = fwd_seq()
        bwd = [(m, V - 1 - c) for (m, c) in fwd]  # mirror order
        warmup = min((S - rank - 1) * 2 + (V - 1) * S + 1, total)
        instrs = [F(m, c) for m, c in fwd[:warmup]]
        fi, bi = warmup, 0
        while bi < total:
            if fi < total:
                instrs.append(B(*bwd[bi]))
                bi += 1
                instrs.append(F(*fwd[fi]))
                fi += 1
            else:
                instrs.append(B(*bwd[bi]))
                bi += 1
        return instrs


class ZeroBubbleH1(PipelineSchedule):
    """Zero-bubble ZB-H1 (reference pipeline_zero_bubble.py:32, Qi et al.
    2023): backward is split into B (input grad, on the critical path)
    and W (weight grad, fills bubbles). Warmup like 1F1B; W instructions
    are emitted as soon as their B is done but only where a bubble would
    sit — trailing Ws fill the drain phase."""

    name = "ZBH1"
    splits_backward = True

    def rank_instructions(self, rank):
        S, M = self.num_stages, self.num_micro
        warmup = min(S - rank, M)
        instrs = [F(m) for m in range(warmup)]
        fwd_next, bwd_next, w_next = warmup, 0, 0
        while bwd_next < M:
            instrs.append(B(bwd_next))
            bwd_next += 1
            if fwd_next < M:
                instrs.append(F(fwd_next))
                fwd_next += 1
            elif w_next < bwd_next - 1:
                # drain phase: fill the would-be bubble with a weight grad
                instrs.append(W(w_next))
                w_next += 1
        while w_next < M:
            instrs.append(W(w_next))
            w_next += 1
        return instrs


def simulate_schedule(schedule):
    """Dependency-checked simulation: every instruction takes 1 tick; a
    rank executes its stream strictly in order, waiting until deps are
    ready. Deps: F(m,c) on rank r needs F(m,c) on r-1 (or F(m,c-1) on
    rank S-1 for the VPP wrap); B(m,c) on r needs B(m,c) on r+1 (or
    B(m,c+1) on rank 0 for the wrap) plus the local F(m,c); W(m,c) needs
    the local B(m,c). Returns dict(makespan, bubble_ratio, peak_inflight)
    and raises on deadlock — the validity oracle for every schedule.
    """
    S = schedule.num_stages
    streams = schedule.all_instructions()
    pos = [0] * S
    done = set()  # (kind, m, c, rank)
    t = 0
    busy = [0] * S
    peak_inflight = [0] * S
    inflight = [0] * S
    V = schedule.num_chunks

    def deps_ready(instr, rank):
        k, m, c = instr
        if k == "F":
            if rank == 0 and c == 0:
                return True
            if rank == 0:
                return ("F", m, c - 1, S - 1) in done
            return ("F", m, c, rank - 1) in done
        if k == "B":
            local_f = ("F", m, c, rank) in done
            if not local_f:
                return False
            if rank == S - 1 and c == V - 1:
                return True
            if rank == S - 1:
                return ("B", m, c + 1, 0) in done
            return ("B", m, c, rank + 1) in done
        # W
        return ("B", m, c, rank) in done

    total_instrs = sum(len(s) for s in streams)
    while len(done) < total_instrs:
        executed = []
        for r in range(S):
            if pos[r] >= len(streams[r]):
                continue
            instr = streams[r][pos[r]]
            if deps_ready(instr, r):
                executed.append((r, instr))
        if not executed:
            pending = [(r, streams[r][pos[r]]) for r in range(S)
                       if pos[r] < len(streams[r])]
            raise RuntimeError(f"schedule deadlock at t={t}: {pending}")
        for r, instr in executed:
            done.add((instr.kind, instr.microbatch, instr.chunk, r))
            pos[r] += 1
            busy[r] += 1
            if instr.kind == "F":
                inflight[r] += 1
                peak_inflight[r] = max(peak_inflight[r], inflight[r])
            elif instr.kind == "B" and not schedule.splits_backward:
                inflight[r] -= 1
            elif instr.kind == "W":
                inflight[r] -= 1
        t += 1
    makespan = t
    total_busy = sum(busy)
    bubble = makespan * S - total_busy
    return {
        "makespan": makespan,
        "bubble_slots": bubble,
        "bubble_ratio": bubble / float(makespan * S),
        "peak_inflight": peak_inflight,
    }
