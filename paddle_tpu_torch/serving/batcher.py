"""Continuous-batching serve loop (counterpart of
paddle_tpu/serving/batcher.py's ``serve_loop``).

Requests queue in arrival order; free slots admit them while the block
pool holds their whole run (prompt + budget), each admission prefills its
prompt into the slot's pages through a bucketed prefill (the prompt padded
to the next power-of-two multiple of block_size, capped at max_len, the
padding written into the trash block), and the live slots then decode
together in fused greedy chunks of min(chunk, largest remaining budget)
steps. A slot retires at its eos or when its budget is spent, and its
blocks return to the pool.

Zero-sync decode, as in the JAX engine: the batch state (tokens, lengths,
tables, liveness, budgets, poison) lives in the engine's static device
buffers (``PagedDecoder.decode_state``), and each chunk
(``PagedDecoder.dispatch_chunk_state``, one CUDA graph replay on the card)
advances it in place, retiring slots at eos or budget on the device. The
host mirrors below change only when the batch changes in a way the device
cannot see (an admission, or a lookahead chunk trimmed to the serial
length); ``mark_state_dirty`` then drains the device state and the next
dispatch uploads the six mirrors (``eng.h2d_uploads``,
``eng.pipeline_drains``). With the lookahead on (``pipeline`` None or
True), chunk N+1 is dispatched off the device state before chunk N's
tokens are consumed, so the host's bookkeeping overlaps the device's
work. Each chunk's tokens and non-finite flags are copied into one of two
pinned host buffers behind it, with an event, and the host waits on that
event only when it consumes the chunk. The token streams equal the
serial loop's (``pipeline=False``) by construction: the fed-back tokens
are the ones the device wrote, and the streams do not depend on how the
steps are cut into chunks.

Not ported: speculative decoding, the prefix cache, streamed admission
(``feed``), fault recovery, telemetry. Their arguments raise unless they
hold their off value; a chunk whose logits go non-finite raises
FloatingPointError, as a prefill's does (there is no quarantine).

``eng.serve_stats`` holds host-clock timings of the last call: per-request
time to first token (from arrival to the prefill's first token on the
host), the seconds spent in prefill (ending in its first token's read)
and in decode (dispatching, waiting on and committing chunks, net of
graph capture), the device decode steps and chunks, and the graphs
captured and the seconds spent capturing them.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .scheduler import AdmissionQueue

__all__ = ["serve_loop"]

# the JAX engine's fault-recovery arguments and their defaults; any other
# value raises until the fault-recovery slice is ported
_RECOVERY_DEFAULTS = (("max_restarts", 3), ("evict_after_deferrals", 2),
                      ("max_deferrals", 8), ("replay_backoff_s", 0.05),
                      ("max_chunk_retries", 8))


def serve_loop(eng, requests, *, max_new_tokens=32, eos_token_id=None,
               chunk=8, pad_token_id=0, admission_timeout_s=None,
               reject_oversized=False, spec_decode=None,
               max_restarts=3, evict_after_deferrals=2,
               max_deferrals=8, replay_backoff_s=0.05,
               max_chunk_retries=8, feed=None, feed_active=None,
               pipeline=None):
    """The continuous-batching loop; ``eng`` is the PagedDecoder. See
    ``PagedDecoder.serve`` for the request forms and the result."""
    from ..models.paged_decode import _Slot
    for name, val in (("spec_decode", spec_decode), ("feed", feed),
                      ("feed_active", feed_active)):
        if val is not None:
            raise NotImplementedError(
                f"serve({name}=...) is not ported to the PyTorch package "
                f"yet")
    given = dict(max_restarts=max_restarts,
                 evict_after_deferrals=evict_after_deferrals,
                 max_deferrals=max_deferrals,
                 replay_backoff_s=replay_backoff_s,
                 max_chunk_retries=max_chunk_retries)
    for name, default in _RECOVERY_DEFAULTS:
        if given[name] != default:
            raise NotImplementedError(
                f"serve({name}={given[name]!r}): fault recovery is not "
                f"ported to the PyTorch package yet; leave it at "
                f"{default!r}")
    lookahead_on = pipeline is not False
    dev = eng.device
    on_card = dev.type == "cuda"
    t_start = time.perf_counter()
    queue = AdmissionQueue(t_start)
    queue.load(requests, max_new_tokens)
    kpool, vpool = eng.serve_pools()
    results = {}
    S = eng.max_slots
    bs = eng.block_size
    MB = eng.blocks_per_seq
    tokens = np.zeros(S, np.int32)
    seqlens = np.zeros(S, np.int32)
    tables = np.zeros((S, MB), np.int32)
    live = np.zeros(S, bool)
    no_poison = np.zeros(S, bool)
    eos_dev = -1 if eos_token_id is None else int(eos_token_id)
    graphs = eng._chunk_graphs
    captured0, capture_s0 = graphs.captured, graphs.capture_s
    stats = {"first_token_s": {}, "prefill_s": 0.0, "decode_s": 0.0,
             "decode_steps": 0, "chunks": 0, "graphs_captured": 0,
             "capture_s": 0.0}
    eng.serve_stats = stats
    # the device state is valid until a composition change drains it;
    # pending holds the lookahead chunk not yet consumed
    state = {"valid": False}
    pending = [None]
    # two pinned host buffers for a chunk's tokens and flags: chunk N's
    # are read while chunk N+1's copy lands in the other
    pin = on_card
    host_toks = [torch.empty(S * max(int(chunk), 1), dtype=torch.int32,
                             pin_memory=pin) for _ in range(2)]
    host_bad = [torch.empty(S, dtype=torch.bool, pin_memory=pin)
                for _ in range(2)]

    def blocks_needed(length):
        return -(-length // bs)

    def never_fits(prompt, mnt):
        total = len(prompt) + mnt
        return (total > eng.max_len
                or blocks_needed(total) > eng.num_blocks - 1)

    def reject(rid, cause, now):
        results[rid] = []
        eng.rejected_requests[cause] = \
            eng.rejected_requests.get(cause, 0) + 1

    def finalize_tokens(toks):
        if eos_token_id is not None and eos_token_id in toks:
            cut = toks.index(eos_token_id)
            toks = toks[:cut + 1] + \
                [pad_token_id] * (len(toks) - cut - 1)
        return toks

    def retire(i):
        s = eng._slots[i]
        results[s.req_id] = finalize_tokens(s.emitted)
        eng.allocator.free(s.blocks)
        eng._slots[i] = _Slot(done=True)
        tables[i] = 0
        live[i] = False

    def advance(i, emit):
        """Commit ``emit`` tokens to slot i after a decode chunk."""
        s = eng._slots[i]
        take = len(emit)
        s.emitted.extend(emit)
        s.budget -= take
        seqlens[i] += take
        tokens[i] = emit[-1]
        hit_eos = (eos_token_id is not None
                   and eos_token_id in s.emitted)
        if s.budget <= 0 or hit_eos:
            retire(i)

    def mark_state_dirty():
        """Drain the device state after a batch change the device cannot
        see: the next dispatch uploads the host mirrors. Retirements at
        eos or budget need none: the chunk retires those slots itself."""
        if state["valid"]:
            state["valid"] = False
            eng.pipeline_drains += 1

    def wait_pending():
        """Wait for the lookahead chunk in flight (billed to decode), so
        that a prefill's time is its own."""
        rec = pending[0]
        if rec is not None and rec["event"] is not None:
            t0 = time.perf_counter()
            rec["event"].synchronize()
            stats["decode_s"] += time.perf_counter() - t0

    def admit(i, req_id, prompt, max_new, arrival):
        mark_state_dirty()
        prompt = list(map(int, prompt))
        s0 = len(prompt)
        total = s0 + max_new
        if total > eng.max_len:
            raise ValueError(f"{total} tokens exceed max_len "
                             f"{eng.max_len}")
        # pages for the whole run up front: admission is the
        # backpressure point
        blocks = eng.allocator.alloc(blocks_needed(total))
        slot = _Slot(req_id=req_id, blocks=blocks, budget=max_new)
        eng._slots[i] = slot
        row = np.zeros(MB, np.int32)
        row[:len(blocks)] = blocks
        tables[i] = row
        bucket = bs
        while bucket < s0:
            bucket *= 2
        bucket = min(bucket, eng.max_len)
        ids = np.full(bucket, pad_token_id, np.int32)
        ids[:s0] = prompt
        wait_pending()
        t0p = time.perf_counter()
        enc = eng._prefill_paged(torch.as_tensor(ids, device=dev), s0,
                                 torch.as_tensor(tables[i], device=dev),
                                 kpool, vpool)
        first, nonfinite = eng.decode_first_token(enc)
        t1p = time.perf_counter()
        stats["prefill_s"] += t1p - t0p
        stats["first_token_s"][req_id] = t1p - (t_start + arrival)
        if nonfinite:
            raise FloatingPointError(
                f"non-finite prefill logits for request {req_id!r} (the "
                f"port has no quarantine path yet)")
        slot.emitted.append(first)
        slot.budget -= 1
        tokens[i] = first
        seqlens[i] = s0
        hit_eos = eos_token_id is not None and first == eos_token_id
        live[i] = slot.budget > 0 and not hit_eos
        if not live[i]:
            retire(i)

    def predict_n(after_n=None):
        """Length of the next chunk from the host mirrors alone,
        optionally as seen after an in-flight chunk of ``after_n`` steps
        has consumed its takes. A prediction that overshoots (a slot the
        in-flight chunk retires at eos held the largest budget) costs
        device steps, never tokens: serial_n trims it before a token is
        committed."""
        best = 0
        for i in range(S):
            if not live[i]:
                continue
            b = eng._slots[i].budget
            if after_n is not None:
                b -= min(after_n, b)
            best = max(best, b)
        return min(chunk, best)

    def serial_n(rec):
        """The chunk length the serial loop would have run where ``rec``
        sits: consuming only that prefix of a lookahead chunk keeps the
        committed grouping, and with it the eos-padded results, the
        serial loop's; the device state, then ahead of the mirrors, is
        drained by the caller."""
        if not rec["lookahead"]:
            return rec["n"]
        alive = [eng._slots[i].budget for i, s_ref in rec["slots"]
                 if live[i] and eng._slots[i] is s_ref]
        if not alive:
            return rec["n"]
        return min(rec["n"], max(alive))

    def dispatch_chunk(n, after_n=None):
        """Launch one state-carrying chunk of ``n`` steps off the device
        state (uploading the mirrors first if a change drained it) and
        return its record; ``after_n`` marks a lookahead dispatch, made
        before the chunk ahead of it was consumed."""
        t0 = time.perf_counter()
        cap0 = graphs.capture_s
        if not state["valid"]:
            budg = np.asarray([eng._slots[i].budget if live[i] else 0
                               for i in range(S)], np.int32)
            eng.upload_state(tokens, seqlens, tables, live, budg, no_poison)
            state["valid"] = True
        toks_d, bad_d = eng.dispatch_chunk_state(n, eos_dev)
        k = eng.chunk_dispatches % 2
        toks_h = host_toks[k][:S * n].view(S, n)
        bad_h = host_bad[k]
        toks_h.copy_(toks_d, non_blocking=on_card)
        bad_h.copy_(bad_d, non_blocking=on_card)
        event = None
        if on_card:
            event = torch.cuda.Event()
            event.record()
        eng.chunk_dispatches += 1
        if after_n is not None:
            eng.lookahead_dispatches += 1
        stats["decode_steps"] += n
        stats["chunks"] += 1
        stats["decode_s"] += (time.perf_counter() - t0
                              - (graphs.capture_s - cap0))
        return {"toks": toks_h, "bad": bad_h, "event": event, "n": int(n),
                "lookahead": after_n is not None,
                "slots": [(i, eng._slots[i]) for i in range(S) if live[i]]}

    def consume(rec, n_eff=None):
        """Wait for a dispatched chunk's tokens and commit its first
        ``n_eff`` steps to the host mirrors. Slots are matched by _Slot
        identity, so a slot index that retired and admitted another
        request since the dispatch is skipped."""
        t0 = time.perf_counter()
        if n_eff is None:
            n_eff = serial_n(rec)
        if rec["event"] is not None:
            rec["event"].synchronize()
        toks = rec["toks"].numpy()
        bad = rec["bad"].numpy()
        for i, s_ref in rec["slots"]:
            if not live[i] or eng._slots[i] is not s_ref:
                continue
            if bad[i]:
                raise FloatingPointError(
                    f"non-finite decode logits for request {s_ref.req_id!r}"
                    f" (the port has no quarantine path yet)")
            take = min(n_eff, s_ref.budget)
            advance(i, [int(t) for t in toks[i, :take]])
        if n_eff < rec["n"]:
            # the device ran the whole chunk: its state is ahead of the
            # trimmed mirrors
            mark_state_dirty()
        stats["decode_s"] += time.perf_counter() - t0

    while queue or live.any():
        now = time.perf_counter()
        # admission: fill free slots while blocks allow
        for i in range(S):
            queue.shed(now, never_fits=never_fits,
                       admission_timeout_s=admission_timeout_s,
                       reject_oversized=reject_oversized, reject=reject)
            if not queue:
                break
            rid, prompt, mnt, arr = queue.head()
            if t_start + arr > now:
                break                # next arrival is in the future
            if not eng._slots[i].done:
                continue
            if blocks_needed(len(prompt) + mnt) > eng.allocator.free_count:
                break                # backpressure: decode first
            queue.pop()
            admit(i, rid, prompt, mnt, arr)
        if not live.any():
            if not queue:
                break
            next_arrival = t_start + queue.head()[3]
            fresh = time.perf_counter()
            if next_arrival > fresh:
                time.sleep(next_arrival - fresh)
                continue
            if next_arrival > now:
                continue             # arrived after the scan's clock
            raise MemoryError("pool too small for even one pending request")
        # take the chunk in flight, dispatch the next one off the device
        # state before its tokens reach the host, then consume. A drained
        # state consumes the chunk in flight first, so the upload carries
        # its takes.
        rec = pending[0]
        pending[0] = None
        if rec is not None and not state["valid"]:
            consume(rec)
            rec = None
        if rec is None and live.any():
            rec = dispatch_chunk(max(predict_n(), 1))
        if rec is not None:
            n_eff = serial_n(rec)
            if lookahead_on and state["valid"] and n_eff == rec["n"]:
                n2 = predict_n(after_n=rec["n"])
                if n2 >= 1:
                    pending[0] = dispatch_chunk(n2, after_n=rec["n"])
            consume(rec, n_eff)
    # a lookahead chunk whose slots all retired in the chunk ahead of it
    wait_pending()
    stats["graphs_captured"] = graphs.captured - captured0
    stats["capture_s"] = graphs.capture_s - capture_s0
    return results
