"""Continuous-batching serve loop (counterpart of
paddle_tpu/serving/batcher.py's ``serve_loop``).

Requests queue in arrival order; free slots admit them while the block
pool holds their whole run (prompt + budget), each admission prefills its
prompt into the slot's pages, and the live slots then decode together in
fused greedy chunks of min(chunk, largest remaining budget) steps. A slot
retires at its eos or when its budget is spent, and its blocks return to
the pool.

Prefill. A cache-off engine runs the bucketed in-prompt prefill (the
prompt padded to the next power-of-two multiple of block_size, capped at
max_len, the padding written into the trash block). A cache-on engine
(``PagedDecoder(prefix_cache=True)``) matches the prompt against the radix
tree (``serving/cache.py``), maps the cached blocks copy-on-write into the
new table (fresh blocks allocated first, the shared ones acquired second),
copies a fully cached prompt's boundary block on the device, and computes
only the uncached suffix through ``PagedDecoder._prefill_warm``, in windows
of ``prefill_chunk`` tokens when the engine has one. Every cache-on
prefill, hit or miss, runs there, so cold and warm streams share their
arithmetic. A retiring request's resident chain is adopted into the tree;
under pool pressure the cold LRU leaves go first, and the whole cache goes
before "pool too small". A cache-on engine keeps its pools across serves;
a cache-off one zeroes them at the start of each.

Zero-sync decode, as in the JAX engine: the batch state (tokens, lengths,
tables, liveness, budgets, poison) lives in the engine's static device
buffers (``PagedDecoder.decode_state``), and each chunk
(``PagedDecoder.dispatch_chunk_state``, one CUDA graph replay on the card)
advances it in place, retiring slots at eos or budget on the device. The
host mirrors below change only when the batch changes in a way the device
cannot see (an admission, an eviction, a quarantine, or a lookahead chunk
trimmed to the serial length); ``mark_state_dirty`` then drains the device
state and the next dispatch uploads the six mirrors (``eng.h2d_uploads``,
``eng.pipeline_drains``). With the lookahead on (``pipeline`` None or
True), chunk N+1 is dispatched off the device state before chunk N's
tokens are consumed, so the host's bookkeeping overlaps the device's
work. Each chunk's tokens and non-finite flags are copied into one of two
pinned host buffers behind it, with an event, and the host waits on that
event only when it consumes the chunk. The token streams equal the
serial loop's (``pipeline=False``) by construction: the fed-back tokens
are the ones the device wrote, and the streams do not depend on how the
steps are cut into chunks. Every write a later owner makes into a freed
block (a prefill, a COW copy) is queued on the same stream behind the
chunk in flight.

Quarantine and replay, as the reference under its default flags
(``serve_logit_quarantine`` and ``serve_fault_recovery`` on): a slot whose
logits go non-finite, at its prefill or in a decode chunk, is evicted (its
blocks freed, the device state drained) and its request queued again after
``replay_backoff_s`` x 2^(restarts - 1) seconds. The replay is admitted as
prompt + the tokens already generated, with the budget left, so one
prefill recomputes the KV and the stream goes on from its last good token;
past ``max_restarts`` the partial stream is delivered
(``eng.replay_giveups``). Everyone else keeps being served. The fault
plan's ``logits_poison`` site (``resilience/faults.py``) fires one coin
per live slot with budget left at each dispatch, in slot order; a changed
coin set uploads the poison column alone. ``eng.quarantines`` and
``eng.replays`` count them (``eng.evictions`` counts the headroom guard's
evictions, which are not ported).

Not ported: speculative decoding, streamed admission (``feed``), the
headroom guard's deferrals and evictions, the chunk-fault sites
(``paged_kv_alloc``, ``prefill_chunk``, ``decode_chunk``,
``headroom_pressure``) and telemetry. Their arguments raise unless they
hold their off value, and so does a fault plan that names those sites.

``eng.serve_stats`` holds host-clock timings of the last call: per-request
time to first token (from arrival to the first incarnation's first token
on the host), the seconds spent in prefill (ending in its first token's
read) and in decode (dispatching, waiting on and committing chunks, net of
graph capture), the device decode steps and chunks, and the graphs
captured and the seconds spent capturing them.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..resilience import faults as _faults
from .cache import plan_prefix
from .scheduler import AdmissionQueue, ReplayTracker

__all__ = ["serve_loop"]

# the JAX engine's fault-recovery arguments that belong with the headroom
# guard and the chunk-fault sites, and their defaults; any other value
# raises until those are ported
_RECOVERY_DEFAULTS = (("evict_after_deferrals", 2), ("max_deferrals", 8),
                      ("max_chunk_retries", 8))
# fault sites the JAX engine's serve hooks and this loop does not
_UNHOOKED_SITES = ("paged_kv_alloc", "prefill_chunk", "decode_chunk",
                   "headroom_pressure")


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
    given = dict(evict_after_deferrals=evict_after_deferrals,
                 max_deferrals=max_deferrals,
                 max_chunk_retries=max_chunk_retries)
    for name, default in _RECOVERY_DEFAULTS:
        if given[name] != default:
            raise NotImplementedError(
                f"serve({name}={given[name]!r}): the headroom guard and the "
                f"chunk-fault sites are not ported to the PyTorch package "
                f"yet; leave it at {default!r}")
    plan = _faults.plan()
    unhooked = sorted(set(plan.sites) & set(_UNHOOKED_SITES)) if plan \
        else []
    if unhooked:
        raise NotImplementedError(
            f"the installed fault plan names {unhooked}, which the port's "
            f"serve does not hook yet (it hooks logits_poison)")
    lookahead_on = pipeline is not False
    cache = eng.prefix_cache
    replays = ReplayTracker(max_restarts, replay_backoff_s)
    dev = eng.device
    on_card = dev.type == "cuda"
    t_start = time.perf_counter()
    queue = AdmissionQueue(t_start)
    # each request's first arrival: its time to first token starts there
    arrival0 = {}
    for rid, _, _, arr in queue.load(requests, max_new_tokens):
        arrival0.setdefault(rid, arr)
    # a cache-on engine's cached KV must outlive this serve; a cache-off
    # one starts from zeroed pools
    kpool, vpool = (eng.ensure_pools() if cache is not None
                    else eng.serve_pools())
    results = {}
    S = eng.max_slots
    bs = eng.block_size
    MB = eng.blocks_per_seq
    tokens = np.zeros(S, np.int32)
    seqlens = np.zeros(S, np.int32)
    tables = np.zeros((S, MB), np.int32)
    live = np.zeros(S, bool)
    # the poison column the device state holds
    poison_mirror = np.zeros(S, bool)
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
        # a rejected replay still delivers what its earlier incarnations
        # generated
        results[rid] = finalize_tokens(replays.prefix(rid))
        eng.rejected_requests[cause] = \
            eng.rejected_requests.get(cause, 0) + 1

    def finalize_tokens(toks):
        if eos_token_id is not None and eos_token_id in toks:
            cut = toks.index(eos_token_id)
            toks = toks[:cut + 1] + \
                [pad_token_id] * (len(toks) - cut - 1)
        return toks

    def free_slot(i):
        eng._slots[i] = _Slot(done=True)
        tables[i] = 0
        live[i] = False

    def retire(i):
        s = eng._slots[i]
        results[s.req_id] = finalize_tokens(s.emitted)
        if cache is not None:
            # adopt the retiree's resident chain before its references
            # drop: the tokens with KV in the pool are the first
            # seqlens[i] of prompt + emitted (the last emitted token was
            # never fed back)
            chain = (list(s.prompt) + list(s.emitted))[:int(seqlens[i])]
            cache.insert(chain, s.blocks)
        eng.allocator.free(s.blocks)
        free_slot(i)

    def requeue(rid, prompt, mnt, prefix, now):
        """Queue a replay of an evicted incarnation after its backoff, or
        deliver the partial stream past max_restarts."""
        delay = replays.note(rid, prefix)
        if delay is None:
            eng.replay_giveups += 1
            results[rid] = finalize_tokens(list(prefix))
            return
        queue.push(rid, prompt, mnt, (now - t_start) + delay)
        eng.replays += 1

    def evict(i, now):
        """Free slot i's blocks and queue its request's replay with the
        tokens it generated. The device still holds the slot live, so the
        state is drained."""
        s = eng._slots[i]
        prefix = list(s.emitted)
        mnt = len(prefix) + s.budget
        eng.allocator.free(s.blocks)
        free_slot(i)
        mark_state_dirty()
        requeue(s.req_id, list(s.prompt), mnt, prefix, now)

    def quarantine(i, now):
        """Slot i's logits went non-finite: recycle the slot and replay
        its request from its last good token."""
        eng.quarantines += 1
        evict(i, now)

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

    def prefill(ids_full, s0, cached, cow_src, fresh, table):
        """The admission's prefill: the bucketed in-prompt prefill
        (cache off), or the warm prefill of the uncached suffix in
        ``prefill_chunk`` windows, after the COW fork of a fully cached
        prompt's boundary block. Returns the last call's encoded first
        token."""
        def bucketed(piece):
            bucket = bs
            while bucket < len(piece):
                bucket *= 2
            ids = np.full(min(bucket, eng.max_len), pad_token_id, np.int32)
            ids[:len(piece)] = piece
            return torch.as_tensor(ids, device=dev)

        if cache is None:
            eng.prefill_device_calls += 1
            eng.prefill_tokens_computed += s0
            return eng._prefill_paged(bucketed(ids_full), s0, table, kpool,
                                      vpool)
        if cow_src is not None:
            eng._cow_copy(kpool, vpool, cow_src, fresh[0])
        suffix = ids_full[cached:]
        ns = len(suffix)
        step = eng.prefill_chunk if eng.prefill_chunk and \
            ns > eng.prefill_chunk else ns
        enc = None
        for off in range(0, ns, step):
            piece = suffix[off:off + step]
            enc = eng._prefill_warm(bucketed(piece), cached + off,
                                    len(piece), table, kpool, vpool)
            eng.prefill_device_calls += 1
        eng.prefill_tokens_computed += ns
        return enc

    def admit(i, req_id, prompt, max_new):
        mark_state_dirty()
        prompt = list(map(int, prompt))
        # a replay enters as its prompt + the tokens its earlier
        # incarnations generated: one prefill recomputes the KV, and its
        # argmax is the stream's next token
        prefix = replays.prefix(req_id)
        ids_full = prompt + prefix
        s0 = len(ids_full)
        total = len(prompt) + max_new
        if total > eng.max_len:
            raise ValueError(f"{total} tokens exceed max_len "
                             f"{eng.max_len}")
        # the cached blocks to map, planned before the alloc so that the
        # fresh bill leaves out the shared span; pages for the whole run
        # up front (admission is the backpressure point), fresh first
        m, kb, cached, cow_src = plan_prefix(cache, ids_full, s0)
        fresh = eng.allocator.alloc(blocks_needed(total) - kb)
        blocks = (cache.acquire(m, kb) if kb else []) + fresh
        slot = _Slot(req_id=req_id, blocks=blocks, prompt=prompt,
                     budget=max_new - len(prefix))
        slot.emitted = list(prefix)
        eng._slots[i] = slot
        row = np.zeros(MB, np.int32)
        row[:len(blocks)] = blocks
        tables[i] = row
        wait_pending()
        t0p = time.perf_counter()
        enc = prefill(ids_full, s0, cached, cow_src, fresh,
                      torch.as_tensor(tables[i], device=dev))
        first, nonfinite = eng.decode_first_token(enc)
        t1p = time.perf_counter()
        stats["prefill_s"] += t1p - t0p
        if cache is not None:
            cache.record_admission(cached, kb, cow=cow_src is not None)
        if nonfinite:
            # the same contract as a poisoned decode chunk: no first
            # token, the request replayed
            quarantine(i, t1p)
            return
        stats["first_token_s"].setdefault(
            req_id, t1p - (t_start + arrival0[req_id]))
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
        budg = np.asarray([eng._slots[i].budget if live[i] else 0
                           for i in range(S)], np.int32)
        if after_n is not None:
            budg -= np.where(live, np.minimum(after_n, budg), 0).astype(
                np.int32)
        # the fault plan's poison coins: one per live slot with budget
        # left, in slot order, as the JAX engine fires them
        coins = np.zeros(S, bool)
        if _faults.active():
            for i in range(S):
                if live[i] and budg[i] > 0 and _faults.fire("logits_poison"):
                    coins[i] = True
        if not state["valid"]:
            eng.upload_state(tokens, seqlens, tables, live, budg, coins)
            poison_mirror[:] = coins
            state["valid"] = True
        elif not np.array_equal(coins, poison_mirror):
            eng.upload_poison(coins)
            poison_mirror[:] = coins
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
                quarantine(i, time.perf_counter())
                continue
            take = min(n_eff, s_ref.budget)
            advance(i, [int(t) for t in toks[i, :take]])
        if n_eff < rec["n"]:
            # the device ran the whole chunk: its state is ahead of the
            # trimmed mirrors
            mark_state_dirty()
        stats["decode_s"] += time.perf_counter() - t0

    def step(now):
        """One pass of the loop: admissions, then one chunk consumed."""
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
            need = blocks_needed(len(prompt) + mnt)
            if need > eng.allocator.free_count:
                # pool pressure: cold cache leaves go first; live tables
                # are untouchable
                if cache is not None:
                    cache.evict(need - eng.allocator.free_count)
                if need > eng.allocator.free_count:
                    break            # backpressure: decode first
            queue.pop()
            admit(i, rid, prompt, mnt)
        if not live.any():
            if not queue:
                return
            next_arrival = t_start + queue.head()[3]
            fresh = time.perf_counter()
            if next_arrival > fresh:
                time.sleep(next_arrival - fresh)
                return
            if next_arrival > now:
                return               # arrived after the scan's clock
            if cache is not None and cache.held_blocks:
                # the last resort before "pool too small": drop the whole
                # cache, which holds blocks the head needs, and scan again
                cache.evict(cache.held_blocks)
                return
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

    try:
        while queue or live.any():
            step(time.perf_counter())
    except BaseException:
        if cache is not None:
            # the cached chains may point at KV this serve left half
            # written
            eng.release_pools()
        raise
    # a lookahead chunk whose slots all retired in the chunk ahead of it
    wait_pending()
    stats["graphs_captured"] = graphs.captured - captured0
    stats["capture_s"] = graphs.capture_s - capture_s0
    return results
