"""Continuous-batching serve loop (counterpart of
paddle_tpu/serving/batcher.py's ``serve_loop``, its serial core).

Requests queue in arrival order; free slots admit them while the block
pool holds their whole run (prompt + budget), each admission prefills its
prompt into the slot's pages through a bucketed prefill (the prompt padded
to the next power-of-two multiple of block_size, capped at max_len, the
padding written into the trash block), and the live slots then decode
together in fused greedy chunks of min(chunk, largest remaining budget)
steps. A slot retires at its eos or when its budget is spent, and its
blocks return to the pool. The token streams are those of the JAX engine's
``serve(..., pipeline=False)``.

Not ported: speculative decoding, the prefix cache, streamed admission
(``feed``), fault recovery, telemetry and the pipelined one-chunk
lookahead. Their arguments raise unless they hold their off value.

``eng.serve_stats`` holds host-clock timings of the last call: per-request
time to first token (from arrival to the prefill's first token on the
host), and the seconds spent in prefill and in decode chunks, each ending
in a device sync.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .scheduler import AdmissionQueue

__all__ = ["serve_loop"]


def serve_loop(eng, requests, *, max_new_tokens=32, eos_token_id=None,
               chunk=8, pad_token_id=0, admission_timeout_s=None,
               reject_oversized=False, spec_decode=None, feed=None,
               feed_active=None, pipeline=False):
    """The continuous-batching loop; ``eng`` is the PagedDecoder. See
    ``PagedDecoder.serve`` for the request forms and the result."""
    from ..models.paged_decode import _Slot
    for name, val in (("spec_decode", spec_decode), ("feed", feed),
                      ("feed_active", feed_active)):
        if val is not None:
            raise NotImplementedError(
                f"serve({name}=...) is not ported to the PyTorch package "
                f"yet")
    if pipeline is not False:
        raise NotImplementedError(
            f"serve(pipeline={pipeline!r}): the pipelined lookahead is not "
            f"ported yet; the port runs the serial loop (pipeline=False)")
    dev = eng.device
    t_start = time.perf_counter()
    queue = AdmissionQueue(t_start)
    queue.load(requests, max_new_tokens)
    kpool, vpool = eng.new_pools()
    results = {}
    bs = eng.block_size
    MB = eng.blocks_per_seq
    tokens = np.zeros(eng.max_slots, np.int32)
    seqlens = np.zeros(eng.max_slots, np.int32)
    tables = np.zeros((eng.max_slots, MB), np.int32)
    live = np.zeros(eng.max_slots, bool)
    stats = {"first_token_s": {}, "prefill_s": 0.0, "decode_s": 0.0,
             "decode_steps": 0, "chunks": 0}
    eng.serve_stats = stats

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

    def admit(i, req_id, prompt, max_new, arrival):
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

    def decode_chunk():
        """One fused greedy chunk over the live slots, committed to the
        host mirrors."""
        budg = np.asarray([eng._slots[i].budget if live[i] else 0
                           for i in range(eng.max_slots)], np.int32)
        n = max(min(chunk, int(budg.max())), 1)
        rows = [i for i in range(eng.max_slots) if live[i]]
        t0c = time.perf_counter()
        toks = eng._paged_chunk(
            torch.as_tensor(tokens, device=dev),
            torch.as_tensor(seqlens, device=dev),
            torch.as_tensor(tables, device=dev),
            torch.as_tensor(live, device=dev),
            torch.as_tensor(budg, device=dev), kpool, vpool, n)
        toks = toks.cpu().numpy()
        stats["decode_s"] += time.perf_counter() - t0c
        stats["decode_steps"] += n
        stats["chunks"] += 1
        for i in rows:
            take = min(n, eng._slots[i].budget)
            advance(i, [int(t) for t in toks[i, :take]])

    while queue or live.any():
        now = time.perf_counter()
        # admission: fill free slots while blocks allow
        for i in range(eng.max_slots):
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
        decode_chunk()
    return results
