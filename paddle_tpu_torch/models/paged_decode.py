"""Paged KV cache and continuous batching (counterpart of
paddle_tpu/models/paged_decode.py).

K/V live in pools [L, num_blocks, block_size, Hkv, D]; block 0 is the
trash block that inactive slots and padding write into. Every slot owns a
row of a block table [max_slots, blocks_per_seq] of pool-block ids, handed
out by a host-side ``BlockAllocator``; token t of slot s lives at
pool[table[s, t // bs], t % bs]. One decode step runs every slot at its
own position, and a greedy chunk fuses several steps with per-slot
``live`` and ``budgets`` gating, so a slot whose budget is spent stops
advancing and writes into the trash block.

The JAX engine threads the pools through its executables functionally
(donated buffers); this port updates the pools IN PLACE: ``_pool_write``,
``_paged_step``, ``_paged_chunk_state`` and ``_prefill_paged`` write into
the pool tensors they are given and return only what they compute.

The serve loop decodes through ``_paged_chunk_state``, the state-carrying
chunk: it takes (tok, seqlens, tables, live, budgets, poison), runs n
greedy steps and returns the advanced state beside the tokens, retiring a
slot's liveness on the device at its eos or at the end of its budget.
On the card each (n, eos_id) chunk is one CUDA graph
(``jit/chunk_graph.py``) over the engine's static state buffers and its
persistent pools, replayed once a chunk. A cache-off engine zeroes its
pools at the start of every serve (the JAX engine's fresh pools); a
cache-on engine keeps them, since its cached KV outlives the serve.

The prefix cache (``prefix_cache=True``, ``"radix"`` or a
``serving.cache.RadixPrefixCache``; ``prefix_cache_blocks`` caps it)
shares whole blocks between requests through the refcounted
``BlockAllocator``. Every cache-on prefill runs ``_prefill_warm``: the
uncached suffix's tokens are query rows of `_paged_step`, each at its own
position with the prompt's table, so decode attention (the ragged
kernels on the card) reads the cached blocks; ``prefill_chunk`` cuts a
long suffix into windows. ``_cow_copy`` forks a fully cached prompt's
boundary block, ``release_pools`` drops the cache and zeroes the pools in
place, and ``poison_blocks`` fills blocks with NaN for tests.

Decode attention on a CUDA tensor runs the hand-written ragged paged
attention kernel (kernels/ragged_paged_attention.py) straight off the
pool through the tables; ``ragged_kernel=False`` selects the dense-gather
``_attend`` that the JAX package keeps as its numerical oracle. A model
whose head dim or query heads per KV head no kernel takes (`decode_route`
"plain": head dim 80 or 96, 3 query heads a KV head) runs that dense path
on every device, as the reference serves any head dim;
``PagedDecoder.route_launches`` counts the decode attention calls by
route. Two
options change the ragged path:
- ``kv_quant="int8"``: each pool is a ``QuantizedPool`` of int8 codes
  [L, NB, bs, Hkv, D] and one float32 scale per token row [L, NB, bs],
  quantized at write time (``kv_quantize_rows``) and read by the quantized
  kernel, which dequantizes after the load; the dense path dequantizes the
  gathered window and stays the oracle;
- ``attn_shards`` (or ``shard_block_budget``, which derives it): decode
  attention as per-shard partials over contiguous sub-tables, merged by
  the lse rescale (split-context attention; one launch for all shards).
``weight_quant`` is CachedDecoder's. Options the port has not reached yet
(kv_offload, hbm_budget_gib, headroom_guard, block_size="auto") raise
NotImplementedError.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ..jit.chunk_graph import ChunkGraphs
from ..kernels.quant_matmul import quant_matmul
from ..kernels.ragged_paged_attention import (
    DECODE_ROUTES, decode_route, kv_dequantize_rows, kv_quantize_rows,
    ragged_paged_attention, ragged_paged_attention_partials,
    ragged_paged_attention_quant, ragged_paged_attention_sharded)
from ..nn.layer.norm import rms_norm as _rms
from .decode import NEG_INF, CachedDecoder

__all__ = ["PagedDecoder", "BlockAllocator", "QuantizedPool"]


@dataclass(frozen=True)
class QuantizedPool:
    """One side (K or V) of an int8 paged pool: codes int8 [..., NB, bs,
    Hkv, D] and row scales float32 [..., NB, bs]. Indexing selects along
    the leading (layer) dims of both, so ``pool[l]`` is layer l's pool
    whether the pool is quantized or a plain tensor."""
    codes: torch.Tensor
    scales: torch.Tensor

    def __getitem__(self, i):
        return QuantizedPool(self.codes[i], self.scales[i])


def _pool_leaves(pool):
    """The tensors of one pool side: (codes, scales) or the tensor."""
    if isinstance(pool, QuantizedPool):
        return pool.codes, pool.scales
    return (pool,)


class DecodeState(NamedTuple):
    """The batch state a decode chunk reads and advances, on the device:
    tok [S] int32 (each slot's last token), lens [S] int32 (tokens in its
    pages), tables [S, MB] int32, live [S] bool, budgets [S] int32
    (tokens still to generate), poison [S] bool (the fault plan's
    logits_poison coins: a poisoned slot's logits are NaN)."""
    tok: torch.Tensor
    lens: torch.Tensor
    tables: torch.Tensor
    live: torch.Tensor
    budgets: torch.Tensor
    poison: torch.Tensor


class BlockAllocator:
    """Host-side free list over pool blocks. Block 0 is reserved as the
    trash block; sequences get blocks 1..num_blocks-1.

    Blocks are refcounted: the prefix cache maps one block into several
    tables (copy-on-write sharing), so a block is owned by every table
    that maps it and by the radix tree if it is cached. ``alloc`` bears
    blocks at refcount 1, ``retain`` adds a reference and ``free`` drops
    one, returning the block to the free list at 0. A double free, or the
    retain of a free block, raises instead of corrupting the free list."""

    def __init__(self, num_blocks):
        self.num_blocks = int(num_blocks)
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._rc = {}                 # block id -> refcount (absent: free)
        self.peak_in_use = 0

    @property
    def free_count(self):
        return len(self._free)

    @property
    def in_use(self):
        return (self.num_blocks - 1) - len(self._free)

    def refcount(self, block):
        return self._rc.get(int(block), 0)

    def alloc(self, n):
        if n > len(self._free):
            raise MemoryError(
                f"KV pool exhausted: need {n} blocks, {len(self._free)} "
                f"free (raise num_blocks or lower max_slots)")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._rc[b] = 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return out

    def retain(self, block):
        """Add one reference to a live block. Retaining a free block would
        alias a later allocation onto cached KV, so it raises."""
        b = int(block)
        rc = self._rc.get(b, 0)
        if rc <= 0:
            raise ValueError(f"retain of free block {b}")
        self._rc[b] = rc + 1

    def free(self, blocks):
        for b in blocks:
            b = int(b)
            if not 0 < b < self.num_blocks:
                raise ValueError(f"bad block id {b}")
            rc = self._rc.get(b, 0)
            if rc <= 0:
                raise ValueError(f"double free of block {b}")
            if rc == 1:
                del self._rc[b]
                self._free.append(b)
            else:
                self._rc[b] = rc - 1


@dataclass
class _Slot:
    req_id: object = None
    blocks: list = field(default_factory=list)
    emitted: list = field(default_factory=list)   # generated tokens
    prompt: list = field(default_factory=list)    # for replay and the cache
    budget: int = 0            # max_new_tokens remaining
    done: bool = False


_UNPORTED = ("kv_offload", "hbm_budget_gib", "headroom_guard")


class PagedDecoder(CachedDecoder):
    """Serving engine with a paged KV cache and continuous batching, on
    ``device`` (default ``cuda``; raises without a card unless
    ``device="cpu"``). Weight preparation is CachedDecoder's."""

    # decode attention calls (one a layer a step) by `decode_route`, across
    # every engine; the dense oracle (ragged_kernel=False) counts none
    route_launches = dict.fromkeys(DECODE_ROUTES, 0)

    def __init__(self, model, max_len=None, weight_quant=None,
                 block_size=64, num_blocks=None, max_slots=8,
                 headroom_guard=None, ragged_kernel=None, kv_quant=None,
                 prefix_cache=None, prefix_cache_blocks=None,
                 attn_shards=None, shard_block_budget=None,
                 prefill_chunk=None, kv_offload=None,
                 hbm_budget_gib=None, device=None):
        opts = dict(kv_offload=kv_offload, hbm_budget_gib=hbm_budget_gib,
                    headroom_guard=headroom_guard)
        for name in _UNPORTED:
            if opts[name] not in (None, False):
                raise NotImplementedError(
                    f"PagedDecoder option {name}={opts[name]!r} is not "
                    f"ported to the PyTorch package yet")
        if kv_quant not in (None, "int8"):
            raise ValueError(f"kv_quant must be None or 'int8', got "
                             f"{kv_quant!r}")
        if block_size == "auto":
            raise NotImplementedError(
                "block_size='auto' needs the autotune cache, which is not "
                "ported yet; pass an integer block size")
        super().__init__(model, max_len=max_len, weight_quant=weight_quant,
                         device=device)
        # the ragged kernel is the decode attention on the card; the CPU
        # defaults to the dense-gather oracle, as the JAX engine does off
        # the TPU
        if ragged_kernel is None:
            ragged_kernel = self.device.type == "cuda"
        self.use_ragged_kernel = bool(ragged_kernel)
        # max_len is a capacity: round DOWN to a block multiple
        if self.max_len % block_size:
            if self.max_len < block_size:
                raise ValueError(f"block_size {block_size} exceeds "
                                 f"max_len {self.max_len}")
            self.max_len -= self.max_len % block_size
        self.block_size = int(block_size)
        self.blocks_per_seq = self.max_len // self.block_size
        self.max_slots = int(max_slots)
        self.kv_quant = kv_quant
        # split-context decode attention: shard count fixed at
        # construction, derived from a per-shard block budget when not
        # given (the JAX engine's rule)
        if attn_shards is None:
            if shard_block_budget and \
                    self.blocks_per_seq > int(shard_block_budget):
                attn_shards = -(-self.blocks_per_seq
                                // int(shard_block_budget))
            else:
                attn_shards = 1
        self.attn_shards = max(1, int(attn_shards))
        if self.attn_shards > self.blocks_per_seq:
            raise ValueError(
                f"attn_shards {self.attn_shards} exceeds blocks_per_seq "
                f"{self.blocks_per_seq}")
        if self.attn_shards > 1 and self.kv_quant:
            raise ValueError(
                "attn_shards > 1 is not supported with kv_quant: the "
                "partials kernel has no int8 variant yet; serve long "
                "contexts unquantized or raise shard_block_budget")
        # chunked prefill: a warm-prefill suffix longer than this runs in
        # windows of this many tokens
        if prefill_chunk is not None:
            prefill_chunk = int(prefill_chunk)
            if prefill_chunk < self.block_size:
                raise ValueError(
                    f"prefill_chunk {prefill_chunk} below block_size "
                    f"{self.block_size}")
        self.prefill_chunk = prefill_chunk
        # decode steps whose attention ran as sharded partials
        self.sharded_attn_calls = 0
        self.num_blocks = int(num_blocks or
                              (self.max_slots * self.blocks_per_seq) // 2
                              + 1)
        self.allocator = BlockAllocator(self.num_blocks)
        self._slots = [_Slot(done=True) for _ in range(self.max_slots)]
        # the radix prefix cache: True or "radix" builds one over this
        # engine's allocator, an instance is taken as it is. A cache-on
        # engine keeps its pools across serves: the cached KV must outlive
        # the serve that wrote it
        if prefix_cache in (True, "radix"):
            from ..serving.cache import RadixPrefixCache
            prefix_cache = RadixPrefixCache(self.block_size, self.allocator,
                                            max_blocks=prefix_cache_blocks)
        elif prefix_cache in (None, False):
            prefix_cache = None
        self.prefix_cache = prefix_cache
        self.rejected_requests = {}
        # fault recovery: slots evicted, replays admitted, slots
        # quarantined on non-finite logits, requests given up past
        # max_restarts
        self.evictions = 0
        self.replays = 0
        self.quarantines = 0
        self.replay_giveups = 0
        # the prefills' device calls and the prompt tokens they computed
        # (a cached span is not computed)
        self.prefill_device_calls = 0
        self.prefill_tokens_computed = 0
        self.serve_stats = {}
        # host<->device traffic of the serve loop, as the JAX engine counts
        # it: decode-state uploads (6 a composition change), chunk
        # dispatches, dispatches made while another chunk was in flight,
        # and drains of the device state after a change it cannot see
        self.h2d_uploads = 0
        self.chunk_dispatches = 0
        self.lookahead_dispatches = 0
        self.pipeline_drains = 0
        self._pools = None
        self._state = None
        # the graphs reach the engine through a weak reference: an engine
        # and its graph memory go as soon as the caller drops the engine
        engine = weakref.ref(self)
        self._chunk_graphs = ChunkGraphs(
            self.device, lambda: engine()._graph_counters())

    # -- pools -------------------------------------------------------------
    def new_pools(self):
        """(kpool, vpool) for every layer: tensors [L, NB, bs, Hkv, D] in
        the model dtype, or with kv_quant QuantizedPools whose scales start
        at 1 (zero codes dequantize to a zero pool)."""
        shape = (self.n_layers, self.num_blocks, self.block_size, self.nkv,
                 self.hd)
        if self.kv_quant:
            return tuple(QuantizedPool(
                torch.zeros(shape, dtype=torch.int8, device=self.device),
                torch.ones(shape[:3], dtype=torch.float32,
                           device=self.device)) for _ in range(2))
        return (torch.zeros(shape, dtype=self.dtype, device=self.device),
                torch.zeros(shape, dtype=self.dtype, device=self.device))

    def ensure_pools(self):
        """The engine's own (kpool, vpool), allocated on first use and kept
        for the engine's life: the chunk graphs bind their addresses, and a
        cache-on engine's cached KV lives in them across serves."""
        if self._pools is None:
            self._pools = self.new_pools()
        return self._pools

    def _zero_pools(self):
        for pool in self._pools:
            if isinstance(pool, QuantizedPool):
                pool.codes.zero_()
                pool.scales.fill_(1.0)
            else:
                pool.zero_()

    def serve_pools(self):
        """The engine's pools, zeroed in place (int8 scales back to 1): a
        cache-off serve starts from fresh pools as the JAX engine's does,
        and the chunk graphs stay valid."""
        if self._pools is None:
            return self.ensure_pools()
        self._zero_pools()
        return self._pools

    def release_pools(self):
        """Drop every cache entry and zero the pools in place (the JAX
        engine drops its persistent pools; here the chunk graphs point at
        them, so the tensors stay)."""
        if self.prefix_cache is not None:
            self.prefix_cache.clear()
        if self._pools is not None:
            self._zero_pools()

    def poison_blocks(self, block_ids):
        """Test hook: poison blocks of the engine's pools in place, every
        layer, K and V (float planes NaN, int8 code planes 127). A freed
        block poisoned so is never read while no table maps it."""
        idx = torch.as_tensor(np.asarray(block_ids, np.int64),
                              device=self.device)
        for pool in self.ensure_pools():
            for t in _pool_leaves(pool):
                t[:, idx] = float("nan") if t.is_floating_point() else 127
        return self._pools

    def decode_state(self):
        """The engine's static DecodeState buffers (allocated zero on
        first use): the chunk graphs read and advance them in place."""
        if self._state is None:
            S, MB = self.max_slots, self.blocks_per_seq

            def zeros(*shape, dtype=torch.int32):
                return torch.zeros(shape, dtype=dtype, device=self.device)

            self._state = DecodeState(
                zeros(S), zeros(S), zeros(S, MB), zeros(S, dtype=torch.bool),
                zeros(S), zeros(S, dtype=torch.bool))
        return self._state

    def upload_state(self, tok, lens, tables, live, budgets, poison):
        """Copy the host mirrors (numpy) into the static state buffers:
        six uploads, counted in ``h2d_uploads``."""
        st = self.decode_state()
        for dst, src in zip(st, (tok, lens, tables, live, budgets, poison)):
            dst.copy_(torch.from_numpy(np.ascontiguousarray(src)))
        self.h2d_uploads += 6

    def upload_poison(self, poison):
        """Copy a new poison column into its static buffer: one upload."""
        self.decode_state().poison.copy_(
            torch.from_numpy(np.ascontiguousarray(poison)))
        self.h2d_uploads += 1

    def _graph_counters(self):
        """The launch counters a decode chunk moves (see ChunkGraphs)."""
        return [(ragged_paged_attention, "launches"),
                (ragged_paged_attention_quant, "launches"),
                (ragged_paged_attention_partials, "launches"),
                (quant_matmul, "launches"), (quant_matmul, "route_launches"),
                (PagedDecoder, "route_launches"),
                (self, "sharded_attn_calls")]

    def kv_token_bytes(self):
        """Bytes one pool token row of K (or V) costs: the values at the
        pool's itemsize, plus the float32 scale when quantized."""
        if self.kv_quant:
            return self.nkv * self.hd + 4
        return self.nkv * self.hd * (torch.finfo(self.dtype).bits // 8)

    def pool_bytes(self):
        return (2 * self.n_layers * self.num_blocks * self.block_size
                * self.kv_token_bytes())

    def bytes_per_block(self):
        """K+V bytes one pool block holds across all layers."""
        return 2 * self.n_layers * self.block_size * self.kv_token_bytes()

    # -- core step ---------------------------------------------------------
    def _attend(self, q, kw, vw, pos):
        """q [S, nh, hd]; kw/vw gathered windows [S, W, nkv, hd]; pos [S]
        (index of the token just written). Grouped attention against the
        unrepeated window, masked to arange(W) <= pos per slot."""
        S, W = kw.shape[0], kw.shape[1]
        nrep = self.nh // self.nkv
        qg = q.reshape(S, self.nkv, nrep, self.hd).float()
        att = torch.einsum("bgnd,bwgd->bgnw", qg, kw.float()) * self.scale
        mask = (torch.arange(W, device=q.device)[None, :]
                <= pos.long()[:, None])                     # [S, W]
        att = att.masked_fill(~mask[:, None, None, :], NEG_INF)
        p = torch.softmax(att, dim=-1)
        o = torch.einsum("bgnw,bwgd->bgnd", p, vw.float()).to(q.dtype)
        return o.reshape(S, self.nh * self.hd)

    def _pool_write(self, kc, vc, k, v, widx):
        """Write one K/V token row per query row into one layer's pools
        (kc/vc [NB, bs, nkv, hd], or QuantizedPools) at flat pool-token
        index widx, in place. A quantized pool quantizes each row as it
        is written: a token touches its own codes and one scale."""
        for pool, x in ((kc, k), (vc, v)):
            if isinstance(pool, QuantizedPool):
                codes, scales = kv_quantize_rows(x)
                pool.codes.view(-1, self.nkv, self.hd)[widx] = codes
                pool.scales.view(-1)[widx] = scales
            else:
                pool.view(-1, self.nkv, self.hd)[widx] = x.to(pool.dtype)

    def _decode_route(self):
        """The decode attention's route, or None on the dense oracle
        (ragged_kernel=False): `decode_route` of the query dtype, head dim
        and group size."""
        if not self.use_ragged_kernel:
            return None
        return decode_route(self.dtype, self.hd, self.nh // self.nkv)

    def _pool_attend(self, q, kc, vc, tables, seqlens, route=None):
        """Attention for q [S, nh, hd] against one layer's pools. Ragged
        path (route "kernel"): a kernel walks each slot's table up to
        seqlens (the quantized kernel for an int8 pool, the sharded
        partials with attn_shards > 1). Dense path (route "plain", or the
        oracle's None): gather the block-granular window, dequantized for
        an int8 pool, and run the reference math."""
        S = q.shape[0]
        if route is not None:
            PagedDecoder.route_launches[route] += 1
        if route == "kernel":
            if self.kv_quant:
                o = ragged_paged_attention_quant(
                    q, kc.codes, kc.scales, vc.codes, vc.scales, tables,
                    seqlens, scale=self.scale)
            elif self.attn_shards > 1:
                o = ragged_paged_attention_sharded(
                    q, kc, vc, tables, seqlens, self.attn_shards,
                    scale=self.scale)
            else:
                o = ragged_paged_attention(q, kc, vc, tables, seqlens,
                                           scale=self.scale)
            return o.reshape(S, self.nh * self.hd)
        tabs = tables.long()
        if self.kv_quant:
            kw = kv_dequantize_rows(kc.codes[tabs], kc.scales[tabs])
            vw = kv_dequantize_rows(vc.codes[tabs], vc.scales[tabs])
        else:
            kw, vw = kc[tabs], vc[tabs]
        return self._attend(q, kw.reshape(S, -1, self.nkv, self.hd),
                            vw.reshape(S, -1, self.nkv, self.hd), seqlens)

    @torch.no_grad()
    def _paged_step(self, tokens, seqlens, tables, kpool, vpool,
                    active=None):
        """One decode step for every slot. tokens [S] int; seqlens [S]
        int32 = tokens already in the pages (the new token is written at
        position seqlens); tables [S, MB] int32 block ids; pools [L, NB,
        bs, Hkv, D], written in place; active [S] bool (optional) marks
        slots that really advance: the others write into the trash
        block. Returns logits [S, V] float32."""
        x = self._paged_layers(tokens, seqlens, tables, kpool, vpool, active)
        return self._head_logits(_rms(x, self.norm_w, self.eps))

    def _paged_layers(self, tokens, seqlens, tables, kpool, vpool, active):
        """The layers of `_paged_step`: its rows' hidden states [S, H]
        before the final norm."""
        S = tokens.shape[0]
        bs = self.block_size
        pos = seqlens.long()
        x = self.embed[tokens.long()]                       # [S, H]
        cos = self.cos[pos][:, None, :]
        sin = self.sin[pos][:, None, :]
        blk = tables.long().gather(1, (pos // bs)[:, None])[:, 0]
        if active is not None:
            blk = torch.where(active, blk, 0)
        widx = blk * bs + pos % bs                          # [S]
        route = self._decode_route()
        for l in range(self.n_layers):
            q, k, v = self._qkv(x, l, cos, sin)
            kc, vc = kpool[l], vpool[l]
            self._pool_write(kc, vc, k, v, widx)
            o = self._pool_attend(q, kc, vc, tables, seqlens, route)
            x = x + self._layer_mm(o, "wo", l)
            x = self._mlp(x, l)
        if route == "kernel" and self.attn_shards > 1:
            self.sharded_attn_calls += 1
        return x

    @torch.no_grad()
    def _paged_chunk_state(self, tok0, seqlens0, tables, live, budgets,
                           poison, kpool, vpool, n, eos_id=-1):
        """State-carrying decode chunk (the JAX engine's
        `_paged_chunk_state_impl`): n greedy steps with argmax feedback.
        live [S] bool masks the slots that advance; budgets [S] int32 is
        each slot's remaining token budget, and at step i only slots with
        i < budget are active (an inactive slot writes into the trash
        block and its length freezes); poison [S] bool sets a slot's
        logits to NaN after the head. ``eos_id`` (-1: none) retires a
        slot's liveness on the device when it emits eos, and a slot whose
        budget this chunk spends retires too (took = min(n, max(budget,
        0))), so the state needs no host update until the batch changes.
        Returns (toks [S, n], bad [S] (an active step's logits went
        non-finite), tok', seqlens', live', budgets'); the pools are
        written in place."""
        tok, lens = tok0, seqlens0
        bad = torch.zeros_like(live)
        eos = torch.zeros_like(live)
        out = []
        for i in range(n):
            act = live & (i < budgets)
            logits = self._paged_step(tok, lens, tables, kpool, vpool,
                                      active=act)
            logits = torch.where(poison[:, None], float("nan"), logits)
            bad = bad | (act & ~torch.isfinite(logits).all(dim=-1))
            nxt = torch.argmax(logits, dim=-1).to(tok.dtype)
            tok = torch.where(act, nxt, tok)
            lens = torch.where(act, lens + 1, lens)
            if eos_id >= 0:
                eos = eos | (act & (tok == eos_id))
            out.append(tok)
        took = budgets.clamp(0, n)
        budgets = torch.where(live, budgets - took, budgets)
        live = live & (budgets > 0) & ~eos
        return torch.stack(out, dim=1), bad, tok, lens, live, budgets

    def dispatch_chunk_state(self, n, eos_id=-1):
        """Run one `_paged_chunk_state` of n steps on the static state
        buffers and the engine's pools, advancing the state in place;
        returns (toks [S, n], bad [S]). On the card this replays the
        chunk's CUDA graph (captured on first use of (n, eos_id)), whose
        outputs the next replay of the same graph overwrites; on the CPU
        it runs eagerly."""
        st = self.decode_state()
        kpool, vpool = self._pools

        def body():
            toks, bad, tok, lens, live, budgets = self._paged_chunk_state(
                *st, kpool, vpool, n, eos_id)
            st.tok.copy_(tok)
            st.lens.copy_(lens)
            st.live.copy_(live)
            st.budgets.copy_(budgets)
            return toks, bad

        def warmup():
            # no slot live: every write lands in the trash block, and the
            # static state is left as it is
            self._paged_chunk_state(
                st.tok, st.lens, st.tables, torch.zeros_like(st.live),
                st.budgets, st.poison, kpool, vpool, n, eos_id)

        return self._chunk_graphs.run((int(n), int(eos_id)), body, warmup)

    @staticmethod
    def _encode_first_token(logits):
        """argmax and the finiteness probe as ONE int: ``tok`` when every
        logit is finite, ``-(tok+1)`` otherwise (decoded by
        `decode_first_token`)."""
        tok = torch.argmax(logits).to(torch.int32)
        ok = torch.isfinite(logits).all()
        return torch.where(ok, tok, -tok - 1)

    @staticmethod
    def decode_first_token(enc):
        """(first_token, logits_nonfinite) from `_encode_first_token`."""
        v = int(enc)
        return (-v - 1, True) if v < 0 else (v, False)

    @torch.no_grad()
    def _prefill_paged(self, ids, true_len, table, kpool, vpool):
        """ids [S0pad] int (a prompt padded to its bucket); true_len int;
        table [MB] int32. Writes K/V for positions < true_len into the
        slot's blocks and the padding into the trash block (in place);
        returns the ENCODED first token (argmax of the logits at
        true_len - 1)."""
        S0 = ids.shape[0]
        bs = self.block_size
        nrep = self.nh // self.nkv
        dev = ids.device
        x = self.embed[ids.long()]                          # [S0, H]
        cos = self.cos[:S0][:, None, :]
        sin = self.sin[:S0][:, None, :]
        pos = torch.arange(S0, device=dev)
        valid = pos < true_len
        blk = torch.where(valid, table.long()[pos // bs], 0)
        widx = blk * bs + pos % bs                          # [S0]
        causal = pos[None, :] <= pos[:, None]               # [S0, S0]
        for l in range(self.n_layers):
            q, k, v = self._qkv(x, l, cos, sin)
            self._pool_write(kpool[l], vpool[l], k, v, widx)
            # in-prompt causal attention: the prompt is contiguous here,
            # and read at full precision even when the pool is quantized
            qg = q.reshape(S0, self.nkv, nrep, self.hd).float()
            att = torch.einsum("qgnd,kgd->gnqk", qg, k.float()) * self.scale
            att = att.masked_fill(~causal, NEG_INF)
            p = torch.softmax(att, dim=-1)
            o = torch.einsum("gnqk,kgd->qgnd", p, v.float()).to(x.dtype)
            x = x + self._layer_mm(o.reshape(S0, self.nh * self.hd), "wo",
                                   l)
            x = self._mlp(x, l)
        last = x[max(int(true_len) - 1, 0)]
        logits = self._head_logits(_rms(last[None], self.norm_w,
                                        self.eps))[0]
        return self._encode_first_token(logits)

    @torch.no_grad()
    def _prefill_warm(self, ids, start, true_len, table, kpool, vpool):
        """Pool-mapped (warm) prefill (the JAX engine's
        `_prefill_warm_impl`): compute only the suffix of a prompt whose
        first ``start`` tokens have KV in ``table``'s blocks already. ids
        [S0pad] holds the suffix padded to its bucket, true_len its real
        length; table [MB] int32. Each suffix token is one query row of
        `_paged_step` at position min(start + i, max_len - 1), attending
        with its own seq_len and the prompt's table, so the decode kernel
        reads the cached blocks and row i sees the rows before it; rows at
        or past true_len write into the trash block. Every cache-on
        prefill runs here, a miss with start 0. Returns the encoded first
        token of row true_len - 1 (the head runs on that row alone)."""
        S0 = ids.shape[0]
        ii = torch.arange(S0, device=ids.device, dtype=torch.int32)
        pos = torch.clamp(ii + int(start), max=self.max_len - 1)
        tabs = table[None, :].expand(S0, -1)
        x = self._paged_layers(ids, pos, tabs, kpool, vpool,
                               ii < int(true_len))
        last = x[max(int(true_len) - 1, 0)]
        logits = self._head_logits(_rms(last[None], self.norm_w,
                                        self.eps))[0]
        return self._encode_first_token(logits)

    @torch.no_grad()
    def _cow_copy(self, kpool, vpool, src, dst):
        """Copy pool block ``src`` into ``dst`` in every layer, K and V
        (codes and scales of a QuantizedPool): the copy-on-write fork of a
        fully cached prompt's boundary block."""
        for pool in (kpool, vpool):
            for t in _pool_leaves(pool):
                t[:, int(dst)].copy_(t[:, int(src)])

    # -- continuous batching ----------------------------------------------
    def serve(self, requests, max_new_tokens=32, eos_token_id=None,
              chunk=8, pad_token_id=0, admission_timeout_s=None,
              reject_oversized=False, spec_decode=None,
              max_restarts=3, evict_after_deferrals=2,
              max_deferrals=8, replay_backoff_s=0.05,
              max_chunk_retries=8, feed=None, feed_active=None,
              pipeline=None):
        """Continuous-batching serve loop (serving.batcher.serve_loop), with
        the JAX engine's signature. requests: (req_id, prompt) pairs,
        (req_id, prompt, max_new) triples or (req_id, prompt, max_new,
        arrival_s) quads. Returns {req_id: [generated tokens]}, post-eos
        positions padded.

        The decode state stays on the device between chunks, and
        ``pipeline`` sets the one-chunk lookahead: None (default) or True
        dispatch chunk N+1 before chunk N's tokens reach the host; False
        waits for each chunk. The token streams are the same either way.
        A slot whose logits go non-finite is quarantined and its request
        replayed from its last good token after ``replay_backoff_s`` x
        2^(restarts - 1) s, up to ``max_restarts`` times, then given up
        with its partial stream (``quarantines``, ``replays``,
        ``replay_giveups``). A cache-on engine maps cached prefixes and
        prefills only the rest (``prefix_cache.stats``,
        ``prefill_device_calls``, ``prefill_tokens_computed``).
        spec_decode, feed and feed_active raise NotImplementedError, and
        so do evict_after_deferrals, max_deferrals and max_chunk_retries
        (the headroom guard's and the chunk-fault sites') unless they hold
        their defaults."""
        from ..serving.batcher import serve_loop
        return serve_loop(
            self, requests, max_new_tokens=max_new_tokens,
            eos_token_id=eos_token_id, chunk=chunk,
            pad_token_id=pad_token_id,
            admission_timeout_s=admission_timeout_s,
            reject_oversized=reject_oversized, spec_decode=spec_decode,
            max_restarts=max_restarts,
            evict_after_deferrals=evict_after_deferrals,
            max_deferrals=max_deferrals,
            replay_backoff_s=replay_backoff_s,
            max_chunk_retries=max_chunk_retries, feed=feed,
            feed_active=feed_active, pipeline=pipeline)
