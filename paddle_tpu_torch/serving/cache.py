"""Radix prefix cache over paged KV blocks (counterpart of
paddle_tpu/serving/cache.py).

The KV of a prompt prefix is a function of its tokens alone, so once one
request has written the blocks of a prefix, a later request with the same
prefix maps those blocks into its own block table instead of computing
them again. A block is shared by writing its id into more than one table
row.

- **A radix tree of whole blocks.** A node is one full pool block, keyed
  by the tuple of ``block_size`` token ids it holds, child of the node of
  the block before it. A match walks the tree greedily and is always a
  whole number of blocks: a partial block's tail differs per request.
- **Refcounted copy-on-write sharing.** The pool's BlockAllocator counts
  references: a slot holds one for every block of its table (fresh blocks
  are born at 1; mapped shared blocks take one more in :meth:`acquire`)
  and the cache one for every node. ``free`` returns a block to the free
  list only at 0, so a retiring request never takes KV from under another
  request or the cache. Shared blocks are read-only: decode writes land
  past the shared span, and a fully cached prompt copies its boundary
  block on the device first (``plan_prefix``'s COW source).
- **Insert at retirement.** A retiring request's resident chain (prompt +
  generated tokens with KV in the pool) is adopted block by block; a
  chain already in the tree dedupes onto its nodes and the retiree's copy
  frees.
- **LRU leaf eviction, never a live block.** Under pool pressure the
  serving loop calls :meth:`evict`, which frees the coldest leaves whose
  blocks only the cache holds (refcount 1). Freeing a leaf may expose its
  parent, so cold subtrees drain back to front.

``stats`` tallies hits, misses, blocks_shared, tokens_saved,
evicted_blocks, cow_copies and inserted_blocks on the host. The JAX
package's host-memory offload tier (its pager and host block counts) is
not ported: ``PagedDecoder(kv_offload=...)`` raises.
"""
from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["RadixPrefixCache", "PrefixMatch", "plan_prefix"]


class _Node:
    __slots__ = ("key", "block", "parent", "children", "last_used")

    def __init__(self, key, block, parent):
        self.key = key            # tuple of block_size token ids
        self.block = block        # pool block id (the cache holds one ref)
        self.parent = parent
        self.children = {}        # key tuple -> _Node
        self.last_used = 0


@dataclass
class PrefixMatch:
    """The longest cached block chain that prefixes a prompt (result of
    :meth:`RadixPrefixCache.match`); ``tokens`` is ``len(blocks) *
    block_size``."""
    blocks: list = field(default_factory=list)
    nodes: list = field(default_factory=list)
    tokens: int = 0


class RadixPrefixCache:
    """Block-granular radix tree over a BlockAllocator's pool.
    ``max_blocks`` caps the blocks the cache holds (LRU-evicted down at
    insert); None bounds it by pool pressure alone."""

    def __init__(self, block_size, allocator, max_blocks=None):
        self.block_size = int(block_size)
        self.allocator = allocator
        self.max_blocks = None if max_blocks is None else int(max_blocks)
        self._root = _Node(None, None, None)
        self._clock = 0
        self._n_blocks = 0
        self.stats = {"hits": 0, "misses": 0, "blocks_shared": 0,
                      "tokens_saved": 0, "evicted_blocks": 0,
                      "cow_copies": 0, "inserted_blocks": 0}

    @property
    def held_blocks(self):
        """Pool blocks the cache holds a reference on."""
        return self._n_blocks

    # -- matching and sharing ----------------------------------------------
    def match(self, tokens):
        """The longest cached block chain that prefixes ``tokens`` (ints).
        A pure read: no reference moves until :meth:`acquire`."""
        bs = self.block_size
        node = self._root
        out = PrefixMatch()
        for b in range(len(tokens) // bs):
            child = node.children.get(tuple(tokens[b * bs:(b + 1) * bs]))
            if child is None:
                break
            out.blocks.append(child.block)
            out.nodes.append(child)
            node = child
        out.tokens = len(out.blocks) * bs
        return out

    def acquire(self, match, nblocks):
        """Take one slot reference on the first ``nblocks`` blocks of a
        match and touch their nodes' LRU clocks; returns the block ids.
        It cannot fail, so the caller makes its fresh alloc first."""
        self._clock += 1
        blocks = []
        for node in match.nodes[:nblocks]:
            self.allocator.retain(node.block)
            node.last_used = self._clock
            blocks.append(node.block)
        return blocks

    def record_admission(self, cached_tokens, blocks_shared, cow=False):
        """Tally one admission's outcome (a hit saved at least one prefill
        token)."""
        st = self.stats
        if cached_tokens > 0:
            st["hits"] += 1
            st["tokens_saved"] += int(cached_tokens)
            st["blocks_shared"] += int(blocks_shared)
        else:
            st["misses"] += 1
        if cow:
            st["cow_copies"] += 1

    # -- insertion ---------------------------------------------------------
    def insert(self, tokens, blocks):
        """Adopt the whole-block chain of ``tokens`` (its KV in ``blocks``,
        in table order). Existing nodes dedupe; a new node takes one cache
        reference on its block. Returns the number of blocks adopted."""
        bs = self.block_size
        node = self._root
        adopted = 0
        self._clock += 1
        for b in range(min(len(tokens) // bs, len(blocks))):
            key = tuple(int(t) for t in tokens[b * bs:(b + 1) * bs])
            child = node.children.get(key)
            if child is None:
                child = _Node(key, int(blocks[b]), node)
                self.allocator.retain(child.block)
                node.children[key] = child
                adopted += 1
                self._n_blocks += 1
            child.last_used = self._clock
            node = child
        self.stats["inserted_blocks"] += adopted
        if self.max_blocks is not None and self._n_blocks > self.max_blocks:
            self.evict(self._n_blocks - self.max_blocks)
        return adopted

    # -- eviction ----------------------------------------------------------
    def _evictable_leaves(self):
        out = []
        stack = [self._root]
        while stack:
            n = stack.pop()
            if (n is not self._root and not n.children
                    and self.allocator.refcount(n.block) == 1):
                out.append(n)
            stack.extend(n.children.values())
        return out

    def evict(self, need_blocks):
        """Free up to ``need_blocks`` of the coldest leaves whose blocks
        only the cache holds (a block a live table maps is never freed),
        cascading into parents a freed leaf exposes. Returns the blocks
        freed."""
        freed = 0
        while freed < need_blocks:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            leaves.sort(key=lambda n: n.last_used)
            for n in leaves:
                if freed >= need_blocks:
                    break
                del n.parent.children[n.key]
                self.allocator.free([n.block])
                self._n_blocks -= 1
                freed += 1
        self.stats["evicted_blocks"] += freed
        return freed

    def clear(self):
        """Release every cache reference (the engine's pools were reset:
        the cached KV is gone)."""
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            self.allocator.free([n.block])
        self._root = _Node(None, None, None)
        self._n_blocks = 0


def plan_prefix(cache, ids_full, s0):
    """Admission plan against ``cache`` for a prompt of ``s0`` tokens
    (``ids_full`` may go on past s0 with a replay's tokens; only the prompt
    is matched): ``(match, shared_blocks, cached_tokens, cow_src_block)``.

    - A partial hit maps the matched whole blocks; the warm prefill
      computes the suffix from the first uncached position.
    - A full hit still needs the logits at position s0 - 1, and decode
      goes on writing into the block that holds it: the cached span is
      capped at s0 - 1, the first (s0 - 1) // bs blocks are mapped, and
      the boundary block is copied on the device from ``cow_src_block``
      before a one-token warm prefill computes position s0 - 1 again.
    """
    if cache is None:
        return None, 0, 0, None
    m = cache.match(list(ids_full[:s0]))
    if m.tokens >= s0:
        cached = s0 - 1
        kb = cached // cache.block_size
        return m, kb, cached, m.nodes[kb].block
    return m, len(m.blocks), m.tokens, None
