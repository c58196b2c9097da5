"""Copy-on-write prefix cache: token prefixes hashed to KV block chains.

Counterpart of ``mxnet_tpu/serving/frontend/prefix_cache.py``, the same
host logic over the port's :class:`~..kv_cache.PagedKVCache`.  The cache
remembers, per physical block, which token chain produced it, so a
request whose prompt starts with a cached chain adopts the blocks (a
refcount bump, no compute) and only the uncached suffix is prefilled,
through the engine's packed ``chunk`` step.

Structure: a trie of nodes keyed by ``(parent_key, block_tokens)``; the
dict key is the hash of the whole token prefix up to that block (each
key embeds its parent's).  Full-block nodes chain; one partial tail node
per insertion remembers a block whose last positions are still unwritten
(a 12-token system prompt at block_size 8 caches one full block and a
4-token partial).  An adopter's next write lands in that partial block,
``PagedKVCache.prepare_write`` sees refcount > 1 and the engine forks it
(``InferenceEngine.reserve``), and the cached original keeps serving
other requests unchanged.

Every node holds ONE reference on its block.  Eviction (LRU, leaf first)
only drops that reference: a block a live sequence still reads has
refcount > 1 and stays in the pool, so eviction under block pressure
never corrupts a request in flight.

One owner: a PrefixCache belongs to one engine and is touched only from
the thread that serves that engine; it takes no lock.  The reference's telemetry
gauge (``serving.prefix_hit_rate``) is not ported (ROADMAP §1 item 11);
:meth:`PrefixCache.hit_rate` and :meth:`PrefixCache.stats` give the
same numbers.
"""
from __future__ import annotations

__all__ = ["PrefixCache"]


class _Node:
    __slots__ = ("key", "parent", "block", "n_tokens", "partial",
                 "children", "tick")

    def __init__(self, key, parent, block, n_tokens, partial, tick):
        self.key = key
        self.parent = parent          # parent _Node or None (root child)
        self.block = block            # physical block id (one ref held)
        self.n_tokens = n_tokens      # tokens cached in this block
        self.partial = partial        # True: block tail still unwritten
        self.children = 0             # live child-node count
        self.tick = tick              # LRU stamp (deterministic counter)


class PrefixCache:
    """Block-chain prefix cache over one :class:`PagedKVCache`.

    Parameters
    ----------
    cache : the engine's PagedKVCache (chains hold refs on its blocks).
    max_nodes : soft cap on cached nodes; inserting past it evicts LRU
        leaves first (0 = unbounded, eviction only under pool pressure).
    """

    def __init__(self, cache, max_nodes=0):
        self.cache = cache
        self.max_nodes = int(max_nodes)
        self._nodes = {}      # key -> _Node
        # parent_key -> set of child keys: the downward index the
        # draft-source trie walk needs (lookup/attach only ever descend
        # by KNOWN tokens; a draft asks "what comes next?")
        self._childmap = {}
        self._tick = 0        # deterministic LRU clock (no wall time)
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0   # positions served from cache, cumulative
        self.evictions = 0

    # -- key construction ------------------------------------------------

    @staticmethod
    def _key(parent_key, tokens):
        return (parent_key, tuple(int(t) for t in tokens))

    def _bump(self, node):
        self._tick += 1
        # refresh the whole chain: a leaf hit keeps its ancestors warm
        # (an ancestor must never be evicted before its children anyway,
        # but LRU order should reflect reachability)
        while node is not None:
            node.tick = self._tick
            node = node.parent

    # -- the read path ---------------------------------------------------

    def lookup(self, tokens):
        """Longest cached chain prefixing ``tokens``, capped at
        ``len(tokens) - 1`` positions (at least one token must be
        computed to produce logits).  Returns ``(n_tokens, blocks)``
        with refcounts UNTOUCHED — :meth:`attach` takes the references.
        """
        bs = self.cache.block_size
        toks = [int(t) for t in tokens]
        limit = len(toks) - 1
        parent = None
        parent_key = None
        blocks = []
        n = 0
        while n + bs <= limit:
            key = self._key(parent_key, toks[n:n + bs])
            node = self._nodes.get(key)
            if node is None or node.partial:
                break
            blocks.append(node.block)
            n += bs
            parent, parent_key = node, key
        # partial tail: the longest cached sub-block continuation
        for ln in range(min(bs - 1, limit - n), 0, -1):
            key = self._key(parent_key, toks[n:n + ln])
            node = self._nodes.get(key)
            if node is not None and node.partial:
                blocks.append(node.block)
                n += ln
                parent = node
                break
        self.lookups += 1
        if n:
            self.hits += 1
            self.hit_tokens += n
            self._bump(parent)
        return n, blocks

    def continuation(self, tokens, k):
        """Draft-source trie walk: the cached continuation of
        the FULL sequence ``tokens``, up to ``k`` tokens — what some
        earlier request generated/prompted AFTER this exact prefix.

        Refcount-NEUTRAL by contract: a draft is a guess for the verify
        step, not an adoption — no references are taken, no LRU ticks
        are spent, no hit accounting moves.  The returned tokens stay
        valid even if the chain is evicted before the verify dispatch
        (they are plain ints; a wrong guess just fails acceptance)."""
        bs = self.cache.block_size
        toks = [int(t) for t in tokens]
        n = 0
        parent_key = None
        # descend the full-block chain covering ``tokens`` exactly
        while n + bs <= len(toks):
            key = self._key(parent_key, toks[n:n + bs])
            node = self._nodes.get(key)
            if node is None or node.partial:
                break
            n += bs
            parent_key = key
        rem = tuple(toks[n:])
        out = []
        while len(out) < int(k):
            nxt = None
            # deterministic: smallest token tuple among matching children
            for key in sorted(self._childmap.get(parent_key, ()),
                              key=lambda kk: kk[1]):
                bt = key[1]
                if len(bt) > len(rem) and bt[:len(rem)] == rem:
                    node = self._nodes.get(key)
                    if node is not None:
                        nxt = (key, node, bt)
                        break
            if nxt is None:
                break
            key, node, bt = nxt
            out.extend(bt[len(rem):])
            if node.partial:
                break             # partial tail: the chain ends here
            parent_key, rem = key, ()
        return out[:int(k)]

    def attach(self, slot, tokens):
        """Adopt the longest cached chain into ``slot`` (one ref per
        block) and return the cached position count (0 = miss; the
        caller allocates from scratch)."""
        n, blocks = self.lookup(tokens)
        if n:
            self.cache.adopt(slot, blocks, n)
        return n

    # -- the write path --------------------------------------------------

    def insert(self, slot, tokens):
        """Register ``slot``'s prefilled prompt: one node per full
        block, plus a partial node for the tail sub-block (if any and
        if at least one token long).  Blocks already chained are
        skipped; new nodes take one reference each so the chain
        survives the sequence's release."""
        bs = self.cache.block_size
        toks = [int(t) for t in tokens]
        table = self.cache.table(slot)
        parent = None
        parent_key = None
        n = 0
        idx = 0
        while n + bs <= len(toks):
            key = self._key(parent_key, toks[n:n + bs])
            node = self._nodes.get(key)
            if node is None:
                node = self._new_node(key, parent, table[idx],
                                      bs, partial=False)
                if node is None:    # cap reached, nothing evictable
                    return
            parent, parent_key = node, key
            n += bs
            idx += 1
        rem = len(toks) - n
        if rem > 0 and idx < len(table):
            key = self._key(parent_key, toks[n:])
            if key not in self._nodes:
                self._new_node(key, parent, table[idx], rem, partial=True)

    def _new_node(self, key, parent, block, n_tokens, partial):
        if self.max_nodes and len(self._nodes) >= self.max_nodes:
            if not self.evict(blocks_needed=0, nodes_needed=1):
                return None
        self.cache.ref(block)
        self._tick += 1
        node = _Node(key, parent, block, n_tokens, partial, self._tick)
        self._nodes[key] = node
        self._childmap.setdefault(key[0], set()).add(key)
        if parent is not None:
            parent.children += 1
        return node

    # -- eviction --------------------------------------------------------

    def evict(self, blocks_needed=1, nodes_needed=0):
        """Drop LRU LEAF nodes until the pool has ``blocks_needed``
        free blocks (and/or ``nodes_needed`` node slots).  Only the
        cache's own reference is dropped — a block a live sequence
        shares keeps its other refcounts and is NOT returned to the
        free list (``PagedKVCache.unref`` recycles at zero only).
        Returns the number of nodes evicted."""
        dropped = 0
        while (self.cache.num_free_blocks < blocks_needed or
               dropped < nodes_needed):
            leaves = [nd for nd in self._nodes.values()
                      if nd.children == 0]
            if not leaves:
                break
            victim = min(leaves, key=lambda nd: nd.tick)
            del self._nodes[victim.key]
            sibs = self._childmap.get(victim.key[0])
            if sibs is not None:
                sibs.discard(victim.key)
                if not sibs:
                    del self._childmap[victim.key[0]]
            if victim.parent is not None:
                victim.parent.children -= 1
            self.cache.unref(victim.block)
            self.evictions += 1
            dropped += 1
        return dropped

    def clear(self):
        """Drop every chain (shutdown / tests)."""
        for node in self._nodes.values():
            self.cache.unref(node.block)
        self._nodes.clear()
        self._childmap.clear()

    # -- stats -----------------------------------------------------------

    def hit_rate(self):
        return self.hits / self.lookups if self.lookups else None

    def held_blocks(self):
        """References this cache holds (the ``holders`` argument for
        ``PagedKVCache.check_leaks``)."""
        return len(self._nodes)

    def stats(self):
        return {"nodes": len(self._nodes),
                "lookups": self.lookups, "hits": self.hits,
                "hit_rate": (round(self.hit_rate(), 4)
                             if self.lookups else None),
                "hit_tokens": self.hit_tokens,
                "evictions": self.evictions}
