"""Cross-request radix prefix index over the paged KV pool, device tier
(counterpart of ``paddle_tpu/inference/prefix_cache.py`` without its host
and disk tiers).

Many requests share a few system prompts, so the KV rows of those prefixes
would be recomputed on every admission unless something remembers which
physical pages already hold them. This is that memory: a radix tree at
block granularity (one node is one full ``block_size``-token block is one
physical page), on the host only:

  * ``match(tokens)``: the longest cached prefix as a node path; admission
    points the slot's block-table entries at those pages and prefills only
    the suffix (``paged_prefill_into``'s ``dec_base`` append mode).
  * ``pin``/``unpin``: per-node refcounts. A page a live slot uses is never
    evicted; release decrements and stamps LRU recency.
  * ``insert``: after prefill, the request's full prompt blocks are adopted
    into the tree (the page moves from the slot to the cache), so the next
    request with this prefix hits.
  * ``evict(n)``: LRU eviction of unpinned chains under page pressure,
    deepest first; returns the freed page ids to the batcher's pool.
    Interior nodes stay while a descendant lives (a child's rows attend the
    whole prefix).

Only full blocks are cached: a partly filled page is still being appended
to by its owner. Generated tokens are cacheable too: a preempted request
resumes with ``prompt + generated`` as its admission ids.

Every node carries a chain hash (``h_i = H(h_{i-1}, block_tokens)``);
``summary()`` exposes the hash set, so a router can see what is cached
without the token arrays. Hashes are a routing hint only; the tree compares
real token blocks.

Not ported yet (ROADMAP.md, queue 1, item 1.4): ``HostTier``, ``DiskTier``,
demotion and promotion, session pins. The constructor raises when given a
host tier.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["RadixPrefixCache", "chain_hashes"]

_ROOT_HASH = 0


def _block_hash(parent_hash: int, block: Tuple[int, ...]) -> int:
    """Stable 64-bit chain hash of one block given its parent's hash."""
    h = hashlib.blake2b(digest_size=8)
    h.update(int(parent_hash).to_bytes(8, "little", signed=False))
    h.update(np.asarray(block, np.int64).tobytes())
    return int.from_bytes(h.digest(), "little")


def chain_hashes(tokens, block_size: int) -> List[int]:
    """Chain hashes of every full block prefix of ``tokens``: the
    request's half of the replica prefix-summary protocol."""
    toks = np.asarray(tokens, np.int64).reshape(-1)
    out: List[int] = []
    h = _ROOT_HASH
    for i in range(len(toks) // block_size):
        blk = tuple(int(t) for t in
                    toks[i * block_size:(i + 1) * block_size])
        h = _block_hash(h, blk)
        out.append(h)
    return out


class _Node:
    __slots__ = ("key", "page", "parent", "children", "ref", "last_use",
                 "hash", "depth", "residency")

    def __init__(self, key: Tuple[int, ...], page: int, parent, hash_: int,
                 depth: int):
        self.key = key              # the block's tokens
        self.page = page            # physical pool row
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.ref = 0                # live slots using this node
        self.last_use = 0           # LRU stamp (monotonic tick)
        self.hash = hash_
        self.depth = depth          # blocks from root (root excluded)
        # every node is on the device until the tiers are ported
        self.residency = "device"

    def __repr__(self):            # pragma: no cover - debug aid
        return (f"_Node(depth={self.depth}, page={self.page}, "
                f"ref={self.ref}, kids={len(self.children)})")


class RadixPrefixCache:
    """Block-granular radix tree mapping token-block chains to pages."""

    def __init__(self, block_size: int, host_tier=None, spill=None):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        if host_tier is not None or spill is not None:
            raise NotImplementedError(
                "RadixPrefixCache: the host and disk tiers are not ported "
                "yet (ROADMAP.md, queue 1, item 1.4)")
        self.block_size = block_size
        self._root = _Node((), -1, None, _ROOT_HASH, 0)
        self._tick = 0
        self._nodes = 0
        # cumulative counters (the batcher mirrors them into serving.*)
        self.hit_tokens = 0
        self.miss_tokens = 0
        self.evictions = 0
        self._summary_cache: Optional[Dict[str, object]] = None

    # -- bookkeeping ---------------------------------------------------------
    def _touch(self, node: _Node):
        self._tick += 1
        node.last_use = self._tick

    def _invalidate(self):
        self._summary_cache = None

    def __len__(self) -> int:
        return self._nodes

    @property
    def cached_pages(self) -> int:
        return self._nodes

    def _walk(self):
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    def pages(self) -> List[int]:
        """Every physical page the cache owns (the audit surface)."""
        return [n.page for n in self._walk()]

    def evictable_pages(self) -> int:
        """Pages evict() could free right now: one walk sharing evict()'s
        victim rule (a node frees when its whole subtree is unpinned), so
        the two cannot drift."""
        def walk(n: _Node) -> Tuple[int, bool]:
            count, free = 0, n.ref == 0
            for c in n.children.values():
                sub, sub_free = walk(c)
                count += sub
                free = free and sub_free
            return count + (1 if free else 0), free

        return sum(walk(c)[0] for c in self._root.children.values())

    # -- the serving hot path ------------------------------------------------
    def _blocks(self, tokens) -> List[Tuple[int, ...]]:
        toks = np.asarray(tokens, np.int64).reshape(-1)
        return [tuple(int(t) for t in
                      toks[i * self.block_size:(i + 1) * self.block_size])
                for i in range(len(toks) // self.block_size)]

    def match(self, tokens, max_blocks: Optional[int] = None) -> List[_Node]:
        """Longest cached prefix of ``tokens`` as the node path (root
        excluded), capped at ``max_blocks``. Does not pin: the caller pins
        the path it uses."""
        path: List[_Node] = []
        node = self._root
        for blk in self._blocks(tokens):
            if max_blocks is not None and len(path) >= max_blocks:
                break
            child = node.children.get(blk)
            if child is None:
                break
            path.append(child)
            node = child
        return path

    @staticmethod
    def split_device(path: Sequence[_Node]) -> Tuple[List[_Node],
                                                     List[_Node]]:
        """Split a match path into (device prefix, off-device tail). Every
        node is on the device here, so the tail is empty."""
        return list(path), []

    def pin(self, nodes: Iterable[_Node]):
        for n in nodes:
            n.ref += 1
            self._touch(n)

    def unpin(self, nodes: Iterable[_Node]):
        for n in nodes:
            if n.ref <= 0:
                raise RuntimeError(
                    "prefix-cache refcount underflow: unpin of an "
                    "already-free node (double release)")
            n.ref -= 1
            self._touch(n)

    def insert(self, tokens, pages: Sequence[int],
               start_block: int, n_blocks: int) -> List[_Node]:
        """Adopt blocks [start_block, n_blocks) of ``tokens`` into the tree.
        ``pages[i]`` is the physical page holding block i's rows (the
        slot's block-table row). New nodes take ownership of their page and
        start pinned (ref 1, held by the inserting slot); blocks already in
        the tree are skipped: the slot keeps its private copy and the tree
        its own page (neither is pinned here). Returns the new nodes."""
        blocks = self._blocks(tokens)[:n_blocks]
        node = self._root
        created: List[_Node] = []
        for i, blk in enumerate(blocks):
            child = node.children.get(blk)
            if child is None:
                if i < start_block:
                    # the caller said blocks < start_block are in the tree
                    # (its matched path); a hole means match and insert
                    # disagree about the tree
                    raise RuntimeError(
                        "prefix-cache insert: matched prefix missing "
                        "from the tree (match/insert raced?)")
                child = _Node(blk, int(pages[i]), node,
                              _block_hash(node.hash, blk), i + 1)
                child.ref = 1
                node.children[blk] = child
                self._nodes += 1
                created.append(child)
                self._invalidate()
            self._touch(child)
            node = child
        return created

    # -- eviction ------------------------------------------------------------
    def evict(self, n_pages: int) -> List[int]:
        """Free up to ``n_pages`` pages: LRU leaves with no pin, taken one
        at a time, so an idle chain frees bottom-up. Returns the freed
        page ids."""
        freed: List[int] = []
        while len(freed) < n_pages:
            victim = self._lru_device_evictable()
            if victim is None:
                break
            self._drop_subtree(victim)
            self.evictions += 1
            freed.append(victim.page)
        return freed

    def _lru_device_evictable(self) -> Optional[_Node]:
        best: Optional[_Node] = None
        for n in self._walk():
            if not n.children and n.ref == 0:
                if best is None or n.last_use < best.last_use:
                    best = n
        return best

    def _drop_subtree(self, node: _Node):
        """Remove a node and everything below it from the tree."""
        stack = [node]
        while stack:
            n = stack.pop()
            self._nodes -= 1
            stack.extend(n.children.values())
        del node.parent.children[node.key]
        self._invalidate()

    # -- the routing surface -------------------------------------------------
    def summary(self) -> Dict[str, object]:
        """Hashed prefix advertisement for a router:
        ``{"block_size": B, "hashes": {chain_hash: depth_blocks},
        "tiers": {chain_hash: "device"}}``. Cached; every mutation
        invalidates it, so evicted chains vanish from routing at once."""
        if self._summary_cache is None:
            nodes = list(self._walk())
            self._summary_cache = {
                "block_size": self.block_size,
                "hashes": {n.hash: n.depth for n in nodes},
                "tiers": {n.hash: n.residency for n in nodes}}
        return self._summary_cache

    # -- audits / stats ------------------------------------------------------
    def audit_tiers(self) -> Dict[str, int]:
        """The tier half of the batcher's page audit. With no tier attached
        there is nothing to reconcile: the untiered report is empty."""
        return {}

    def stats(self) -> Dict[str, int]:
        """The JAX package's keys; the tier counters stay 0 until the
        tiers are ported."""
        tiers = dict.fromkeys(
            ("demotions", "demote_failures", "demoted_bytes", "promotions",
             "promoted_bytes", "promotion_failures", "upgrades",
             "session_pinned_nodes", "session_pin_drops", "host_nodes",
             "host_bytes", "disk_nodes", "disk_bytes"), 0)
        return {"nodes": self._nodes, "cached_pages": self._nodes,
                "hit_tokens": self.hit_tokens,
                "miss_tokens": self.miss_tokens, "host_hit_tokens": 0,
                "evictions": self.evictions, **tiers}
