"""Cross-request radix prefix index over the paged KV pool, with host and
disk tiers beneath it (counterpart of
``paddle_tpu/inference/prefix_cache.py``).

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
  * ``evict(n)``: LRU eviction of unpinned device chains under page
    pressure, deepest first; returns the freed page ids to the batcher's
    pool. Interior nodes stay while a device descendant lives (a child's
    rows attend the whole prefix).

Tiered residency: each node carries a ``residency`` in the monotone chain
``device -> host -> disk -> gone``. With a ``HostTier`` attached,
``evict()`` demotes the victim's KV rows to a host blob (read off the pool
by the batcher's spill callback) instead of dropping them; the node stays
in the tree, pageless, and a later ``match`` that lands on it lets the
batcher promote it back with an asynchronous copy (this module tracks only
residency and blob bytes). The host tier is bounded in bytes
(``PADDLE_KV_HOST_GIB``); its overflow demotes host-LRU nodes to an
optional ``DiskTier`` behind the same interface, or drops them. Residency
never decreases with depth along a root-to-leaf path (eviction takes the
deepest device nodes first, promotion installs top-down), so ``match``
splits any path into a device prefix and a promotable tail.

Blobs are trees of dicts, lists and tuples whose leaves are CPU tensors
(pinned when the pool is on the card) or numpy arrays; ``blob_nbytes``
counts both, so a float32 pool on the CPU accounts the same bytes as the
JAX package's numpy blobs. ``DiskTier`` stores a bfloat16 leaf (which
numpy lacks) as its int16 bits and restores it bit for bit.

Only full blocks are cached: a partly filled page is still being appended
to by its owner. Generated tokens are cacheable too: a preempted request
resumes with ``prompt + generated`` as its admission ids.

Every node carries a chain hash (``h_i = H(h_{i-1}, block_tokens)``);
``summary()`` exposes the hash set and each hash's tier, so a router can
see what is cached, and where, without the token arrays. Hashes are a
routing hint only; the tree compares real token blocks.
"""
from __future__ import annotations

import hashlib
import os
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["RadixPrefixCache", "HostTier", "DiskTier", "chain_hashes",
           "blob_nbytes"]

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


def blob_nbytes(blob) -> int:
    """Total bytes of every tensor or ndarray leaf in a spilled KV blob (a
    tree of lists, tuples and dicts): the tier accounting unit."""
    if isinstance(blob, torch.Tensor):
        return blob.numel() * blob.element_size()
    if isinstance(blob, np.ndarray):
        return int(blob.nbytes)
    if isinstance(blob, dict):
        return sum(blob_nbytes(v) for v in blob.values())
    if isinstance(blob, (list, tuple)):
        return sum(blob_nbytes(v) for v in blob)
    return 0


class HostTier:
    """Host-memory blob store for demoted KV blocks, bounded in bytes.

    The radix tree owns victim selection (LRU over host-resident nodes)
    and the residency state machine; the tier owns storage and byte
    accounting. ``next_tier`` (a :class:`DiskTier`) receives this tier's
    overflow; without one, overflow is dropped (residency ``gone``).
    """

    name = "host"

    def __init__(self, capacity_bytes: int,
                 next_tier: Optional["DiskTier"] = None):
        if capacity_bytes < 1:
            raise ValueError("host tier capacity must be >= 1 byte")
        self.capacity_bytes = int(capacity_bytes)
        self.next_tier = next_tier
        self._blobs: Dict[int, Tuple[object, int]] = {}  # id -> (blob, nbytes)
        self.used_bytes = 0
        self.stored = 0
        self.evicted = 0  # pushed out of this tier (to the next, or gone)

    def put(self, key: int, blob) -> int:
        nbytes = blob_nbytes(blob)
        self._blobs[key] = (blob, nbytes)
        self.used_bytes += nbytes
        self.stored += 1
        return nbytes

    def get(self, key: int):
        return self._blobs[key][0]

    def nbytes_of(self, key: int) -> int:
        return self._blobs[key][1]

    def discard(self, key: int) -> int:
        _, nbytes = self._blobs.pop(key)
        self.used_bytes -= nbytes
        return nbytes

    def __contains__(self, key: int) -> bool:
        return key in self._blobs

    def __len__(self) -> int:
        return len(self._blobs)

    def keys(self):
        return self._blobs.keys()


class DiskTier:
    """Disk-backed blob store behind the same interface as HostTier.

    Blobs land as one ``.npz`` file each under ``root`` (flattened with
    positional keys, rebuilt on ``get``), in the JAX package's layout: an
    ``__skeleton__`` entry holds the tree with each leaf replaced by its
    flat key. Tensor leaves are listed, with their dtype, in a
    ``__torch__`` entry and come back as CPU tensors; a bfloat16 leaf is
    stored as its int16 bits. Capacity is bounded in bytes like the host
    tier's; there is no tier below, so overflow is dropped.
    """

    name = "disk"
    next_tier = None

    def __init__(self, root: str, capacity_bytes: int = 16 << 30):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.capacity_bytes = int(capacity_bytes)
        self._files: Dict[int, Tuple[str, int]] = {}  # id -> (path, nbytes)
        self._seq = 0
        self.used_bytes = 0
        self.stored = 0
        self.evicted = 0

    @staticmethod
    def _flatten(blob, prefix: str, out: Dict[str, np.ndarray],
                 dtypes: Dict[str, str]):
        if isinstance(blob, torch.Tensor):
            t = blob.detach().cpu()
            dtypes[prefix] = str(t.dtype).replace("torch.", "")
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            out[prefix] = t.numpy()
        elif isinstance(blob, np.ndarray):
            out[prefix] = blob
        elif isinstance(blob, dict):
            for k in sorted(blob):
                DiskTier._flatten(blob[k], f"{prefix}.d{k}", out, dtypes)
        elif isinstance(blob, (list, tuple)):
            for i, v in enumerate(blob):
                DiskTier._flatten(v, f"{prefix}.l{i}", out, dtypes)

    def put(self, key: int, blob) -> int:
        # keep the tree beside the arrays: a flat dict and a rebuild
        # skeleton (leaves replaced by their flat key)
        flat: Dict[str, np.ndarray] = {}
        dtypes: Dict[str, str] = {}
        self._flatten(blob, "b", flat, dtypes)
        skeleton = _skeletonize(blob, "b")
        self._seq += 1
        path = os.path.join(self.root, f"kv_{self._seq:08d}.npz")
        np.savez(path, __skeleton__=np.frombuffer(
            repr(skeleton).encode(), dtype=np.uint8),
            __torch__=np.frombuffer(repr(dtypes).encode(), dtype=np.uint8),
            **flat)
        nbytes = sum(int(a.nbytes) for a in flat.values())
        self._files[key] = (path, nbytes)
        self.used_bytes += nbytes
        self.stored += 1
        return nbytes

    def get(self, key: int):
        path, _ = self._files[key]
        with np.load(path) as z:
            skeleton = eval(  # noqa: S307 — repr of plain str/list/dict/tuple
                bytes(z["__skeleton__"]).decode())
            dtypes = eval(  # noqa: S307 — repr of a dict of str
                bytes(z["__torch__"]).decode())
            flat = {k: z[k] for k in z.files
                    if k not in ("__skeleton__", "__torch__")}
        for k, name in dtypes.items():
            t = torch.from_numpy(flat[k])
            flat[k] = (t.view(torch.bfloat16) if name == "bfloat16"
                       else t)
        return _unskeletonize(skeleton, flat)

    def nbytes_of(self, key: int) -> int:
        return self._files[key][1]

    def discard(self, key: int) -> int:
        path, nbytes = self._files.pop(key)
        try:
            os.unlink(path)
        except OSError:
            pass
        self.used_bytes -= nbytes
        return nbytes

    def __contains__(self, key: int) -> bool:
        return key in self._files

    def __len__(self) -> int:
        return len(self._files)

    def keys(self):
        return self._files.keys()


def _skeletonize(blob, prefix: str):
    if isinstance(blob, (np.ndarray, torch.Tensor)):
        return prefix
    if isinstance(blob, dict):
        return {k: _skeletonize(blob[k], f"{prefix}.d{k}")
                for k in sorted(blob)}
    if isinstance(blob, (list, tuple)):
        out = [_skeletonize(v, f"{prefix}.l{i}") for i, v in enumerate(blob)]
        return tuple(out) if isinstance(blob, tuple) else out
    return blob


def _unskeletonize(skel, flat: Dict[str, object]):
    if isinstance(skel, str) and skel in flat:
        return flat[skel]
    if isinstance(skel, dict):
        return {k: _unskeletonize(v, flat) for k, v in skel.items()}
    if isinstance(skel, tuple):
        return tuple(_unskeletonize(v, flat) for v in skel)
    if isinstance(skel, list):
        return [_unskeletonize(v, flat) for v in skel]
    return skel


class _Node:
    __slots__ = ("key", "page", "parent", "children", "ref", "last_use",
                 "hash", "depth", "residency", "promo", "spin")

    def __init__(self, key: Tuple[int, ...], page: int, parent, hash_: int,
                 depth: int):
        self.key = key              # the block's tokens
        self.page = page            # physical pool row (-1 when off-device)
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.ref = 0                # live slots using this node
        self.last_use = 0           # LRU stamp (monotonic tick)
        self.hash = hash_
        self.depth = depth          # blocks from root (root excluded)
        self.residency = "device"
        self.promo = None           # in-flight promotion record, if any
        self.spin = 0               # session pins (durable-session holds)

    def __repr__(self):            # pragma: no cover - debug aid
        return (f"_Node(depth={self.depth}, page={self.page}, "
                f"ref={self.ref}, spin={self.spin}, tier={self.residency}, "
                f"kids={len(self.children)})")


class RadixPrefixCache:
    """Block-granular radix tree mapping token-block chains to pages,
    with optional host-DRAM (and disk) spill tiers beneath the pool.

    ``host_tier``/``spill``: attach a :class:`HostTier` and a callback
    ``spill(node) -> blob`` (the batcher reads the node's pool rows back
    to host tensors) to turn ``evict()`` into demotion. Without a tier
    the eviction semantics are byte-identical to the untiered cache.
    """

    def __init__(self, block_size: int,
                 host_tier: Optional[HostTier] = None,
                 spill: Optional[Callable[["_Node"], object]] = None):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.block_size = block_size
        self._root = _Node((), -1, None, _ROOT_HASH, 0)
        self._tick = 0
        self._nodes = 0          # every resident node (any tier)
        self._dev_nodes = 0      # device-resident nodes (== pages owned)
        self.host_tier = host_tier
        self._spill = spill
        # cumulative counters (the batcher mirrors them into serving.*)
        self.hit_tokens = 0
        self.miss_tokens = 0
        self.host_hit_tokens = 0   # matched tokens served off host/disk
        self.evictions = 0
        self.demotions = 0
        self.demote_failures = 0
        self.demoted_bytes = 0
        self.promotions = 0        # pages promoted back to device
        self.promoted_bytes = 0
        self.promotion_failures = 0
        self.upgrades = 0          # off-device nodes re-adopted via insert
        self.session_pin_drops = 0  # session-pinned nodes lost anyway
        #   (untiered eviction or a failed spill: chaos/OOM wins; the
        #   session manifest's full-prefill fallback keeps correctness)
        # cached routing advertisement (satellite: invalidate on mutation)
        self._summary_cache: Optional[Dict[str, object]] = None
        self._dirty = True

    # -- bookkeeping ---------------------------------------------------------
    def _touch(self, node: _Node):
        self._tick += 1
        node.last_use = self._tick

    def _invalidate(self):
        self._dirty = True
        self._summary_cache = None

    def __len__(self) -> int:
        return self._nodes

    @property
    def cached_pages(self) -> int:
        return self._dev_nodes

    def pages(self) -> List[int]:
        """Every physical page the cache owns (the audit surface).
        Residency is monotone, so an off-device node has no device
        descendants and its whole subtree can be pruned from the walk."""
        out: List[int] = []
        stack = [n for n in self._root.children.values()
                 if n.residency == "device"]
        while stack:
            n = stack.pop()
            out.append(n.page)
            stack.extend(c for c in n.children.values()
                         if c.residency == "device")
        return out

    def evictable_pages(self) -> int:
        """Pages evict() could free right now — ONE walk sharing evict()'s
        victim rule (a device node frees when its entire device subtree is
        unpinned and promotion-free), so the two can never drift."""
        def walk(n: _Node) -> Tuple[int, bool]:
            count = 0
            free = n.ref == 0 and n.promo is None
            for c in n.children.values():
                if c.residency != "device":
                    continue
                sub, sub_free = walk(c)
                count += sub
                free = free and sub_free
            return count + (1 if free else 0), free

        return sum(walk(c)[0] for c in self._root.children.values()
                   if c.residency == "device")

    # -- the serving hot path ------------------------------------------------
    def _blocks(self, tokens) -> List[Tuple[int, ...]]:
        toks = np.asarray(tokens, np.int64).reshape(-1)
        return [tuple(int(t) for t in
                      toks[i * self.block_size:(i + 1) * self.block_size])
                for i in range(len(toks) // self.block_size)]

    def match(self, tokens, max_blocks: Optional[int] = None) -> List[_Node]:
        """Longest cached prefix of ``tokens`` as the node path (root
        excluded), capped at ``max_blocks``. Does NOT pin — the caller
        pins the path it actually uses. With tiers the path can end in
        off-device nodes; ``split_device`` separates the promotable tail."""
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
    def split_device(path: Sequence[_Node]) -> Tuple[List[_Node], List[_Node]]:
        """Split a match path into (device prefix, off-device tail).
        Monotone residency guarantees the split point is unique."""
        for i, n in enumerate(path):
            if n.residency != "device":
                return list(path[:i]), list(path[i:])
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

    def session_pin(self, nodes: Iterable[_Node]):
        """Durable-session hold: unlike ``pin`` (which freezes pages on
        device), a session pin lets churn demote the chain device -> host
        -> disk but forbids dropping it out of the LAST tier — a paused
        session stays promotable (or at worst disk-resident) until
        ``session_unpin``. No effect on page accounting."""
        for n in nodes:
            n.spin += 1
            self._touch(n)

    def session_unpin(self, nodes: Iterable[_Node]):
        for n in nodes:
            if n.spin <= 0:
                raise RuntimeError(
                    "prefix-cache session-pin underflow: session_unpin of "
                    "an unpinned node (double release)")
            n.spin -= 1
            self._touch(n)

    def insert(self, tokens, pages: Sequence[int],
               start_block: int, n_blocks: int) -> List[_Node]:
        """Adopt blocks [start_block, n_blocks) of ``tokens`` into the
        tree. ``pages[i]`` is the physical page holding block i's rows
        (the slot's block-table row). New nodes take ownership of their
        page and start pinned (ref=1, held by the inserting slot); blocks
        already device-resident are SKIPPED — the slot keeps its private
        copy and the tree keeps its own page (neither is pinned here). An
        off-device node with no promotion in flight is UPGRADED in place:
        it adopts the slot's freshly-prefilled page, its stale blob is
        discarded, and it joins the returned (pinned) list. Returns the
        newly created/upgraded nodes."""
        blocks = self._blocks(tokens)[:n_blocks]
        node = self._root
        created: List[_Node] = []
        for i, blk in enumerate(blocks):
            child = node.children.get(blk)
            if child is None:
                if i < start_block:
                    # the caller said blocks < start_block are already in
                    # the tree (its matched path); a hole here means the
                    # match and insert disagree about tree state
                    raise RuntimeError(
                        "prefix-cache insert: matched prefix missing "
                        "from the tree (match/insert raced?)")
                child = _Node(blk, int(pages[i]), node,
                              _block_hash(node.hash, blk), i + 1)
                child.ref = 1
                node.children[blk] = child
                self._nodes += 1
                self._dev_nodes += 1
                created.append(child)
                self._invalidate()
            elif child.residency != "device" and child.promo is None:
                if i < start_block:
                    raise RuntimeError(
                        "prefix-cache insert: matched device prefix is "
                        "off-device (match/insert raced?)")
                self._discard_blob(child)
                child.page = int(pages[i])
                child.residency = "device"
                child.ref += 1
                self._dev_nodes += 1
                self.upgrades += 1
                created.append(child)
                self._invalidate()
            self._touch(child)
            node = child
        return created

    # -- eviction / demotion -------------------------------------------------
    def evict(self, n_pages: int) -> List[int]:
        """Free up to ``n_pages`` device pages. Victims are LRU device
        nodes with no pinned/promoting device descendants, taken
        deepest-first so an idle chain frees bottom-up. With a host tier
        attached each victim's KV rows are DEMOTED (spilled to a host
        blob; the node stays matchable); without one — or if the spill
        itself fails — the subtree is dropped. Either way the physical
        page ids are returned to the batcher's pool."""
        freed: List[int] = []
        while len(freed) < n_pages:
            victim = self._lru_device_evictable()
            if victim is None:
                break
            page = victim.page
            if self.host_tier is not None and self._spill is not None:
                self._demote(victim)
            else:
                # untiered: victim has no children at all (no device child
                # by the rule, no off-device child without a tier)
                if victim.spin > 0:
                    self.session_pin_drops += 1
                del victim.parent.children[victim.key]
                self._nodes -= 1
                self._dev_nodes -= 1
            self.evictions += 1
            freed.append(page)
            self._invalidate()
        return freed

    def _lru_device_evictable(self) -> Optional[_Node]:
        # Every pin covers a contiguous root-path (admission pins matched
        # prefixes, promotion pins device prefix + tail, insert's new and
        # upgraded nodes extend an already-pinned path), so ref == 0 here
        # implies no pinned/promoting descendant hides in the off-device
        # subtree either — _drop_subtree on a failed demotion stays safe.
        best: Optional[_Node] = None
        stack = [n for n in self._root.children.values()
                 if n.residency == "device"]
        while stack:
            n = stack.pop()
            dev_kids = [c for c in n.children.values()
                        if c.residency == "device"]
            if not dev_kids and n.ref == 0 and n.promo is None:
                if best is None or n.last_use < best.last_use:
                    best = n
            stack.extend(dev_kids)
        return best

    def _demote(self, victim: _Node):
        """device -> host for one node: spill its pool rows to a blob.
        A failed spill (chaos, OOM) drops the subtree instead — pages
        stay clean, the prefix just recomputes next time."""
        from ..resilience.chaos import fault_point
        try:
            fault_point("kv.host_demote")
            blob = self._spill(victim)
        except Exception:
            self.demote_failures += 1
            blob = None
        if blob is None:
            self._drop_subtree(victim)
            return
        victim.page = -1
        victim.residency = "host"
        self._dev_nodes -= 1
        if self._store(self.host_tier, victim, blob):
            self.demotions += 1
            self.demoted_bytes += self.host_tier.nbytes_of(id(victim))
        else:
            self._drop_subtree(victim)

    def _store(self, tier, node: _Node, blob) -> bool:
        """Place a blob in ``tier``, demoting the tier's own LRU overflow
        down-chain (host -> disk -> gone) to make room. False if even
        after overflow eviction the blob cannot fit."""
        nbytes = blob_nbytes(blob)
        while tier.used_bytes + nbytes > tier.capacity_bytes:
            v = self._lru_tier_evictable(tier)
            if v is None:
                break
            self._evict_from_tier(v, tier)
        if tier.used_bytes + nbytes > tier.capacity_bytes:
            return False
        tier.put(id(node), blob)
        node.residency = tier.name
        return True

    def _lru_tier_evictable(self, tier) -> Optional[_Node]:
        """LRU node of ``tier`` whose demotion keeps residency monotone:
        no pinned/promoting state and no child in the SAME tier (deeper
        children already sit in a lower tier or are gone). When the tier
        has no ``next_tier`` eviction means DROP, so session-pinned nodes
        (``spin > 0``) are skipped there — churn can cascade a paused
        session down the tier chain but never out of the last tier."""
        last = tier.next_tier is None
        best: Optional[_Node] = None
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n.residency != tier.name or n.ref > 0 or n.promo is not None:
                continue
            if last and n.spin > 0:
                continue
            if id(n) not in tier:
                # mid-transition: _demote/_evict_from_tier flip residency
                # before _store lands the blob — the node being stored
                # must not be picked as its own overflow victim
                continue
            if any(c.residency == tier.name for c in n.children.values()):
                continue
            if best is None or n.last_use < best.last_use:
                best = n
        return best

    def _evict_from_tier(self, node: _Node, tier):
        """Push one node out of ``tier``: down to ``next_tier`` if it fits,
        else gone (subtree dropped)."""
        tier.evicted += 1
        nxt = tier.next_tier
        if nxt is not None:
            blob = tier.get(id(node))
            tier.discard(id(node))
            node.residency = "_moving"  # off-tier while _store re-homes it
            if self._store(nxt, node, blob):
                self._invalidate()
                return
            node.residency = tier.name  # restore for a clean subtree drop
            tier.put(id(node), blob)
            tier.stored -= 1  # the put above is a restore, not a new store
        self._drop_subtree(node)

    def _drop_subtree(self, node: _Node):
        """Remove a node and everything below it from the tree, returning
        blob bytes to their tiers. Never called with device descendants
        (monotone residency) — device pages are never dropped here."""
        stack = [node]
        order: List[_Node] = []
        while stack:
            n = stack.pop()
            order.append(n)
            stack.extend(n.children.values())
        for n in order:
            if n.residency == "device":
                self._dev_nodes -= 1
            else:
                self._discard_blob(n)
            if n.spin > 0:
                self.session_pin_drops += 1
            self._nodes -= 1
        del node.parent.children[node.key]
        self._invalidate()

    def _tier_of(self, node: _Node):
        t = self.host_tier
        while t is not None:
            if t.name == node.residency:
                return t
            t = t.next_tier
        return None

    def _discard_blob(self, node: _Node):
        tier = self._tier_of(node)
        if tier is not None and id(node) in tier:
            tier.discard(id(node))

    # -- promotion bookkeeping (the batcher drives the async transfer) ------
    def node_blob(self, node: _Node):
        """The spilled KV blob backing an off-device node."""
        tier = self._tier_of(node)
        if tier is None:
            raise KeyError(f"node {node!r} has no tier blob")
        return tier.get(id(node))

    def promote_node(self, node: _Node, page: int, nbytes: int = 0):
        """host/disk -> device: the batcher landed the node's rows in pool
        ``page``; drop the blob and flip residency."""
        self._discard_blob(node)
        node.page = int(page)
        node.residency = "device"
        self._dev_nodes += 1
        self.promotions += 1
        self.promoted_bytes += int(nbytes)
        self._touch(node)
        self._invalidate()

    # -- the routing surface -------------------------------------------------
    def summary(self) -> Dict[str, object]:
        """Hashed prefix advertisement for the gateway router:
        ``{"block_size": B, "hashes": {chain_hash: depth_blocks},
        "tiers": {chain_hash: residency}}``. Cached; every mutation
        (insert/evict/demote/promote) invalidates it, so evicted chains
        vanish from routing immediately, not at the next insert."""
        if not self._dirty and self._summary_cache is not None:
            return self._summary_cache
        hashes: Dict[int, int] = {}
        tiers: Dict[int, str] = {}
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            hashes[n.hash] = n.depth
            tiers[n.hash] = n.residency
            stack.extend(n.children.values())
        self._summary_cache = {"block_size": self.block_size,
                               "hashes": hashes, "tiers": tiers}
        self._dirty = False
        return self._summary_cache

    # -- audits / stats ------------------------------------------------------
    def audit_tiers(self) -> Dict[str, int]:
        """Prove tier byte accounting leaks zero: every off-device node
        has exactly one blob in its tier, every tier blob belongs to a
        live node, and per-tier used_bytes equals the sum over live
        blobs. Raises on any mismatch."""
        by_tier: Dict[str, Dict[int, _Node]] = {}
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n.residency != "device":
                by_tier.setdefault(n.residency, {})[id(n)] = n
        report: Dict[str, int] = {}
        tier = self.host_tier
        while tier is not None:
            nodes = by_tier.pop(tier.name, {})
            keys = set(tier.keys())
            if keys != set(nodes):
                raise RuntimeError(
                    f"kv {tier.name}-tier leak: {len(keys - set(nodes))} "
                    f"orphan blobs, {len(set(nodes) - keys)} blobless nodes")
            total = sum(tier.nbytes_of(k) for k in keys)
            if total != tier.used_bytes:
                raise RuntimeError(
                    f"kv {tier.name}-tier byte drift: accounted "
                    f"{tier.used_bytes} != live {total}")
            report[f"{tier.name}_bytes"] = tier.used_bytes
            report[f"{tier.name}_nodes"] = len(keys)
            tier = tier.next_tier
        if by_tier:
            raise RuntimeError(
                f"kv tier leak: nodes resident in unattached tiers "
                f"{sorted(by_tier)}")
        return report

    def session_pinned_nodes(self) -> int:
        count = 0
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n.spin > 0:
                count += 1
        return count

    def stats(self) -> Dict[str, int]:
        host = self.host_tier
        disk = host.next_tier if host is not None else None
        return {"nodes": self._nodes,
                "cached_pages": self._dev_nodes,
                "hit_tokens": self.hit_tokens,
                "miss_tokens": self.miss_tokens,
                "host_hit_tokens": self.host_hit_tokens,
                "evictions": self.evictions,
                "demotions": self.demotions,
                "demote_failures": self.demote_failures,
                "demoted_bytes": self.demoted_bytes,
                "promotions": self.promotions,
                "promoted_bytes": self.promoted_bytes,
                "promotion_failures": self.promotion_failures,
                "upgrades": self.upgrades,
                "session_pinned_nodes": self.session_pinned_nodes(),
                "session_pin_drops": self.session_pin_drops,
                "host_nodes": len(host) if host is not None else 0,
                "host_bytes": host.used_bytes if host is not None else 0,
                "disk_nodes": len(disk) if disk is not None else 0,
                "disk_bytes": disk.used_bytes if disk is not None else 0}
