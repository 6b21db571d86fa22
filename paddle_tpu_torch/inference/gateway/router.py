"""Request routing: placement policies + the two-level dispatch queue
(counterpart of ``paddle_tpu/inference/gateway/router.py``).

Placement policies pick a replica for each dispatchable request:

  * ``least_loaded``      — fewest in-flight requests (queued + active);
    the goodput-oriented default (DistServe/Splitwise-style placement
    degenerates to this when every replica runs the same phase mix).
  * ``affinity``          — KV-aware placement first (the replica whose
    radix prefix cache advertises the deepest cached prefix of this
    prompt wins — shared-prefix prefill becomes a page lookup there),
    then session stickiness (follow-up turns land on the replica
    holding the warm KV/compile state), then prompt-BUCKET warmth (a
    replica that already prefilled this ``perf.buckets`` rung is
    preferred — in the JAX package the warm executable; the port's
    prefill is eager and keeps the rule so both route alike), falling
    back to least-loaded.
  * ``weighted_rr``       — smooth weighted round-robin over replica
    weights (heterogeneous pools: a 2x-capacity replica takes 2x the
    requests).

Routing decisions are instrumented: ``gateway.route.prefix_hit`` when a
cached-prefix match carried the decision, ``gateway.route.affinity_hit``
when a session/bucket match did, ``gateway.route.fallback`` when the
affinity policy had to fall back.

The dispatch queue is TWO-LEVEL (interactive=0 above batch=1) with an
anti-starvation share: every ``low_share``-th dispatch serves the low
queue first, so a saturating stream of high-priority work cannot starve
batch tenants (the acceptance bar: the low-priority tenant still
completes under mixed load).
"""
from __future__ import annotations

import time as _time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["RoutePolicy", "LeastLoadedPolicy", "SessionAffinityPolicy",
           "WeightedRoundRobinPolicy", "resolve_policy", "DispatchQueue",
           "PRIORITY_HIGH", "PRIORITY_LOW"]

PRIORITY_HIGH = 0
PRIORITY_LOW = 1


def _route_metrics():
    from ...observability.metrics import get_registry
    reg = get_registry()
    return (reg.counter("gateway.route.affinity_hit",
                        "dispatches placed by session/bucket affinity"),
            reg.counter("gateway.route.fallback",
                        "affinity dispatches that fell back to "
                        "least-loaded"),
            reg.counter("gateway.route.prefix_hit",
                        "dispatches placed on the replica advertising "
                        "the deepest cached prompt prefix"),
            reg.counter("gateway.route.session_resume",
                        "returning sessions whose sticky replica was "
                        "gone, resolved to a new replica (prefix depth "
                        "or fallback)"))


def _queue_wait_h():
    from ...observability.metrics import get_registry
    return get_registry().histogram(
        "gateway.queue_wait_seconds",
        "gateway-queue residency from submit to dispatch pop",
        labelnames=("lane",))


class RoutePolicy:
    """Pick one replica from the routable candidates for a request."""

    name = "base"

    def select(self, req, candidates: Sequence):
        raise NotImplementedError

    def on_dispatch(self, req, replica):
        """Observe a completed placement (update affinity state)."""


class LeastLoadedPolicy(RoutePolicy):
    name = "least_loaded"

    def select(self, req, candidates: Sequence):
        # (load, name): deterministic tie-break by name
        return min(candidates, key=lambda r: (r.load, r.name))


class WeightedRoundRobinPolicy(RoutePolicy):
    """Smooth WRR (nginx-style): each pick adds weight to every
    candidate's running credit and the winner pays back the total, so a
    weight-2 replica lands 2 of every 3 dispatches without bursts."""

    name = "weighted_rr"

    def __init__(self):
        self._credit: Dict[str, float] = {}

    def select(self, req, candidates: Sequence):
        total = 0.0
        for r in candidates:
            self._credit[r.name] = self._credit.get(r.name, 0.0) + r.weight
            total += r.weight
        # deterministic: max credit, name tie-break
        best = max(candidates,
                   key=lambda r: (self._credit[r.name], r.name))
        self._credit[best.name] -= total
        return best


class SessionAffinityPolicy(RoutePolicy):
    """Cached-prefix depth, then session stickiness, then prompt-bucket
    warmth, then fallback.

    KV-aware placement comes FIRST: replicas running a radix prefix
    cache advertise hashed chain summaries (``Replica.prefix_summary``),
    and the policy computes the request prompt's own chain hashes
    (``inference.prefix_cache.chain_hashes``) to find the replica that
    already holds the deepest prefix of this prompt — landing there
    turns the shared-system-prompt prefill into a page-table lookup,
    which dominates any compile-cache warmth. Ties break by (load,
    name); hits count ``gateway.route.prefix_hit``.

    Then the classic tiers: a follow-up turn (same ``session_id``)
    routes to the replica that served the session before — its paged KV
    pages and compiled prefill signatures for the conversation are warm.
    Requests without a sticky session prefer a replica whose compile
    cache already holds the prompt's ``perf.buckets`` rung
    (``Replica.warm_buckets``, recorded at dispatch). Both count
    ``gateway.route.affinity_hit``; a miss counts
    ``gateway.route.fallback`` and defers to the fallback policy.
    """

    name = "affinity"

    def __init__(self, fallback: Optional[RoutePolicy] = None):
        self.fallback = fallback or LeastLoadedPolicy()
        self._sessions: Dict[str, str] = {}     # session_id -> replica name

    @staticmethod
    def _prefix_tokens(req, summary,
                       chains: Dict[int, List[int]]) -> Tuple[int, int]:
        """(total cached tokens, device-resident tokens) of ``req.prompt``
        per ``summary``. ``chains`` memoizes the prompt's chain hashes per
        block size so an N-replica pool hashes the prompt once, not N
        times. Tiered replicas advertise per-hash residency under
        ``"tiers"``; summaries without it (untiered, or a pre-tier
        replica) count everything as device-resident."""
        bs = summary.get("block_size")
        hashes = summary.get("hashes")
        if not bs or not hashes:
            return 0, 0
        chain = chains.get(bs)
        if chain is None:
            from ..prefix_cache import chain_hashes
            prompt = getattr(req, "prompt", None)
            chain = (chain_hashes(prompt, bs)
                     if prompt is not None else [])
            chains[bs] = chain
        tiers = summary.get("tiers") or {}
        depth = dev_depth = 0
        for h in chain:
            # chained hashing: a depth-d node implies its whole ancestor
            # chain, so the first miss ends the longest common prefix
            if h not in hashes:
                break
            depth += 1
            # device depth only grows while contiguous from the root
            # (residency is monotone down the chain, so the first
            # off-device block ends it)
            if dev_depth == depth - 1 and tiers.get(h, "device") == "device":
                dev_depth = depth
        return depth * bs, dev_depth * bs

    def select(self, req, candidates: Sequence):
        hit_c, fb_c, px_c, sr_c = _route_metrics()
        sid = getattr(req, "session_id", None)
        # a RESUMED session whose sticky replica vanished (death,
        # rescale) resolves like any other request — prefix depth finds
        # a survivor holding the chain, else fallback full-prefills —
        # but the resolution is counted: it's the durable-resume path
        orphan_session = (sid is not None
                          and getattr(req, "resumed", False)
                          and self._sessions.get(sid) is None)
        chains: Dict[int, List[int]] = {}
        best, best_key = None, (0, 0)
        for r in candidates:
            summary = getattr(r, "prefix_summary", lambda: None)()
            if not summary:
                continue
            key = self._prefix_tokens(req, summary, chains)
            # deepest total match first (a host-resident block beats a
            # recompute — promotion is a memcpy, prefill is flops), then
            # prefer the replica holding more of it ON DEVICE
            if key > best_key or (key == best_key and key[0] > 0 and
                                  (r.load, r.name) <
                                  (best.load, best.name)):
                best, best_key = r, key
        if best_key[0] > 0:
            px_c.inc()
            if orphan_session:
                sr_c.inc()
            return best
        by_name = {r.name: r for r in candidates}
        if sid is not None and self._sessions.get(sid) in by_name:
            hit_c.inc()
            return by_name[self._sessions[sid]]
        bucket = getattr(req, "bucket", None)
        if bucket is not None:
            warm = [r for r in candidates if bucket in r.warm_buckets]
            if warm:
                hit_c.inc()
                if orphan_session:
                    sr_c.inc()
                return min(warm, key=lambda r: (r.load, r.name))
        fb_c.inc()
        if orphan_session:
            sr_c.inc()
        return self.fallback.select(req, candidates)

    def on_dispatch(self, req, replica):
        sid = getattr(req, "session_id", None)
        if sid is not None:
            self._sessions[sid] = replica.name
        bucket = getattr(req, "bucket", None)
        if bucket is not None:
            replica.warm_buckets.add(bucket)

    def forget_replica(self, name: str):
        """Drop sticky sessions pointing at a dead/removed replica so
        their next turn re-routes instead of falling through the
        candidate filter forever."""
        for sid in [s for s, n in self._sessions.items() if n == name]:
            del self._sessions[sid]

    def forget_session(self, session_id: str):
        """Drop one session's stickiness (released/expired sessions must
        not keep steering traffic at their old replica)."""
        self._sessions.pop(session_id, None)


_POLICIES = {
    "least_loaded": LeastLoadedPolicy,
    "affinity": SessionAffinityPolicy,
    "weighted_rr": WeightedRoundRobinPolicy,
}


def resolve_policy(spec) -> RoutePolicy:
    """Normalize the policy specs the gateway accepts: a name, a
    RoutePolicy instance, or None (-> least_loaded)."""
    if spec is None:
        return LeastLoadedPolicy()
    if isinstance(spec, RoutePolicy):
        return spec
    if isinstance(spec, str):
        cls = _POLICIES.get(spec.strip().lower())
        if cls is None:
            raise ValueError(f"unknown routing policy {spec!r} "
                             f"(one of {sorted(_POLICIES)})")
        return cls()
    raise ValueError(f"bad routing policy spec {spec!r}")


class DispatchQueue:
    """Two FIFO lanes (high above low) with a guaranteed low-lane share.

    ``low_share=K`` means every K-th dispatch serves the low lane first
    (when it has work); K=0 disables the share (strict priority). Counts
    are deterministic — no clocks, no randomness — so scheduling replays
    exactly in tests.
    """

    def __init__(self, low_share: int = 4):
        if low_share < 0:
            raise ValueError("low_share must be >= 0")
        self.low_share = low_share
        self._lanes = (deque(), deque())
        self._dispatched = 0

    def push(self, req):
        self._lanes[req.priority].append(req)

    def push_front(self, req):
        """Requeue (replica death, failed dispatch): back to the HEAD of
        its lane, preserving arrival order among its peers."""
        self._lanes[req.priority].appendleft(req)

    def __len__(self):
        return len(self._lanes[0]) + len(self._lanes[1])

    def _lane_order(self):
        if self.low_share and self._lanes[PRIORITY_LOW] and \
                (self._dispatched + 1) % self.low_share == 0:
            return (PRIORITY_LOW, PRIORITY_HIGH)
        return (PRIORITY_HIGH, PRIORITY_LOW)

    def peek(self):
        for lane in self._lane_order():
            if self._lanes[lane]:
                return self._lanes[lane][0]
        return None

    def pop(self):
        for lane in self._lane_order():
            if self._lanes[lane]:
                self._dispatched += 1
                req = self._lanes[lane].popleft()
                submit_t = getattr(req, "submit_t", None)
                if submit_t:
                    _queue_wait_h().labels(
                        lane="high" if lane == PRIORITY_HIGH
                        else "low").observe(
                        max(0.0, _time.perf_counter() - submit_t))
                return req
        return None

    def remove(self, req) -> bool:
        try:
            self._lanes[req.priority].remove(req)
            return True
        except ValueError:
            return False

    def drain(self) -> List:
        """Empty both lanes (gateway shutdown), high lane first."""
        out = list(self._lanes[0]) + list(self._lanes[1])
        self._lanes[0].clear()
        self._lanes[1].clear()
        return out
