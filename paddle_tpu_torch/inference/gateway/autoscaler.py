"""Queue-depth + TTFT-driven autoscaling over the gateway pool
(counterpart of ``paddle_tpu/inference/gateway/autoscaler.py``).

The capacity half of the self-healing loop (the remediation half is
``resilience.remediator``): an ``Autoscaler`` watches the two signals
the gateway already publishes — live queue depth and the cumulative
``gateway.ttft_seconds`` histogram — and adds or drains replicas
through the pool's EXISTING lifecycle. Scale-up builds a fresh engine
from the deployment's ``replica_factory``; scale-down uses
``Gateway.drain_replica(name, requeue=True)`` (in-flight work resumes
on survivors token-exact) and removes the replica once it is empty, so
no request is ever stranded on a scaling decision.

Pressure, not instantaneous readings, drives decisions: a tick counts
toward scale-up when queue depth sits at/above ``queue_high`` OR the
TTFT breach fraction since the last tick (share of completions slower
than ``ttft_slo_s``, read as histogram deltas — no second event pipe)
exceeds ``breach_frac``; toward scale-down when the queue is at/below
``queue_low`` with idle capacity. Only ``hysteresis`` CONSECUTIVE
pressure ticks act, a shared cooldown separates actions, and every
action passes the same ``FlapGuard`` the remediator uses (hand both
the same instance and the two controllers share one action budget —
the autoscaler cannot flap capacity while the remediator is frozen).

``tick()`` is the autonomous gated path. ``scale_up()``/``scale_down()``
are the command surface (the remediator's delegate) — the caller has
already spent flap-guard budget, so they only honor min/max bounds.
"""
from __future__ import annotations

import bisect
import time
from typing import Callable, List, Optional, Tuple

from ...observability.metrics import Histogram, get_registry
from ...resilience.remediator import FlapGuard
from ...utils.locks import TracedLock

__all__ = ["Autoscaler"]


class Autoscaler:
    """Replica add/drain controller riding the pool lifecycle."""

    def __init__(self, gw, replica_factory: Callable[[str], object],
                 min_replicas: int = 1, max_replicas: int = 4,
                 queue_high: int = 8, queue_low: int = 0,
                 ttft_slo_s: Optional[float] = None,
                 breach_frac: float = 0.5, min_breach_samples: int = 4,
                 hysteresis: int = 3, cooldown_s: float = 30.0,
                 flap_guard: Optional[FlapGuard] = None,
                 clock: Callable[[], float] = time.monotonic):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        self.gw = gw
        self.replica_factory = replica_factory
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.queue_high = int(queue_high)
        self.queue_low = int(queue_low)
        self.ttft_slo_s = ttft_slo_s
        self.breach_frac = float(breach_frac)
        self.min_breach_samples = int(min_breach_samples)
        self.hysteresis = int(hysteresis)
        self.cooldown_s = float(cooldown_s)
        self.flap_guard = flap_guard or FlapGuard(clock=clock)
        self._clock = clock
        self._reg = get_registry()
        # tick-state lock: guards the pressure streaks and cooldown stamp
        # against off-thread observers. Never held across scale_up/
        # scale_down (they call into the gateway pool, which may take
        # Gateway._admit) — the only cross-object lock order is
        # Autoscaler._tick -> Gateway._admit.
        self._tick_lock = TracedLock("Autoscaler._tick")
        self._up_streak = 0
        self._down_streak = 0
        self._last_action_t = -float("inf")
        self._last_ttft: Tuple[int, int] = self._ttft_counts()
        self._next_id = 0
        self._draining: List[str] = []     # replicas we drained, pending removal
        self.events: List[dict] = []
        self._scale_c = self._reg.counter(
            "autoscaler.scale_events", "autoscaler actions taken",
            labelnames=("direction",))
        self._size_g = self._reg.gauge(
            "autoscaler.pool_size", "routable replicas after the last tick")

    # -- TTFT pressure (histogram deltas, the slo.py reading pattern) ---------
    def _ttft_counts(self) -> Tuple[int, int]:
        entry = self._reg.get("gateway.ttft_seconds")
        if entry is None or self.ttft_slo_s is None:
            return 0, 0
        children = (entry.children() if hasattr(entry, "children")
                    else [entry])
        total = good = 0
        for h in children:
            if not isinstance(h, Histogram):
                continue
            counts = h.bucket_counts()
            k = bisect.bisect_right(h.buckets, self.ttft_slo_s + 1e-12)
            total += sum(counts)
            good += sum(counts[:k])
        return total, good

    def _ttft_pressure(self) -> bool:
        cur = self._ttft_counts()
        last, self._last_ttft = self._last_ttft, cur
        d_total = cur[0] - last[0]
        if self.ttft_slo_s is None or d_total < self.min_breach_samples:
            return False
        d_bad = d_total - (cur[1] - last[1])
        return d_bad / d_total >= self.breach_frac

    # -- the autonomous tick --------------------------------------------------
    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """One gated control decision; returns ``"scale_up:<name>"`` /
        ``"scale_down:<name>"`` when an action was taken, else None."""
        now = self._clock() if now is None else now
        self._finalize()
        routable = self.gw.pool.routable()
        self._size_g.set(len(routable))
        depth = len(self.gw._queue)
        ttft_hot = self._ttft_pressure()
        with self._tick_lock:
            if depth >= self.queue_high or ttft_hot:
                self._up_streak += 1
                self._down_streak = 0
            elif depth <= self.queue_low and all(
                    r.free_slots > 0 for r in routable):
                self._down_streak += 1
                self._up_streak = 0
            else:
                self._up_streak = 0
                self._down_streak = 0
            if now - self._last_action_t < self.cooldown_s:
                return None
        if self._up_streak >= self.hysteresis \
                and len(routable) < self.max_replicas:
            ok, why = self.flap_guard.check(now)
            if not ok:
                self._journal("scale_up", "", why, now,
                              depth=depth, ttft_hot=int(ttft_hot))
                with self._tick_lock:
                    self._up_streak = 0
                return None
            name = self.scale_up(
                reason="queue" if depth >= self.queue_high else "ttft",
                now=now)
            if name is not None:
                self.flap_guard.record(now)
                with self._tick_lock:
                    self._up_streak = 0
                return f"scale_up:{name}"
        if self._down_streak >= self.hysteresis \
                and len(routable) > self.min_replicas:
            ok, why = self.flap_guard.check(now)
            if not ok:
                self._journal("scale_down", "", why, now, depth=depth)
                with self._tick_lock:
                    self._down_streak = 0
                return None
            name = self.scale_down(reason="idle", now=now)
            if name is not None:
                self.flap_guard.record(now)
                with self._tick_lock:
                    self._down_streak = 0
                return f"scale_down:{name}"
        return None

    # -- the command surface (min/max-bounded, caller owns the guard) ---------
    def scale_up(self, reason: str = "",
                 now: Optional[float] = None) -> Optional[str]:
        now = self._clock() if now is None else now
        if len(self.gw.pool.routable()) >= self.max_replicas:
            self._journal("scale_up", "", "at_max", now)
            return None
        name = f"auto{self._next_id}"
        self._next_id += 1
        self.gw.add_replica(name, self.replica_factory(name))
        self._last_action_t = now
        self._scale_c.labels(direction="up").inc()
        self._journal("scale_up", name, "executed", now, cause=reason)
        return name

    def scale_down(self, reason: str = "",
                   now: Optional[float] = None) -> Optional[str]:
        now = self._clock() if now is None else now
        cands = self.gw.pool.routable()
        if len(cands) <= self.min_replicas:
            self._journal("scale_down", "", "at_min", now)
            return None
        # prefer retiring our own additions, then the least-loaded
        auto = [r for r in cands if r.name.startswith("auto")]
        victim = min(auto or cands, key=lambda r: (r.load, r.name))
        self.gw.drain_replica(victim.name, requeue=True)
        self._draining.append(victim.name)
        self._finalize()
        self._last_action_t = now
        self._scale_c.labels(direction="down").inc()
        self._journal("scale_down", victim.name, "executed", now,
                      cause=reason)
        return victim.name

    def _finalize(self):
        """Remove replicas we drained once their last request left."""
        for name in list(self._draining):
            if name not in self.gw.pool:
                self._draining.remove(name)
                continue
            rep = self.gw.pool.get(name)
            if rep.load == 0 or not rep.alive:
                self.gw.remove_replica(name, force=not rep.alive)
                self._draining.remove(name)

    def _journal(self, action: str, target: str, decision: str,
                 now: float, **detail):
        ev = {"action": action, "target": target, "decision": decision,
              "at": now, **detail}
        self.events.append(ev)
        from ...observability.fleet import spool_event
        from ...observability.flight import flight_record
        spool_event("remediation", actor="autoscaler", action=action,
                    target=target, decision=decision, **detail)
        flight_record("remediation", actor="autoscaler", action=action,
                      target=target, decision=decision)
