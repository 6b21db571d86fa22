"""Replica lifecycle: N batchers behind one gateway (counterpart of
``paddle_tpu/inference/gateway/replica.py``).

A ``Replica`` wraps one ``ContinuousBatcher``/``PagedContinuousBatcher``
(anything derived from ``_BatcherBase``) with pool metadata: routing
weight, warm prompt-bucket set (affinity state), draining flag, and
liveness. Its health surface IS the batcher's own
``resilience.recovery.HealthStateMachine`` — the pool never invents a
second state machine.

``ReplicaPool`` owns add/drain/remove and the failure policy: each
replica's step runs under a shared ``resilience.retry.RetryPolicy``, so
transient faults (chaos ``serving.step`` injections, flaky dispatch)
retry in place; when the policy gives up — or the step raises something
non-retryable — the replica is declared DEAD and the gateway requeues
its in-flight requests onto the survivors (counted ``gateway.requeued``;
greedy decode makes the resumed continuation token-exact, the same
contract the paged batcher's preemption path relies on).

Not ported yet (ROADMAP.md, queue 1, item 7: distributed): replicas that
are a tensor-parallel shard group. ``ReplicaPool.add`` raises
``NotImplementedError`` for a batcher that carries a ``shard_group``.
"""
from __future__ import annotations

import time as _time
from typing import Dict, List, Optional, Set, Tuple

from ...resilience.recovery import HealthState
from ...resilience.retry import RetryGiveUp, RetryPolicy

__all__ = ["Replica", "ReplicaPool"]


def _pool_metrics():
    from ...observability.metrics import get_registry
    reg = get_registry()
    return (reg.gauge("gateway.replicas_alive",
                      "live (non-dead) replicas in the pool"),
            reg.counter("gateway.replica_deaths",
                        "replicas declared dead after step failures",
                        labelnames=("replica",)))


def _step_seconds_h():
    from ...observability.metrics import get_registry
    return get_registry().histogram(
        "gateway.replica.step_seconds",
        "wall time of one replica engine step (incl. retries)",
        labelnames=("replica",))


def _member_step_seconds_h():
    # per-shard-member view of the same step (the JAX package names a
    # tensor-parallel group's members here; member == replica name for a
    # plain single-engine replica, the only kind the port has)
    from ...observability.metrics import get_registry
    return get_registry().histogram(
        "replica.step_seconds",
        "wall time of one engine step per shard-group member",
        labelnames=("replica", "member"))


class Replica:
    """One serving engine in the pool."""

    def __init__(self, name: str, batcher, weight: float = 1.0):
        if weight <= 0:
            raise ValueError(f"replica weight must be positive, "
                             f"got {weight}")
        self.name = name
        self.batcher = batcher
        self.weight = float(weight)
        self.draining = False
        self.alive = True
        # prompt-bucket rungs this replica has prefilled before — the
        # affinity policy's proxy for "compile cache is warm here"
        self.warm_buckets: Set[int] = set()

    @property
    def shard_group(self):
        """The batcher's tensor-parallel shard group when it serves as one
        logical TP replica, else None (always None in the port: the pool
        refuses shard groups, which are not ported yet)."""
        return getattr(self.batcher, "shard_group", None)

    def describe(self) -> Dict[str, object]:
        return {"name": self.name, "alive": self.alive,
                "draining": self.draining, "load": self.load}

    # -- the KV-aware routing surface -----------------------------------------
    def prefix_summary(self) -> Optional[Dict[str, object]]:
        """Hashed radix-tree advertisement for KV-aware routing
        (``{"block_size": B, "hashes": {chain_hash: depth}}``), or None
        when the batcher runs without a prefix cache. In a multi-process
        deployment this is the payload a replica would gossip to the
        gateway; in-process the router just reads it live."""
        cache = getattr(self.batcher, "prefix_cache", None)
        return cache.summary() if cache is not None else None

    # -- load/capacity the router reads --------------------------------------
    @property
    def load(self) -> int:
        """In-flight request count: queued + active (+ mid-admission)."""
        b = self.batcher
        return (b.active + b.pending
                + (1 if getattr(b, "_admitting", None) else 0))

    @property
    def free_slots(self) -> int:
        """Slots the batcher could still fill — the dispatch gate. The
        gateway holds excess work in ITS queue (where priorities and
        requeues still apply) instead of burying it in a replica FIFO."""
        return max(0, self.batcher.max_batch - self.load)

    @property
    def health(self):
        return self.batcher.health

    def routable(self) -> bool:
        """Eligible for NEW work: live, not draining, not UNREADY.
        (STARTING counts — a fresh replica has to get its first request
        from somewhere.)"""
        return (self.alive and not self.draining
                and self.health.state != HealthState.UNREADY)

    def __repr__(self):
        return (f"Replica({self.name!r}, load={self.load}, "
                f"alive={self.alive}, draining={self.draining})")


class ReplicaPool:
    """Ordered replica set + the step/failure policy."""

    def __init__(self, step_retry: Optional[RetryPolicy] = None):
        # zero-sleep default: transient chaos faults retry immediately;
        # give-up after 3 attempts declares the replica dead
        self.step_retry = step_retry or RetryPolicy(
            max_attempts=3, base_delay=0.0, jitter=0.0, seed=0)
        self._replicas: Dict[str, Replica] = {}

    # -- lifecycle ------------------------------------------------------------
    def add(self, name: str, batcher, weight: float = 1.0) -> Replica:
        if name in self._replicas:
            raise ValueError(f"replica {name!r} already in the pool")
        if getattr(batcher, "shard_group", None) is not None:
            raise NotImplementedError(
                f"replica {name!r} is a tensor-parallel shard group, which "
                "is not ported yet (ROADMAP.md, queue 1, item 7: "
                "distributed)")
        rep = Replica(name, batcher, weight=weight)
        self._replicas[name] = rep
        alive_g, _ = _pool_metrics()
        alive_g.set(len(self.live()))
        return rep

    def get(self, name: str) -> Replica:
        return self._replicas[name]

    def __contains__(self, name: str) -> bool:
        return name in self._replicas

    def __len__(self) -> int:
        return len(self._replicas)

    def replicas(self) -> List[Replica]:
        return list(self._replicas.values())

    def live(self) -> List[Replica]:
        """Replicas that still step (draining ones keep stepping — they
        have in-flight work to finish)."""
        return [r for r in self._replicas.values() if r.alive]

    def routable(self) -> List[Replica]:
        return [r for r in self._replicas.values() if r.routable()]

    def drain(self, name: str):
        """Stop routing new work to ``name``; in-flight work finishes.
        The batcher's health machine advertises UNREADY so external
        probes agree with the pool."""
        rep = self._replicas[name]
        rep.draining = True
        rep.health.drain()

    def remove(self, name: str, force: bool = False) -> Replica:
        """Remove a drained/empty replica. With in-flight work, refuse
        unless ``force`` — the GATEWAY must requeue those requests first
        (it owns the request bookkeeping)."""
        rep = self._replicas[name]
        if rep.alive and rep.load > 0 and not force:
            raise RuntimeError(
                f"replica {name!r} still has {rep.load} in-flight "
                f"request(s); drain it first or pass force=True")
        del self._replicas[name]
        alive_g, _ = _pool_metrics()
        alive_g.set(len(self.live()))
        return rep

    # -- the step/failure policy ----------------------------------------------
    def step_replica(self, rep: Replica) -> Tuple[str, object]:
        """One engine step under the retry policy.

        Returns ``("ok", finished_rids)`` or ``("dead", exc)`` — the
        latter after marking the replica dead (health drained, gauges
        updated). The caller requeues the dead replica's requests.
        """
        t0 = _time.perf_counter()
        try:
            # per-replica chaos seam: the shared ``serving.step`` point
            # fires on whichever replica steps next, so a drill that
            # needs to straggle ONE replica arms this name instead
            # (e.g. ``gateway.step.r1:delay:delay_s=0.05``). An error
            # kind here bypasses the retry policy — it models the
            # replica's host dying, not a flaky step
            from ...resilience.chaos import fault_point
            fault_point(f"gateway.step.{rep.name}")
            rids = self.step_retry.call(rep.batcher.step,
                                        point=f"gateway.step.{rep.name}")
            elapsed = _time.perf_counter() - t0
            _step_seconds_h().labels(replica=rep.name).observe(elapsed)
            _member_step_seconds_h().labels(
                replica=rep.name, member=rep.name).observe(elapsed)
            return "ok", rids
        except RetryGiveUp as exc:
            self._kill(rep)
            return "dead", exc
        except Exception as exc:  # noqa: BLE001 — non-retryable = fatal
            self._kill(rep)
            return "dead", exc

    def _kill(self, rep: Replica):
        rep.alive = False
        rep.health.drain()
        alive_g, deaths_c = _pool_metrics()
        alive_g.set(len(self.live()))
        deaths_c.labels(replica=rep.name).inc()
