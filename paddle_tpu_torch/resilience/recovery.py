"""Recovery policies at the serving seam (counterpart of the serving half
of ``paddle_tpu/resilience/recovery.py``).

  * ``Overloaded`` / ``DeadlineExceeded`` -- the serving batcher's typed
    rejections (queue-depth shedding, per-request deadlines). Typed so a
    fronting layer can map them to 429/504 without string-matching.
  * ``HealthStateMachine`` -- STARTING -> READY <-> DEGRADED -> UNREADY,
    the readiness/liveness surface a load balancer polls. DEGRADED means
    still serving but shedding or saturated; UNREADY means stop sending
    traffic (drained or persistently failing).

The training loop's ``StepGuard`` is not ported yet.
"""
from __future__ import annotations

import time

__all__ = ["Overloaded", "DeadlineExceeded", "HealthStateMachine",
           "HealthState"]


class Overloaded(RuntimeError):
    """Request rejected at admission: the queue is at capacity."""


class DeadlineExceeded(RuntimeError):
    """Request abandoned: its deadline expired before completion."""


# -- serving: health/readiness state machine ---------------------------------

class HealthState:
    STARTING = "starting"
    READY = "ready"
    DEGRADED = "degraded"
    UNREADY = "unready"


_STATE_CODE = {HealthState.STARTING: 0, HealthState.READY: 1,
               HealthState.DEGRADED: 2, HealthState.UNREADY: 3}


class HealthStateMachine:
    """Readiness surface for a serving engine.

    STARTING until the first successful step; READY while healthy;
    DEGRADED while the queue sits above ``degraded_queue_frac`` of
    capacity or a shed/deadline event happened within ``degraded_hold_s``
    (hysteresis -- one shed must not flap the probe); UNREADY after
    ``unready_after`` CONSECUTIVE step failures, or on ``drain()``.
    A later successful step recovers UNREADY -> READY (drained engines
    stay down until ``reset()``).
    """

    def __init__(self, capacity: int, degraded_queue_frac: float = 0.8,
                 degraded_hold_s: float = 5.0, unready_after: int = 3,
                 engine: str = "serving"):
        self.capacity = max(1, capacity)
        self.degraded_queue_frac = degraded_queue_frac
        self.degraded_hold_s = degraded_hold_s
        self.unready_after = unready_after
        self.state = HealthState.STARTING
        self._consecutive_failures = 0
        self._last_degrade_event = -float("inf")
        self._drained = False
        from ..observability.metrics import get_registry
        self._gauge = get_registry().gauge(
            "serving_health_state",
            "0=starting 1=ready 2=degraded 3=unready",
            labelnames=("engine",)).labels(engine=engine)
        self._gauge.set(_STATE_CODE[self.state])

    # -- event feeds --------------------------------------------------------
    def on_step_ok(self, queue_depth: int):
        self._consecutive_failures = 0
        if self._drained:
            return
        now = time.monotonic()
        over = queue_depth >= self.degraded_queue_frac * self.capacity
        if over:
            self._last_degrade_event = now
        # over-capacity RIGHT NOW is degraded regardless of hold_s; the
        # hold only stretches how long a past event keeps us degraded
        degraded = over or (
            (now - self._last_degrade_event) < self.degraded_hold_s)
        self._set(HealthState.DEGRADED if degraded else HealthState.READY)

    def on_step_error(self):
        self._consecutive_failures += 1
        if self._consecutive_failures >= self.unready_after:
            self._set(HealthState.UNREADY)
        elif self.state != HealthState.STARTING:
            self._set(HealthState.DEGRADED)
            self._last_degrade_event = time.monotonic()

    def on_shed(self):
        self._last_degrade_event = time.monotonic()
        if self.state in (HealthState.READY, HealthState.STARTING):
            self._set(HealthState.DEGRADED)

    def drain(self):
        """Administrative: stop advertising readiness permanently (until
        reset) -- the restart/upgrade path."""
        self._drained = True
        self._set(HealthState.UNREADY)

    def reset(self):
        self._drained = False
        self._consecutive_failures = 0
        self._last_degrade_event = -float("inf")
        self._set(HealthState.STARTING)

    # -- probes -------------------------------------------------------------
    def ready(self) -> bool:
        return self.state in (HealthState.READY, HealthState.DEGRADED)

    def _set(self, state: str):
        self.state = state
        self._gauge.set(_STATE_CODE[state])
