"""Shared retry/backoff policy (counterpart of
``paddle_tpu/resilience/retry.py``).

One policy object serves every control-plane caller; in the port the
gateway's ``ReplicaPool`` runs each replica's step under it:

  * exponential backoff with multiplicative growth, capped per-attempt;
  * full jitter (a seeded ``random.Random`` so tests replay exactly: the
    same seed gives the JAX package's delays);
  * a total DEADLINE cap: sleeps are clipped to the remaining budget and
    the policy gives up when the budget is spent, whatever max_attempts
    says;
  * per-attempt telemetry through the observability registry
    (``retry_attempts_total`` / ``retry_giveups_total`` labeled by call
    site).

Retryability is type-driven: ``retryable`` exception classes are retried
unless they also match ``giveup`` (checked first). Injected
``TransientChaosError``s are retryable by default so chaos drills
exercise these loops.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple, Type

from .chaos import TransientChaosError

__all__ = ["RetryPolicy", "RetryGiveUp", "DEFAULT_RETRYABLE"]

DEFAULT_RETRYABLE: Tuple[Type[BaseException], ...] = (
    ConnectionError, TimeoutError, OSError, TransientChaosError)


class RetryGiveUp(RuntimeError):
    """Raised when the policy exhausts attempts/deadline. ``last`` holds
    the final underlying exception (also chained as __cause__)."""

    def __init__(self, msg: str, last: BaseException):
        super().__init__(msg)
        self.last = last


@dataclass(frozen=True)
class RetryPolicy:
    """Deterministic-by-seed exponential backoff with deadline cap."""

    max_attempts: int = 5
    base_delay: float = 0.05
    max_delay: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5           # fraction of the backoff randomized away
    deadline: Optional[float] = None   # total seconds across all attempts
    retryable: Tuple[Type[BaseException], ...] = DEFAULT_RETRYABLE
    giveup: Tuple[Type[BaseException], ...] = ()
    seed: Optional[int] = None    # None → wall-clock-seeded jitter
    # injectable for tests (field, not global, so policies are reusable)
    sleep_fn: Callable[[float], None] = field(default=time.sleep)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.multiplier < 1.0:
            raise ValueError("multiplier must be >= 1.0")

    # -- the math (exposed so tests pin it exactly) -------------------------
    def backoff(self, attempt: int) -> float:
        """Deterministic pre-jitter delay after the Nth failure (0-based):
        min(max_delay, base_delay * multiplier**attempt)."""
        return min(self.max_delay,
                   self.base_delay * self.multiplier ** attempt)

    def delay(self, attempt: int, rng: random.Random) -> float:
        """Jittered delay: backoff * (1 - jitter * U[0,1))."""
        b = self.backoff(attempt)
        if self.jitter <= 0:
            return b
        return b * (1.0 - self.jitter * rng.random())

    def _is_retryable(self, exc: BaseException) -> bool:
        if self.giveup and isinstance(exc, self.giveup):
            return False
        return isinstance(exc, self.retryable)

    # -- the loop -----------------------------------------------------------
    def call(self, fn: Callable, *args, point: str = "", **kwargs):
        """Run ``fn(*args, **kwargs)``, retrying per the policy. ``point``
        labels the telemetry series (use the caller's seam name)."""
        attempts_c, giveups_c = _retry_metrics()
        label = point or getattr(fn, "__name__", "call")
        rng = random.Random(self.seed)
        t0 = time.monotonic()
        attempt = 0
        while True:
            attempts_c.labels(point=label).inc()
            try:
                return fn(*args, **kwargs)
            except BaseException as exc:  # noqa: BLE001 — filtered below
                if not self._is_retryable(exc):
                    raise
                attempt += 1
                remaining = (None if self.deadline is None
                             else self.deadline - (time.monotonic() - t0))
                if attempt >= self.max_attempts or \
                        (remaining is not None and remaining <= 0):
                    giveups_c.labels(point=label).inc()
                    raise RetryGiveUp(
                        f"{label}: gave up after {attempt} attempt(s) "
                        f"({type(exc).__name__}: {exc})", exc) from exc
                d = self.delay(attempt - 1, rng)
                if remaining is not None:
                    d = min(d, max(0.0, remaining))
                self.sleep_fn(d)

    def wrap(self, fn: Callable, point: str = "") -> Callable:
        """fn → retrying fn (partial application of ``call``)."""
        import functools

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, point=point, **kwargs)
        return wrapped


def _retry_metrics():
    from ..observability.metrics import get_registry
    reg = get_registry()
    return (reg.counter("retry_attempts_total",
                        "calls issued under a retry policy",
                        labelnames=("point",)),
            reg.counter("retry_giveups_total",
                        "retry policies exhausted (deadline or attempts)",
                        labelnames=("point",)))
