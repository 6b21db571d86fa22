"""Per-tenant admission quotas: token buckets (counterpart of
``paddle_tpu/inference/gateway/quota.py``).

The gateway charges a request's worst-case token footprint
(``len(prompt) + max_new_tokens``) against its tenant's bucket at
submit time, so one tenant flooding the queue cannot starve the pool —
the classic serving-front-door rate limiter (DistServe/Orca deployments
put exactly this in front of the iteration-level scheduler). Tenants
without a configured bucket are unlimited.

Buckets refill continuously at ``rate`` tokens/second up to ``burst``.
The clock is injectable so tests replay deterministically.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

__all__ = ["TokenBucket", "TenantQuotas"]


class TokenBucket:
    """Continuous-refill token bucket (rate tokens/s, burst capacity)."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        if rate < 0:
            raise ValueError(f"rate must be >= 0, got {rate}")
        if burst <= 0:
            raise ValueError(f"burst must be positive, got {burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._level = float(burst)          # start full
        self._last = clock()

    def _refill(self):
        now = self._clock()
        dt = max(0.0, now - self._last)
        self._last = now
        self._level = min(self.burst, self._level + dt * self.rate)

    @property
    def level(self) -> float:
        self._refill()
        return self._level

    def try_take(self, n: float) -> bool:
        """Charge ``n`` tokens; False (nothing charged) when the bucket
        can't cover it."""
        self._refill()
        if n > self._level:
            return False
        self._level -= n
        return True


class TenantQuotas:
    """tenant -> TokenBucket map with an unlimited default.

    ``admit(tenant, cost)`` returns whether the charge fit; the caller
    (the gateway's submit path) raises the typed ``Overloaded`` on a
    False so quota rejections share the batchers' exception family.
    """

    def __init__(self, buckets: Optional[Dict[str, TokenBucket]] = None):
        self._buckets: Dict[str, TokenBucket] = dict(buckets or {})

    def set_quota(self, tenant: str, bucket: TokenBucket):
        self._buckets[tenant] = bucket

    def bucket(self, tenant: str) -> Optional[TokenBucket]:
        return self._buckets.get(tenant)

    def admit(self, tenant: str, cost: float) -> bool:
        b = self._buckets.get(tenant)
        if b is None:
            return True
        ok = b.try_take(cost)
        _quota_level_g().labels(tenant=tenant).set(b._level)
        return ok


def _quota_level_g():
    from ...observability.metrics import get_registry
    return get_registry().gauge(
        "gateway.quota.level",
        "tenant token-bucket level after the latest admit decision",
        labelnames=("tenant",))
