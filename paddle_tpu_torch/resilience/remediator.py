"""The remediation half of the self-healing loop (counterpart of
``paddle_tpu/resilience/remediator.py``, cut to ``FlapGuard``).

``FlapGuard`` is the global action budget the gateway's ``Autoscaler``
passes every autonomous action through (and that the JAX package's
``AutoRemediator`` shares with it, so the two controllers spend one
budget).

Not ported yet (ROADMAP.md, queue 1, item 9: the host planes):
``AutoRemediator`` and its signal/policy/action types, with the SLO,
anomaly and fleet planes that feed it. ``AutoRemediator`` raises
``NotImplementedError`` naming that item.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Optional, Tuple

__all__ = ["FlapGuard", "AutoRemediator"]


class FlapGuard:
    """Global action budget with an escalate-don't-oscillate ladder.

    At most ``max_actions`` executed actions per rolling ``window_s``.
    A proposal over budget is rejected AND freezes the guard for
    ``freeze_s``; every subsequent breach doubles the freeze (capped at
    ``max_freeze_s``). A healthy stretch (no breach for a full window)
    resets the ladder.
    """

    def __init__(self, max_actions: int = 4, window_s: float = 60.0,
                 freeze_s: float = 120.0, max_freeze_s: float = 3600.0,
                 clock: Callable[[], float] = time.monotonic):
        if max_actions < 1:
            raise ValueError("max_actions must be >= 1")
        self.max_actions = int(max_actions)
        self.window_s = float(window_s)
        self.freeze_s = float(freeze_s)
        self.max_freeze_s = float(max_freeze_s)
        self._clock = clock
        self._times: deque = deque()
        self._freeze_until = 0.0
        self._last_breach = -float("inf")
        self.escalations = 0

    def _prune(self, now: float):
        while self._times and self._times[0] <= now - self.window_s:
            self._times.popleft()

    @property
    def frozen_until(self) -> float:
        return self._freeze_until

    def check(self, now: Optional[float] = None) -> Tuple[bool, str]:
        """(allowed, reason-if-not). Checking over budget escalates."""
        now = self._clock() if now is None else now
        if now < self._freeze_until:
            return False, "flap_frozen"
        self._prune(now)
        # the ladder re-arms only after a full CALM window — and frozen
        # time is not calm (nothing could act), so calm is measured from
        # whichever ended later: the last breach or the freeze it caused
        if now - max(self._last_breach, self._freeze_until) \
                > self.window_s:
            self.escalations = 0
        if len(self._times) >= self.max_actions:
            self.escalations += 1
            self._last_breach = now
            freeze = min(self.max_freeze_s,
                         self.freeze_s * (2 ** (self.escalations - 1)))
            self._freeze_until = now + freeze
            return False, "flap_budget"
        return True, ""

    def record(self, now: Optional[float] = None):
        self._times.append(self._clock() if now is None else now)


class AutoRemediator:
    """Not ported yet: the closed telemetry-to-action loop over one
    gateway (ROADMAP.md, queue 1, item 9)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "AutoRemediator (the self-healing loop) is not ported yet "
            "(ROADMAP.md, queue 1, item 9: the host planes)")
