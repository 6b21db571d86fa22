"""TracedLock / TracedRLock (counterpart of ``paddle_tpu/utils/locks.py``,
cut to the two factories).

Drop-in ``threading.Lock``/``RLock`` factories, gated by
``PADDLE_LOCK_WITNESS``. Off (unset or ``0``, the default) they return a
raw ``threading`` lock object, not a wrapper, so the hot path pays
nothing beyond one factory call at construction time.

Not ported yet (ROADMAP.md, queue 1, item 9): the runtime lock-order
witness that the variable turns on (``LockWitness``, the CC405/CC406
findings and ``dump_witness``). With the variable on, the factories
raise ``NotImplementedError`` rather than hand back an unwitnessed lock.
"""
from __future__ import annotations

import os
import threading

__all__ = ["TracedLock", "TracedRLock", "witness_enabled"]

_ON = {"1", "on", "true", "yes", "record", "strict", "raise"}


def witness_enabled() -> bool:
    return os.environ.get("PADDLE_LOCK_WITNESS", "0").lower() in _ON


def _no_witness():
    raise NotImplementedError(
        "PADDLE_LOCK_WITNESS is set, but the lock-order witness is not "
        "ported yet (ROADMAP.md, queue 1, item 9: the host planes); unset "
        "it to get plain threading locks")


def TracedLock(name: str = ""):
    """``threading.Lock`` (the witness is off). ``name`` is the lock's
    identity in the witness's order graph."""
    if witness_enabled():
        _no_witness()
    return threading.Lock()


def TracedRLock(name: str = ""):
    """Reentrant variant of ``TracedLock``."""
    if witness_enabled():
        _no_witness()
    return threading.RLock()
