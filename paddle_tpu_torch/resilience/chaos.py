"""Deterministic, seed-driven fault injection (counterpart of
``paddle_tpu/resilience/chaos.py``).

A registry of NAMED fault points woven into the hot seams. The port
instruments these so far:

  * ``serving.step`` -- the continuous batcher's step
    (``inference/serving.py``);
  * ``gateway.step.<replica>`` -- one named replica's step in the
    gateway's pool (``inference/gateway/replica.py``); an error there
    bypasses the pool's retry policy and declares the replica dead;
  * ``kv.host_demote`` and ``kv.host_promote`` -- the tiered KV cache's
    demotion (``inference/prefix_cache.py``) and promotion
    (``inference/serving.py``);
  * ``kv.session_publish`` (through ``torn_write_bytes``) and
    ``kv.session_resume`` -- the session manifests
    (``inference/session_store.py``).

Fault kinds: ``delay`` (sleep), ``transient_error`` (raise a retryable
``TransientChaosError``), ``torn_write`` and ``nan_grad`` (returned to the
instrumented site, which owns their semantics), ``kill_rank``
(``os._exit`` of a chosen rank in multi-process worlds).

Determinism: firing decisions come from one ``random.Random(seed)`` plus
per-point hit counters, so the SAME scenario spec against the same call
sequence fires at the same hit indices.

Zero overhead when disabled: instrumented sites call ``fault_point(name)``,
which is a single module-global check (``_ARMED``) before returning.

Scenario specs (``arm_scenario(spec)``)::

    seed=7; serving.step:transient_error:p=0.5,count=3

i.e. ``;``-separated entries, each ``point:kind[:k=v,...]``, with an
optional ``seed=N`` entry applying to the whole scenario.

Not ported yet: arming from the environment (``PADDLE_CHAOS``), which no
caller in the port needs, and the other seams' points (checkpoint writes,
collectives, the data loader, the train step), whose modules are not
ported.
"""
from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = [
    "ChaosError", "TransientChaosError", "TornWrite", "FaultSpec",
    "ChaosRegistry", "fault_point", "arm_scenario",
    "disarm", "parse_scenario", "torn_write_bytes", "FAULT_KINDS",
]

FAULT_KINDS = ("delay", "transient_error", "torn_write", "nan_grad",
               "kill_rank")


class ChaosError(RuntimeError):
    """Base class of every injected failure."""


class TransientChaosError(ChaosError):
    """A retryable injected failure."""


class TornWrite(ChaosError):
    """Injected crash mid-write: the file was truncated at ``offset``."""

    def __init__(self, msg: str, offset: int):
        super().__init__(msg)
        self.offset = offset


@dataclass
class FaultSpec:
    """One armed fault: where, what, and when it fires.

    after: skip the first N hits of the point.
    count: fire at most N times (None = every eligible hit).
    p:     per-eligible-hit firing probability (seeded RNG -> replayable).
    delay_s / offset / rank parameterize their kinds.
    """
    point: str
    kind: str
    after: int = 0
    count: Optional[int] = None
    p: float = 1.0
    delay_s: float = 0.05
    offset: int = 0              # torn_write: bytes written before the cut
    rank: Optional[int] = None   # kill_rank target (default: every rank)
    exit_code: int = 1
    fired: int = field(default=0, compare=False)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {FAULT_KINDS})")


# module-global fast path: fault_point() reads this before anything else
_ARMED = False


def _registry_metrics():
    from ..observability.metrics import get_registry
    reg = get_registry()
    return reg.counter("faults_injected_total",
                       "chaos faults fired, by point and kind",
                       labelnames=("point", "kind"))


class ChaosRegistry:
    """Armed fault specs + deterministic firing state."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._rng = random.Random(seed)
        self._specs: Dict[str, List[FaultSpec]] = {}
        self._hits: Dict[str, int] = {}
        self._lock = threading.Lock()

    # -- arming -------------------------------------------------------------
    def arm(self, spec: FaultSpec) -> FaultSpec:
        global _ARMED
        with self._lock:
            self._specs.setdefault(spec.point, []).append(spec)
        _ARMED = True
        return spec

    def clear(self):
        global _ARMED
        with self._lock:
            self._specs.clear()
            self._hits.clear()
            self._rng = random.Random(self.seed)
        _ARMED = False

    def reseed(self, seed: int):
        with self._lock:
            self.seed = seed
            self._rng = random.Random(seed)

    # -- firing -------------------------------------------------------------
    def _select(self, point: str) -> Optional[FaultSpec]:
        """Deterministically decide whether (and which) fault fires at
        this hit of `point`. Counters and the RNG advance under the lock
        so concurrent sites (serving + a background save) stay replayable
        per-point."""
        with self._lock:
            hit = self._hits.get(point, 0)
            self._hits[point] = hit + 1
            for spec in self._specs.get(point, ()):
                if hit < spec.after:
                    continue
                if spec.count is not None and spec.fired >= spec.count:
                    continue
                if spec.p < 1.0 and self._rng.random() >= spec.p:
                    continue
                spec.fired += 1
                return spec
        return None

    def fire(self, point: str) -> Optional[FaultSpec]:
        """Evaluate the point. Raises for error kinds, sleeps for delay,
        exits the process for a matching kill_rank, and RETURNS the spec
        for value kinds (torn_write, nan_grad) the site interprets."""
        spec = self._select(point)
        if spec is None:
            return None
        _registry_metrics().labels(point=point, kind=spec.kind).inc()
        # journal the injection BEFORE executing it: for kill_rank this is
        # the victim's last flight-ring entry and spool line ("fault" key,
        # not "kind": that slot names the record type)
        from ..observability.fleet import spool_event
        from ..observability.flight import flight_record
        flight_record("chaos", point=point, fault=spec.kind)
        spool_event("chaos", point=point, fault=spec.kind)
        if spec.kind == "delay":
            time.sleep(spec.delay_s)
            return None
        if spec.kind == "transient_error":
            raise TransientChaosError(
                f"injected transient failure at {point} "
                f"(hit {self._hits[point] - 1})")
        if spec.kind == "kill_rank":
            rank = int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0)
            if spec.rank is None or spec.rank == rank:
                os._exit(spec.exit_code)
            return None
        # torn_write / nan_grad: the instrumented site owns the semantics
        return spec


_CHAOS = ChaosRegistry()


def fault_point(name: str) -> Optional[FaultSpec]:
    """The hook instrumented sites call. One global check when disarmed."""
    if not _ARMED:
        return None
    return _CHAOS.fire(name)


# -- scenario specs ----------------------------------------------------------

_INT_KEYS = {"after", "count", "offset", "rank", "exit_code"}
_FLOAT_KEYS = {"p", "delay_s"}


def parse_scenario(spec: str) -> tuple[int, List[FaultSpec]]:
    """``seed=7; point:kind:k=v,...`` -> (seed, [FaultSpec, ...])."""
    seed = 0
    out: List[FaultSpec] = []
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        if entry.startswith("seed="):
            seed = int(entry[5:])
            continue
        parts = entry.split(":")
        if len(parts) < 2:
            raise ValueError(f"bad chaos entry {entry!r} "
                             f"(want point:kind[:k=v,...])")
        point, kind = parts[0].strip(), parts[1].strip()
        kw: Dict[str, object] = {}
        if len(parts) > 2 and parts[2].strip():
            for item in parts[2].split(","):
                k, _, v = item.partition("=")
                k = k.strip()
                if k in _INT_KEYS:
                    kw[k] = int(v)
                elif k in _FLOAT_KEYS:
                    kw[k] = float(v)
                else:
                    raise ValueError(f"unknown chaos option {k!r}")
        out.append(FaultSpec(point=point, kind=kind, **kw))
    return seed, out


def arm_scenario(spec: str) -> ChaosRegistry:
    """Parse and arm a scenario string on the process registry."""
    seed, specs = parse_scenario(spec)
    _CHAOS.clear()
    _CHAOS.reseed(seed)
    for s in specs:
        _CHAOS.arm(s)
    return _CHAOS


def disarm():
    _CHAOS.clear()


# -- torn-write plumbing -----------------------------------------------------

def torn_write_bytes(path: str, data: bytes, point: str = "checkpoint.write"):
    """Write `data` to `path` honoring an armed ``torn_write`` fault: the
    fault cuts the file at ``spec.offset`` bytes and raises ``TornWrite``
    — exactly what a mid-write kill leaves on disk. Other kinds at the
    point (delay/transient_error) apply BEFORE any byte lands."""
    spec = fault_point(point)
    if spec is not None and spec.kind == "torn_write":
        cut = max(0, min(spec.offset, len(data)))
        with open(path, "wb") as f:
            f.write(data[:cut])
            f.flush()
            os.fsync(f.fileno())
        raise TornWrite(
            f"injected torn write at {point}: {cut}/{len(data)} bytes of "
            f"{path!r} written before the crash", cut)
    with open(path, "wb") as f:
        f.write(data)
