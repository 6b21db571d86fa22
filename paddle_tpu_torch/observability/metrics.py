"""Process-wide metrics registry: Counter / Gauge / Histogram with labels
(counterpart of ``paddle_tpu/observability/metrics.py``).

The three Prometheus instrument kinds:

  * Counter   -- monotone integer count;
  * Gauge     -- settable float with a tracked peak (PEAK_VALUE analog);
  * Histogram -- fixed buckets + a bounded reservoir for streaming
                 p50/p95/p99 estimates.

Labeled series: ``registry.counter(name, labelnames=("engine",))`` returns
a family; ``family.labels(engine="dense")`` returns the per-series child.
All instruments are thread-safe. ``registry.snapshot()`` renders every
series as plain dicts.

Only the JAX package's pure-Python tier is ported: its native stat tier
(``core.native``, the C++ registry shared with its data loader) is left
out, so every cell is a Python cell and ``snapshot`` has no
``include_native`` series.
"""
from __future__ import annotations

import bisect
import os
import random
import threading
import zlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "DEFAULT_BUCKETS", "DEFAULT_QUANTILES"]

# latency-shaped default buckets (seconds); +Inf is implicit
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
DEFAULT_QUANTILES: Tuple[float, ...] = (0.5, 0.95, 0.99)
_RESERVOIR_CAP = 512


class _PyCell:
    """Float cell (current + peak) guarded by its own lock."""

    __slots__ = ("_lock", "cur", "pk")

    def __init__(self):
        self._lock = threading.Lock()
        self.cur = 0.0
        self.pk = 0.0

    def add(self, delta: float) -> None:
        with self._lock:
            self.cur += delta
            self.pk = max(self.pk, self.cur)

    def set(self, value: float) -> None:
        with self._lock:
            self.cur = value
            self.pk = max(self.pk, value)

    def reset(self) -> None:
        with self._lock:
            self.cur = 0.0
            self.pk = 0.0


def _series_key(name: str, labels: Dict[str, str]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


# -- instruments -------------------------------------------------------------

class Counter:
    """Monotone integer counter."""

    kind = "counter"

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.labels = dict(labels or {})
        self._cell = _PyCell()

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        self._cell.add(int(n))

    @property
    def value(self) -> int:
        return int(self._cell.cur)

    def _reset(self) -> None:
        self._cell.reset()

    def _series(self) -> dict:
        return {"name": self.name, "type": self.kind,
                "labels": self.labels, "value": self.value}


class Gauge:
    """Settable float gauge with a tracked peak (PEAK_VALUE analog)."""

    kind = "gauge"

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.labels = dict(labels or {})
        self._cell = _PyCell()

    def set(self, value: float) -> None:
        self._cell.set(value)

    @property
    def value(self) -> float:
        return self._cell.cur

    @property
    def peak(self) -> float:
        return self._cell.pk

    def _reset(self) -> None:
        self._cell.reset()

    def _series(self) -> dict:
        return {"name": self.name, "type": self.kind,
                "labels": self.labels, "value": self.value,
                "peak": self.peak}


class Histogram:
    """Fixed-bucket histogram + bounded-reservoir streaming quantiles.

    Buckets are upper bounds (ascending; +Inf implicit). The reservoir
    (uniform, seeded from the series name so runs are reproducible) keeps a
    bounded sample of observations for p50/p95/p99 estimates: exact below
    ``_RESERVOIR_CAP`` observations, an unbiased estimate above it.
    """

    kind = "histogram"

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None,
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.labels = dict(labels or {})
        bs = tuple(sorted(buckets if buckets is not None else
                          DEFAULT_BUCKETS))
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = bs
        self._lock = threading.Lock()
        self._counts = [0] * (len(bs) + 1)       # last = +Inf overflow
        self._sum = 0.0
        self._count = 0
        self._min = None
        self._max = None
        self._reservoir: List[float] = []
        # crc32, not hash(): str hashing is salted per process and the
        # reservoir must behave identically run to run
        self._rng = random.Random(zlib.crc32(
            _series_key(name, self.labels).encode()))

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._counts[bisect.bisect_left(self.buckets, v)] += 1
            self._sum += v
            self._count += 1
            self._min = v if self._min is None else min(self._min, v)
            self._max = v if self._max is None else max(self._max, v)
            if len(self._reservoir) < _RESERVOIR_CAP:
                self._reservoir.append(v)
            else:
                j = self._rng.randrange(self._count)
                if j < _RESERVOIR_CAP:
                    self._reservoir[j] = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> Optional[float]:
        """Streaming quantile estimate from the reservoir (None if empty).
        The extremes return the exact observed min/max."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile q must be in [0, 1], got {q}")
        with self._lock:
            if not self._reservoir:
                return None
            if q == 0.0:
                return self._min
            if q == 1.0:
                return self._max
            s = sorted(self._reservoir)
        if len(s) == 1:
            return s[0]
        idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
        return s[idx]

    def bucket_counts(self) -> List[int]:
        """Raw per-bucket counts (len(buckets)+1; the tail is +Inf)."""
        with self._lock:
            return list(self._counts)

    def _reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._sum = 0.0
            self._count = 0
            self._min = self._max = None
            self._reservoir = []

    def _series(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            total, ssum = self._count, self._sum
            mn, mx = self._min, self._max
        return {"name": self.name, "type": self.kind,
                "labels": self.labels,
                "buckets": list(self.buckets),
                "bucket_counts": counts,
                "count": total, "sum": ssum,
                "min": mn, "max": mx,
                "quantiles": {f"p{int(q * 100)}": self.quantile(q)
                              for q in DEFAULT_QUANTILES}}


class _Family:
    """Labeled metric family: one (name, labelnames) entry in the registry
    fanning out to per-label-value child instruments."""

    def __init__(self, name: str, kind: str, help: str,
                 labelnames: Tuple[str, ...], make_child):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = labelnames
        self._make_child = make_child
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def labels(self, **kw):
        if set(kw) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(kw)} != declared "
                f"{sorted(self.labelnames)}")
        key = tuple(str(kw[k]) for k in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._make_child(
                        dict(zip(self.labelnames, key)))
                    self._children[key] = child
        return child

    def children(self):
        with self._lock:
            return list(self._children.values())


class MetricsRegistry:
    """Name -> instrument/family map; the process-wide telemetry root."""

    def __init__(self):
        self._lock = threading.RLock()
        self._entries: Dict[str, object] = {}
        self._kinds: Dict[str, str] = {}

    @staticmethod
    def default_labels() -> Dict[str, str]:
        """Labels stamped onto every snapshot series (explicit series labels
        win), resolved from the distributed env at snapshot time:
        {"rank": <PADDLE_TRAINER_ID>} in a multi-process world, {} when
        world_size == 1."""
        try:
            world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1") or 1)
        except ValueError:
            world = 1
        if world > 1:
            return {"rank": os.environ.get("PADDLE_TRAINER_ID", "0")
                    or "0"}
        return {}

    # -- registration (idempotent; kind mismatch is an error) ---------------
    def _get_or_make(self, name: str, kind: str, help: str,
                     labelnames: Sequence[str], make_child):
        labelnames = tuple(labelnames or ())
        with self._lock:
            if name in self._entries:
                if self._kinds[name] != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{self._kinds[name]}, not {kind}")
                entry = self._entries[name]
                if labelnames and not isinstance(entry, _Family):
                    raise ValueError(f"metric {name!r} is unlabeled")
                if isinstance(entry, _Family) \
                        and entry.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} labelnames {entry.labelnames} "
                        f"!= {labelnames}")
                return entry
            if labelnames:
                entry = _Family(name, kind, help, labelnames, make_child)
            else:
                entry = make_child({})
                entry.help = help
            self._entries[name] = entry
            self._kinds[name] = kind
            return entry

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()):
        return self._get_or_make(
            name, "counter", help, labelnames,
            lambda labels: Counter(name, labels))

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()):
        return self._get_or_make(
            name, "gauge", help, labelnames,
            lambda labels: Gauge(name, labels))

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None):
        return self._get_or_make(
            name, "histogram", help, labelnames,
            lambda labels: Histogram(name, labels, buckets=buckets))

    def get(self, name: str):
        return self._entries.get(name)

    # -- snapshot -----------------------------------------------------------
    def _instruments(self) -> Iterable:
        with self._lock:
            entries = list(self._entries.values())
        for entry in entries:
            if isinstance(entry, _Family):
                yield from entry.children()
            else:
                yield entry

    def snapshot(self) -> List[dict]:
        """Every live series as plain dicts."""
        out = [inst._series() for inst in self._instruments()]
        defaults = self.default_labels()
        if defaults:
            for s in out:
                s["labels"] = {**defaults, **(s["labels"] or {})}
        return out

    def reset(self) -> None:
        """Zero every registered series."""
        for inst in self._instruments():
            inst._reset()


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every subsystem reports through."""
    return _REGISTRY
