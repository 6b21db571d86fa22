"""Request-scoped tracing (counterpart of
``paddle_tpu/observability/trace_context.py``).

A ``TraceContext`` (trace_id + root span + baggage) follows ONE request
across subsystem boundaries: a fronting layer mints it, and the serving
batcher stores it on its ``Request`` record and opens admit / prefill /
decode spans under it. Spans are recorded with explicit begin/end
timestamps (not context managers) because serving spans open in one call
and close several steps later (``decode`` opens at admission and closes
when the request finishes). ``TraceSpan.end`` is idempotent, so abort
paths (deadline expiry, ``abort``) can close whatever is open without
double-recording. Finished spans go to a bounded ring (``get_recorder``),
to the ``trace.*`` metrics and, when armed, to the telemetry spool; span
open and close also go to the flight recorder's ring when it is armed.
The gateway mints one trace per request at submit, and the trace survives
a requeue off a dead replica (later spans carry the ``requeued=1``
baggage tag).

Set ``PADDLE_TRACE=0`` to disable minting entirely.

Not ported yet: the W3C ``traceparent`` propagation and the Chrome/JSONL
exports.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = ["TraceContext", "TraceSpan", "TraceRecorder", "get_recorder",
           "new_trace", "enabled", "end_open_spans"]

_TRACE_IDS = itertools.count(1)
_SPAN_IDS = itertools.count(1)
_RECORDER_CAP = int(os.environ.get("PADDLE_TRACE_CAP", "8192"))


def enabled() -> bool:
    """Tracing on/off switch (env ``PADDLE_TRACE``, default on)."""
    return os.environ.get("PADDLE_TRACE", "1") != "0"


def _flight_record(kind: str, **fields) -> None:
    # one cached-global check when the flight ring is disarmed
    from .flight import flight_record
    flight_record(kind, **fields)


def _trace_metrics():
    from .metrics import get_registry
    reg = get_registry()
    return (reg.counter("trace.spans_total",
                        "request-trace spans recorded"),
            reg.counter("trace.spans_dropped",
                        "spans evicted from the bounded trace ring"),
            reg.histogram("trace.span_seconds",
                          "request-trace span wall time by span name",
                          labelnames=("span",)))


class TraceSpan:
    """One timed scope of one request's trace (explicit begin/end)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name",
                 "start_ns", "end_ns", "tags")

    def __init__(self, trace_id: str, name: str,
                 parent_id: Optional[str] = None,
                 tags: Optional[Dict[str, object]] = None):
        self.trace_id = trace_id
        self.span_id = f"{next(_SPAN_IDS):08x}"
        self.parent_id = parent_id
        self.name = name
        self.start_ns = time.perf_counter_ns()
        self.end_ns: Optional[int] = None
        self.tags: Dict[str, object] = dict(tags or {})
        _flight_record("span_open", name=name, trace_id=trace_id,
                       span_id=self.span_id)

    @property
    def duration_s(self) -> Optional[float]:
        if self.end_ns is None:
            return None
        return (self.end_ns - self.start_ns) / 1e9

    def end(self, **tags) -> "TraceSpan":
        """Close + record the span (idempotent: the first end wins, later
        calls only merge tags)."""
        if self.end_ns is not None:
            self.tags.update(tags)
            return self
        self.end_ns = time.perf_counter_ns()
        self.tags.update(tags)
        _flight_record("span_close", name=self.name,
                       trace_id=self.trace_id, span_id=self.span_id)
        get_recorder().record(self)
        spans_c, _, span_h = _trace_metrics()
        spans_c.inc()
        span_h.labels(span=self.name).observe(self.duration_s)
        return self

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "duration_s": self.duration_s, "tags": dict(self.tags)}

    def __repr__(self):
        return (f"TraceSpan({self.name!r}, trace={self.trace_id}, "
                f"dur={self.duration_s})")


class TraceContext:
    """One request's identity: trace_id + root span + baggage.

    ``baggage`` is the propagated tag set: every span begun through this
    context inherits it AT BEGIN TIME, so a tag added mid-flight marks all
    LATER spans without rewriting history.
    """

    __slots__ = ("trace_id", "root", "baggage")

    def __init__(self, trace_id: str, root: Optional[TraceSpan] = None,
                 baggage: Optional[Dict[str, object]] = None):
        self.trace_id = trace_id
        self.root = root
        self.baggage: Dict[str, object] = dict(baggage or {})

    @property
    def span_id(self) -> Optional[str]:
        return self.root.span_id if self.root is not None else None

    def begin(self, name: str, parent: Optional[TraceSpan] = None,
              **tags) -> TraceSpan:
        """Open a child span (parent defaults to the root span).
        Baggage merges under explicit tags."""
        merged = dict(self.baggage)
        merged.update(tags)
        pid = (parent or self.root)
        return TraceSpan(self.trace_id, name,
                         parent_id=pid.span_id if pid else None,
                         tags=merged)

    def event(self, name: str, **tags) -> TraceSpan:
        """Instantaneous marker span (begin + immediate end)."""
        return self.begin(name, **tags).end()

    def finish(self, **tags) -> None:
        if self.root is not None:
            self.root.end(**tags)


def new_trace(name: str = "request", **tags) -> TraceContext:
    """Mint a fresh trace: new trace_id + an OPEN root span."""
    trace_id = f"{next(_TRACE_IDS):016x}"
    ctx = TraceContext(trace_id)
    ctx.root = TraceSpan(trace_id, name, tags=tags)
    return ctx


def end_open_spans(spans: Dict[str, TraceSpan], **tags) -> None:
    """Close every open span in a request's span map (abort paths:
    deadline expiry, abort) and clear the map."""
    for sp in list(spans.values()):
        sp.end(**tags)
    spans.clear()


class TraceRecorder:
    """Bounded ring of FINISHED spans."""

    def __init__(self, capacity: int = _RECORDER_CAP):
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=max(1, capacity))
        self._drop_warned = False

    def record(self, span: TraceSpan) -> None:
        warn = False
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                _trace_metrics()[1].inc()
                if not self._drop_warned:
                    self._drop_warned = warn = True
            self._spans.append(span)
        if warn:
            import logging
            logging.getLogger(__name__).warning(
                "trace recorder full (capacity=%d): spans are being "
                "dropped; raise PADDLE_TRACE_CAP", self._spans.maxlen)
        from .fleet import get_spool
        sp = get_spool()
        if sp is not None:
            sp.span(span.to_dict(), time.time())

    def spans(self, trace_id: Optional[str] = None) -> List[TraceSpan]:
        with self._lock:
            out = list(self._spans)
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        return sorted(out, key=lambda s: s.start_ns)

    def trace_ids(self) -> List[str]:
        """Distinct trace ids in recording order."""
        return list(dict.fromkeys(s.trace_id for s in self.spans()))

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._drop_warned = False


_RECORDER = TraceRecorder()


def get_recorder() -> TraceRecorder:
    """The process-wide trace recorder."""
    return _RECORDER
