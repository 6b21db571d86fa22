"""Incremental token delivery with backpressure (counterpart of
``paddle_tpu/inference/gateway/streaming.py``).

``StreamingSession`` is the caller-facing handle for one gateway
request: iterate it to receive tokens as the replicas produce them
(TTFT-shaped delivery) instead of waiting for ``run_until_done``. The
gateway pushes tokens into the session's buffer after every step; a
consumer pulling an empty buffer DRIVES ``gateway.step()`` — the whole
control plane is single-threaded and consumer-paced, so no real
concurrency is needed for the simulation harness or the tests.

Backpressure: a batched decode step cannot pause one slot, so per-slot
flow control is impossible — the honest lever is INTAKE. While any open
session's buffer sits at/above ``max_buffered``, the gateway counts
``gateway.stream.backpressure`` and pauses dispatching NEW queued work
(decode of in-flight requests continues; buffered tokens are never
dropped). Consume or ``close()`` sessions you stop reading, or queued
requests wait behind the throttle.

Requeue transparency: a replica dying mid-stream is invisible here —
the gateway resumes the request on a survivor and the continuation
tokens arrive through the same buffer, exactly once each.
"""
from __future__ import annotations

from collections import deque
from typing import Iterator, List

__all__ = ["StreamingSession"]


def _stream_metrics():
    from ...observability.metrics import get_registry
    reg = get_registry()
    return (reg.gauge("gateway.stream.buffered",
                      "tokens buffered across open streaming sessions"),
            reg.counter("gateway.stream.backpressure",
                        "steps where a full session buffer paused "
                        "gateway intake"))


class StreamingSession:
    """Iterator over one request's generated tokens."""

    def __init__(self, gateway, req, max_buffered: int = 64):
        if max_buffered < 1:
            raise ValueError("max_buffered must be >= 1")
        self._gw = gateway
        self._req = req
        self.max_buffered = max_buffered
        self._buf: deque = deque()
        self.closed = False

    # -- gateway side ---------------------------------------------------------
    def push(self, tokens: List[int]):
        if self.closed:
            return
        if tokens and self._req.trace is not None \
                and "stream" not in self._req.spans:
            # delivery span: first buffered token -> finish/close
            self._req.spans["stream"] = self._req.trace.begin("stream")
        self._buf.extend(tokens)

    @property
    def buffered(self) -> int:
        return len(self._buf)

    @property
    def throttled(self) -> bool:
        """True while this session's backlog should pause gateway intake."""
        return not self.closed and len(self._buf) >= self.max_buffered

    # -- consumer side --------------------------------------------------------
    @property
    def gid(self) -> int:
        return self._req.gid

    @property
    def done(self) -> bool:
        return self._req.finished or self._req.failure is not None

    def close(self):
        """Detach: stop buffering (already-buffered tokens stay readable)
        and stop counting toward the intake throttle. The request itself
        keeps running; its full result stays available via
        ``gateway.result``."""
        self.closed = True
        sp = self._req.spans.pop("stream", None)
        if sp is not None:
            sp.end(delivered=len(self._req.delivered))
        self._gw._on_session_closed(self)

    def __iter__(self) -> Iterator[int]:
        return self

    def __next__(self) -> int:
        while True:
            if self._buf:
                return self._buf.popleft()
            if self._req.failure is not None:
                raise self._req.failure
            if self._req.finished or self.closed:
                raise StopIteration
            # consumer-paced production: an empty buffer drives the
            # control plane one step
            self._gw.step()

    def read_available(self) -> List[int]:
        """Drain whatever is buffered right now without stepping."""
        out = list(self._buf)
        self._buf.clear()
        return out
