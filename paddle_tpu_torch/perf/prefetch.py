"""Asynchronous host-to-device staging (counterpart of
``paddle_tpu/perf/prefetch.py``, cut to ``TransferCancelled``,
``TransferFuture`` and ``AsyncLoader``: the promotion lane of the tiered KV
cache).

On the card a worker thread issues the copy of a tree of CPU tensors on a
CUDA stream of its own (``non_blocking``: from pinned memory the copy
overlaps whatever the main stream runs), records an event, waits for it
and completes the future, so ``TransferFuture.done()`` means the copy has
landed. The staged tensors were allocated on the worker's stream: the
consumer makes its own stream wait on ``TransferFuture.event`` before it
reads them and calls ``record_stream`` on them after (``consume``). With
no device (``device=None`` or a CPU device) the worker only materializes
the payload and returns it.

Not ported: ``DevicePrefetcher`` and ``coalesced_device_put`` (the
training input pipeline's prefetcher), which no ported path calls.
"""
from __future__ import annotations

import queue as queue_mod
import threading
import time
from typing import Optional

import torch

from ..utils.locks import TracedLock

__all__ = ["AsyncLoader", "TransferCancelled", "TransferFuture", "consume"]


class TransferCancelled(RuntimeError):
    """The transfer was still queued (never issued to the device) when its
    AsyncLoader closed. Distinct from a transfer failure: no copy ever ran
    for this payload, so the caller's host-side source of truth is
    untouched and a clean fallback (re-prefill, re-promotion on another
    replica) is always available."""


class TransferFuture:
    """Completion handle for one AsyncLoader transfer (``threading.Event``
    based: ``done()`` is the poll the batcher's admission loop uses).
    ``event`` is the CUDA event recorded after the copy on the card (None
    on the CPU)."""

    __slots__ = ("_ev", "_result", "_exc", "event")

    def __init__(self):
        self._ev = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None
        self.event = None

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError("transfer not complete")
        if self._exc is not None:
            raise self._exc
        return self._result

    def _set(self, value):
        self._result = value
        self._ev.set()

    def _fail(self, exc: BaseException):
        self._exc = exc
        self._ev.set()


def _to_device(tree, device):
    """Copy every tensor leaf of ``tree`` to ``device`` (non-blocking on the
    current stream); other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device, non_blocking=True)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_to_device(v, device) for v in tree]
        return tuple(out) if isinstance(tree, tuple) else out
    return tree


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def consume(fut: TransferFuture, staged):
    """Order the current stream after ``fut``'s copy and tie the staged
    tensors' memory to it, so the caching allocator does not hand their
    blocks to the worker's stream while reads queued here are pending.
    A no-op for a transfer that ran on the CPU."""
    if fut.event is None:
        return
    stream = torch.cuda.current_stream(fut.event.device)
    stream.wait_event(fut.event)
    for t in _leaves(staged):
        if t.is_cuda:
            t.record_stream(stream)


class AsyncLoader:
    """Background host-to-device stager: the promotion lane of the tiered
    KV cache. ``submit(tree_of_tensors)`` returns a :class:`TransferFuture`;
    a daemon worker copies the whole tree to ``device`` on its own CUDA
    stream, waits until it has landed and completes the future. The queue
    is bounded (``depth``, default 2: double buffering), so a burst of
    submissions backpressures instead of pinning unbounded host memory.

    A callable payload is invoked by the worker to materialize the real
    tree first: the hook the pipelined promotion stream uses to take
    host and disk blob reads off the critical path too, so a later
    chunk's read overlaps an earlier chunk's install. Errors from the
    callable fail the future exactly like transfer errors.
    """

    def __init__(self, depth: int = 2, device=None,
                 name: str = "paddle_tpu_kv_promoter", workers: int = 1):
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=max(1, depth))
        self._device = torch.device(device) if device is not None else None
        # intake lock: serializes submit against close on the _closed flag
        # and close()'s queued-cancel drain; never held across the bounded
        # queue put in submit() or the worker joins in close()
        self._intake = TracedLock("AsyncLoader._intake")
        self._closed = False
        from ..observability.metrics import get_registry
        reg = get_registry()
        self._loads = reg.counter(
            "prefetch.async_loads", "pytrees staged to device by AsyncLoader")
        self._load_h = reg.histogram(
            "prefetch.async_load_seconds",
            "AsyncLoader per-submit read, copy and wait seconds")
        self._cancelled = reg.counter(
            "prefetch.async_cancelled",
            "queued transfers cancelled (never issued) by AsyncLoader.close")
        # a small pool (workers > 1) lets independent submissions'
        # callable payloads materialize concurrently; each future still
        # completes on its own, and callers that need order impose it
        self._threads = [
            threading.Thread(target=self._run, daemon=True,
                             name=f"{name}-{i}" if workers > 1 else name)
            for i in range(max(1, workers))]
        for t in self._threads:
            t.start()

    def _run(self):
        cuda = self._device is not None and self._device.type == "cuda"
        stream = torch.cuda.Stream(self._device) if cuda else None
        while True:
            item = self._q.get()
            if item is None:
                return
            fut, payload = item
            if self._closed:
                # drain mode: the item was queued but never issued; fail it
                # typed instead of touching the device
                self._cancelled.inc()
                fut._fail(TransferCancelled(
                    "AsyncLoader closed before transfer was issued"))
                continue
            try:
                t0 = time.perf_counter()
                if callable(payload):
                    payload = payload()
                if cuda:
                    with torch.cuda.stream(stream):
                        staged = _to_device(payload, self._device)
                        ev = torch.cuda.Event()
                        ev.record(stream)
                    ev.synchronize()
                    fut.event = ev
                else:
                    staged = payload
                self._load_h.observe(time.perf_counter() - t0)
                self._loads.inc()
                fut._set(staged)
            except BaseException as e:  # noqa: BLE001 — surfaced via future
                fut._fail(e)

    def submit(self, payload) -> TransferFuture:
        with self._intake:
            if self._closed:
                raise RuntimeError("AsyncLoader is closed")
            fut = TransferFuture()
        # the bounded (possibly blocking) put runs with the intake lock
        # released; a close() racing in here is handled by the workers'
        # drain-mode check, which cancels the item typed
        self._q.put((fut, payload))
        return fut

    def close(self, timeout: float = 2.0):
        """Idempotent bounded shutdown with deterministic queued-cancel.

        Transfers already issued (the worker is inside the copy) complete
        normally; everything still in the queue when close begins fails
        with :class:`TransferCancelled`, never issued. The queue is drained
        here and every worker checks ``_closed`` after every ``get``, so an
        item a worker races us to is cancelled on its side.
        """
        deadline = time.perf_counter() + timeout
        with self._intake:
            already = self._closed
            if not already:
                self._closed = True
                while True:
                    try:
                        item = self._q.get_nowait()
                    except queue_mod.Empty:
                        break
                    if item is None:
                        continue
                    fut, _ = item
                    self._cancelled.inc()
                    fut._fail(TransferCancelled(
                        "AsyncLoader closed before transfer was issued"))
        if not already:
            for _ in self._threads:
                # blocking put is safe: workers in drain mode consume fast;
                # it runs after the intake lock is dropped
                self._q.put(None)
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.perf_counter()))

    def __del__(self):  # pragma: no cover — best-effort cleanup
        try:
            self.close(timeout=0.2)
        except Exception:
            pass
