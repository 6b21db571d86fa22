"""Crash-surviving flight recorder: a fixed-size binary ring journal
(counterpart of ``paddle_tpu/observability/flight.py``, the writing half).

When a process dies with ``os._exit``, everything buffered in userspace
dies with it. This ring is the black box that survives: a pre-allocated
fixed-geometry file per rank where every event lands via one unbuffered
``os.pwrite`` (the page cache persists across process death). The file
layout is the JAX package's, byte for byte, so its ``read_ring`` and
``tools/blackbox.py`` read the port's rings::

    header (64 B):  magic "PTFLIGHT" | version u32 | slot_size u32 |
                    nslots u32 | epoch u32 | rank i32 | pad
    slot  (slot_size B, nslots of them):
                    seq u64 | epoch u32 | len u32 | wall_t f64 |
                    crc32 u32 | payload (JSON, truncated to fit)

Appends are O(1): slot index = ``seq % nslots``. Reopen recovers the
cursor by scanning for the max valid seq and bumps the epoch header.

Events recorded in the port: span open/close (``trace_context``), chaos
injections, written BEFORE the fault executes (``resilience.chaos``), and
the autoscaler's decisions (``inference.gateway.autoscaler``).

Armed iff ``PADDLE_TELEMETRY_DIR`` is set (one cached check per event
when disarmed); the ring lives at ``<dir>/flight-rank<r>.ring``.

Not ported yet (ROADMAP.md, queue 1, item 9: the host planes): the
reading half, ``read_ring`` and ``build_postmortem``.
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Optional

from ..utils.locks import TracedLock

__all__ = ["FlightRecorder", "get_flight", "flight_record", "reset_flight"]

_MAGIC = b"PTFLIGHT"
_VERSION = 1
_HDR = struct.Struct("<8sIIIIi")          # magic, ver, slot, nslots, epoch, rank
_HDR_SIZE = 64
_SLOT_HDR = struct.Struct("<QIIdI")       # seq, epoch, len, wall_t, crc
_DEFAULT_SLOTS = 2048
_DEFAULT_SLOT_SIZE = 256


class FlightRecorder:
    """One rank's ring journal (open for appending)."""

    def __init__(self, path: str, slots: int = _DEFAULT_SLOTS,
                 slot_size: int = _DEFAULT_SLOT_SIZE, rank: int = 0):
        if slot_size <= _SLOT_HDR.size + 2:
            raise ValueError(f"slot_size {slot_size} too small")
        self.path = path
        self._lock = TracedLock("FlightRecorder._lock")
        existing = os.path.exists(path) and os.path.getsize(path) >= _HDR_SIZE
        self._fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        if existing:
            hdr = os.pread(self._fd, _HDR_SIZE, 0)
            magic, ver, fss, fns, epoch, frank = _HDR.unpack(
                hdr[:_HDR.size])
            if magic != _MAGIC or ver != _VERSION:
                raise ValueError(f"{path}: not a flight ring "
                                 f"(magic={magic!r} ver={ver})")
            # adopt the file's geometry — a reopened ring keeps its shape
            self.slot_size, self.nslots = fss, fns
            self.rank = rank if rank is not None else frank
            self.epoch = epoch + 1
            self._seq = self._recover_seq()
        else:
            self.slot_size, self.nslots = int(slot_size), int(slots)
            self.rank = rank
            self.epoch = 0
            self._seq = 0
            os.ftruncate(self._fd,
                         _HDR_SIZE + self.nslots * self.slot_size)
        self._write_header()          # epoch header, fsync'd

    def _write_header(self):
        hdr = _HDR.pack(_MAGIC, _VERSION, self.slot_size, self.nslots,
                        self.epoch, self.rank)
        os.pwrite(self._fd, hdr.ljust(_HDR_SIZE, b"\0"), 0)
        os.fsync(self._fd)

    def _recover_seq(self) -> int:
        top = 0
        for i in range(self.nslots):
            raw = os.pread(self._fd, _SLOT_HDR.size,
                           _HDR_SIZE + i * self.slot_size)
            if len(raw) < _SLOT_HDR.size:
                continue
            seq, _ep, ln, _t, crc = _SLOT_HDR.unpack(raw)
            if ln == 0 or ln > self.slot_size - _SLOT_HDR.size:
                continue
            top = max(top, seq + 1)
        return top

    @property
    def seq(self) -> int:
        return self._seq

    def record(self, kind: str, wall_t: Optional[float] = None,
               **fields) -> int:
        """Append one event; returns its seq. One pwrite, no fsync —
        page-cache durability is exactly the survive-``os._exit`` bar."""
        import time
        t = time.time() if wall_t is None else wall_t
        cap = self.slot_size - _SLOT_HDR.size
        payload = json.dumps({"kind": kind, **fields},
                             separators=(",", ":")).encode()
        if len(payload) > cap:
            payload = json.dumps(
                {"kind": kind, "truncated": True},
                separators=(",", ":")).encode()[:cap]
        with self._lock:
            seq = self._seq
            self._seq += 1
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        slot = _SLOT_HDR.pack(seq, self.epoch, len(payload), t, crc) \
            + payload
        os.pwrite(self._fd, slot, _HDR_SIZE + (seq % self.nslots)
                  * self.slot_size)
        return seq

    def close(self):
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None


# -- process-wide recorder (armed by PADDLE_TELEMETRY_DIR) -------------------

_UNPROBED = object()
_REC = _UNPROBED   # _UNPROBED | None (disabled) | FlightRecorder
_REC_LOCK = TracedLock("flight._REC_LOCK")


def _resolve_rank() -> int:
    return int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0)


def get_flight() -> Optional[FlightRecorder]:
    """This process's ring (created lazily under PADDLE_TELEMETRY_DIR);
    None when telemetry is disarmed."""
    global _REC
    rec = _REC
    if rec is not _UNPROBED:
        return rec
    with _REC_LOCK:
        if _REC is not _UNPROBED:
            return _REC
        d = os.environ.get("PADDLE_TELEMETRY_DIR")
        if not d:
            _REC = None
            return None
        os.makedirs(d, exist_ok=True)
        rank = _resolve_rank()
        slots = int(os.environ.get("PADDLE_FLIGHT_SLOTS",
                                   str(_DEFAULT_SLOTS)))
        try:
            _REC = FlightRecorder(
                os.path.join(d, f"flight-rank{rank:05d}.ring"),
                slots=slots, rank=rank)
        except OSError:
            _REC = None
        return _REC


def flight_record(kind: str, **fields) -> None:
    """Record an event on this process's ring; no-op when disarmed
    (one cached-global check)."""
    rec = _REC
    if rec is _UNPROBED:
        rec = get_flight()
    if rec is not None:
        rec.record(kind, **fields)


def reset_flight() -> None:
    """Drop the cached recorder so the next event re-probes the env
    (tests re-point PADDLE_TELEMETRY_DIR between cases)."""
    global _REC
    with _REC_LOCK:
        if _REC not in (None, _UNPROBED):
            _REC.close()
        _REC = _UNPROBED
