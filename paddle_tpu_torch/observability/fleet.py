"""The per-rank telemetry spool (counterpart of the spool half of
``paddle_tpu/observability/fleet.py``).

When ``PADDLE_TELEMETRY_DIR`` is set, each process appends metrics
snapshots, finished trace spans and named events to its own
``rank<r>.jsonl`` shard (append + flush per line: a killed process's shard
is complete up to the moment of death). Serving step loops call
``autospool_tick`` so long-running engines snapshot periodically without
user code. Unset, every entry point costs one cached-global check.

Not ported yet: the collective enter/exit records and the cross-rank
``FleetAggregator`` with its straggler/desync/missing-rank findings.
"""
from __future__ import annotations

import json
import os
import socket
import threading
import time
from dataclasses import dataclass
from typing import List, Optional


__all__ = ["ProcessIdentity", "process_identity", "telemetry_dir",
           "TelemetrySpool", "get_spool", "reset_spool", "spool_event",
           "autospool_tick"]


# -- process identity --------------------------------------------------------

@dataclass(frozen=True)
class ProcessIdentity:
    rank: int
    world_size: int
    host: str
    pid: int


_IDENT: List[Optional[ProcessIdentity]] = [None]


def process_identity() -> ProcessIdentity:
    """This process's fleet identity, resolved once from the launcher
    env (rank 0 of a world of 1 when standalone)."""
    ident = _IDENT[0]
    if ident is None:
        ident = ProcessIdentity(
            rank=int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0),
            world_size=int(os.environ.get("PADDLE_TRAINERS_NUM", "1")
                           or 1),
            host=socket.gethostname(),
            pid=os.getpid())
        _IDENT[0] = ident
    return ident


def telemetry_dir() -> Optional[str]:
    return os.environ.get("PADDLE_TELEMETRY_DIR") or None


# -- per-rank spool ----------------------------------------------------------

class TelemetrySpool:
    """Append-only JSONL shard for ONE process (``rank<r>.jsonl``).

    Every line is flushed as written. The first line is a ``meta`` record
    carrying the process's identity.
    """

    def __init__(self, dirpath: str,
                 identity: Optional[ProcessIdentity] = None):
        self.identity = identity or process_identity()
        os.makedirs(dirpath, exist_ok=True)
        self.path = os.path.join(
            dirpath, f"rank{self.identity.rank:05d}.jsonl")
        self._lock = threading.Lock()
        self._f = open(self.path, "a")
        self.write({"kind": "meta", "rank": self.identity.rank,
                    "world_size": self.identity.world_size,
                    "host": self.identity.host, "pid": self.identity.pid,
                    "t": time.time()})

    def write(self, obj: dict) -> None:
        line = json.dumps(obj, separators=(",", ":"))
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()

    def metrics_snapshot(self) -> None:
        from .metrics import get_registry
        self.write({"kind": "metrics", "t": time.time(),
                    "series": get_registry().snapshot()})

    def span(self, span_dict: dict, wall_end: float) -> None:
        dur = span_dict.get("duration_s") or 0.0
        self.write({"kind": "span", "t": wall_end - dur,
                    "t_end": wall_end, **span_dict})

    def event(self, name: str, **fields) -> None:
        self.write({"kind": "event", "name": name, "t": time.time(),
                    **fields})

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


_UNPROBED = object()
_SPOOL = _UNPROBED   # _UNPROBED | None | TelemetrySpool
_SPOOL_LOCK = threading.Lock()


def get_spool() -> Optional[TelemetrySpool]:
    """This process's spool (lazily opened under PADDLE_TELEMETRY_DIR);
    None when spooling is disarmed."""
    global _SPOOL
    sp = _SPOOL
    if sp is not _UNPROBED:
        return sp
    with _SPOOL_LOCK:
        if _SPOOL is not _UNPROBED:
            return _SPOOL
        d = telemetry_dir()
        if not d:
            _SPOOL = None
            return None
        try:
            _SPOOL = TelemetrySpool(d)
        except OSError:
            _SPOOL = None
        return _SPOOL


def reset_spool() -> None:
    """Close + drop the cached spool AND identity so the next use
    re-reads the env."""
    global _SPOOL
    with _SPOOL_LOCK:
        if _SPOOL not in (None, _UNPROBED):
            _SPOOL.close()
        _SPOOL = _UNPROBED
        _IDENT[0] = None
        _TICK[0] = 0.0


def spool_event(name: str, **fields) -> None:
    sp = get_spool()
    if sp is not None:
        sp.event(name, **fields)


_TICK = [0.0]


def autospool_tick(min_interval: Optional[float] = None) -> bool:
    """Rate-limited metrics snapshot for long-running loops (serving steps
    call this each tick). Returns True when a snapshot was written.
    Disarmed: one cached-global check."""
    if _SPOOL is None:
        return False
    sp = get_spool()
    if sp is None:
        return False
    iv = (min_interval if min_interval is not None else
          float(os.environ.get("PADDLE_TELEMETRY_INTERVAL", "1.0")))
    now = time.monotonic()
    if now - _TICK[0] < iv:
        return False
    _TICK[0] = now
    sp.metrics_snapshot()
    return True
