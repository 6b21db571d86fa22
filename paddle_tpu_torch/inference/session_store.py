"""Crash-safe, replica-independent session manifests for durable resume
(counterpart of ``paddle_tpu/inference/session_store.py``; the manifest's
file format is the JAX package's byte for byte, so a manifest written by
either package loads in the other).

A paused conversation's KV chain lives in the radix tree as anonymous
tiered residency — enough to survive churn (the session pin keeps the
chain no lower than the last tier) but not replica death or a fleet
rescale, because tier blobs are keyed per-process. This module adds the
missing identity layer: a **session manifest** on shared storage mapping

    session id -> ordered chain hashes + token ids + model identity
                  + last activity

so ANY replica can later resolve a returning session: if its own cache
still holds the chain (same tokens -> same chain hashes), resume rides
tiered promotion; if not, the manifest's token ids are everything needed
for a full re-prefill — token-exact either way under greedy decoding.

Durability contract (the round-6 checkpoint pattern):

  * publish writes ``<sid>.json.tmp`` through
    ``chaos.torn_write_bytes(..., point="kv.session_publish")`` then
    ``os.replace``s it over the final path — a crash mid-publish leaves
    only a ``.tmp`` no reader trusts, and the previous manifest (if any)
    stays sound.
  * the manifest body carries a whole-document crc32 plus one crc32 PER
    block entry (over the block's packed int64 token bytes — the same
    bytes the chain hash consumed), so a reader detects truncation,
    bit-rot, and token/hash drift independently, stdlib-only.
  * ``load`` never raises on a bad manifest: every failure mode becomes
    a typed :class:`SessionFinding` (``torn_manifest``, ``unreadable``,
    ``checksum_mismatch``, ``entry_checksum_mismatch``, ``hash_drift``,
    ``model_mismatch``, ``resume_fault``, ``missing``) and a ``None``
    return — the caller's contract is "fall back to full re-prefill".

``kv.session_resume`` is the chaos seam at the top of ``load``: a drill
can fail the manifest read itself and watch the fleet degrade cleanly.
"""
from __future__ import annotations

import json
import os
import re
import struct
import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from .prefix_cache import chain_hashes

__all__ = ["SessionManifest", "SessionFinding", "SessionStore",
           "model_identity", "MANIFEST_VERSION"]

MANIFEST_VERSION = 1


def model_identity(model) -> str:
    """Stable identity string for resume-compatibility checks: the model
    class plus the config fields that change logits. Two processes
    serving the same architecture/shape agree; a vocab or depth change
    does not. Calibrated cachekv-int8 scales fold into the identity too:
    a chain of int8 pages is only replayable under the SAME scales, so
    calibration drift between pause and resume must conservatively
    degrade to a full re-prefill rather than dequantize with the wrong
    scales."""
    cfg = getattr(model, "config", None)
    if cfg is None:
        return type(model).__name__
    fields = getattr(cfg, "__dict__", None) or {}
    sig = ",".join(f"{k}={fields[k]!r}" for k in sorted(fields)
                   if not k.startswith("_"))
    h = zlib.crc32(sig.encode()) & 0xFFFFFFFF
    scales = getattr(model, "_cachekv_scales", None)
    if scales is not None:
        q = 0
        for layer in scales:
            for k in sorted(layer):
                v = layer[k]
                if isinstance(v, torch.Tensor):
                    v = v.detach().to("cpu", torch.float32).numpy()
                q = zlib.crc32(np.ascontiguousarray(
                    np.asarray(v, np.float32)).tobytes(), q)
        return f"{type(model).__name__}:{h:08x}:q{q & 0xFFFFFFFF:08x}"
    return f"{type(model).__name__}:{h:08x}"


def _pack_tokens(tokens) -> bytes:
    """Packed little-endian int64 token bytes — byte-identical to
    ``np.asarray(tokens, np.int64).tobytes()`` with the standard library
    alone, so a reader without numpy can recompute every CRC."""
    return b"".join(struct.pack("<q", int(t)) for t in tokens)


@dataclass
class SessionManifest:
    """One durable session: everything a stranger replica needs to
    resume it (tokens for re-prefill, chain hashes for cache matching,
    model identity for compatibility, last activity for GC policy)."""

    session_id: str
    token_ids: List[int]
    block_size: int
    chain: List[int] = field(default_factory=list)  # ordered chain hashes
    model: str = ""
    last_activity: float = 0.0

    def __post_init__(self):
        self.token_ids = [int(t) for t in self.token_ids]
        if not self.chain:
            self.chain = chain_hashes(self.token_ids, self.block_size)

    @property
    def n_blocks(self) -> int:
        return len(self.chain)

    @property
    def covered_tokens(self) -> int:
        """Tokens whose KV a cached chain can supply (full blocks)."""
        return self.n_blocks * self.block_size


@dataclass
class SessionFinding:
    """A typed manifest problem: what broke, on which session, and why —
    the session analogue of the fleet's remediation findings."""

    kind: str          # torn_manifest | unreadable | checksum_mismatch |
    #                    entry_checksum_mismatch | hash_drift |
    #                    model_mismatch | resume_fault | missing |
    #                    publish_torn
    session_id: str
    path: str
    detail: str = ""


def _metrics():
    from ..observability.metrics import get_registry
    reg = get_registry()
    return (reg.counter("session.published",
                        "session manifests atomically published"),
            reg.counter("session.publish_failures",
                        "manifest publishes that failed (torn write/IO)"),
            reg.counter("session.resumed",
                        "sessions resolved from a sound manifest"),
            reg.counter("session.manifest_corrupt",
                        "manifest loads rejected (torn/corrupt/mismatch)"))


class SessionStore:
    """Filesystem-backed manifest store. ``root`` is the shared volume
    every replica and gateway can reach; the store itself is stateless
    beyond a findings journal, so any number of processes can share one
    root (publishes are atomic whole-file replaces)."""

    def __init__(self, root: str):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self.findings: List[SessionFinding] = []
        (self._published_c, self._publish_fail_c,
         self._resumed_c, self._corrupt_c) = _metrics()

    # -- paths ---------------------------------------------------------------
    def path_for(self, session_id: str) -> str:
        """Human-readable but collision-safe filename: sanitized id plus
        a crc of the raw id (two ids differing only in stripped chars
        cannot alias)."""
        safe = re.sub(r"[^A-Za-z0-9._-]", "_", session_id)[:80]
        tag = zlib.crc32(session_id.encode()) & 0xFFFFFFFF
        return os.path.join(self.root, f"{safe}.{tag:08x}.json")

    def sessions(self) -> List[str]:
        """Session ids with a published (non-tmp) manifest."""
        out = []
        for name in sorted(os.listdir(self.root)):
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(self.root, name)) as f:
                    out.append(json.load(f)["session_id"])
            except (OSError, ValueError, KeyError):
                continue
        return out

    # -- serialization -------------------------------------------------------
    @staticmethod
    def _encode(m: SessionManifest) -> bytes:
        blocks = []
        for i, h in enumerate(m.chain):
            blk = m.token_ids[i * m.block_size:(i + 1) * m.block_size]
            blocks.append({"h": f"{h:016x}",
                           "crc": zlib.crc32(_pack_tokens(blk)) & 0xFFFFFFFF})
        body = {"version": MANIFEST_VERSION,
                "session_id": m.session_id,
                "model": m.model,
                "block_size": m.block_size,
                "last_activity": m.last_activity,
                "n_tokens": len(m.token_ids),
                "tokens": m.token_ids,
                "blocks": blocks}
        body["crc"] = zlib.crc32(
            json.dumps(body, sort_keys=True).encode()) & 0xFFFFFFFF
        return json.dumps(body, sort_keys=True).encode()

    def _find(self, kind: str, sid: str, path: str, detail: str = ""):
        f = SessionFinding(kind, sid, path, detail)
        self.findings.append(f)
        # field name is ``finding`` (not ``kind``): the spool reserves
        # ``kind`` for its record-type tag and **fields would clobber it,
        # making the record invisible to the fleet aggregator
        self._spool("finding", session=sid, finding=kind, detail=detail)
        return f

    @staticmethod
    def _spool(op: str, **fields):
        from ..observability.fleet import spool_event
        spool_event("session", op=op, **fields)

    # -- the durable API -----------------------------------------------------
    def publish(self, m: SessionManifest) -> bool:
        """Atomically publish/overwrite ``m``. False (plus a typed
        finding and a counter) on a torn write or IO error — the on-disk
        state is then either absent or the PREVIOUS sound manifest."""
        if not m.last_activity:
            m.last_activity = time.time()
        fpath = self.path_for(m.session_id)
        tmp = fpath + ".tmp"
        from ..resilience.chaos import torn_write_bytes
        try:
            torn_write_bytes(tmp, self._encode(m),
                             point="kv.session_publish")
            os.replace(tmp, fpath)
        except Exception as e:  # noqa: BLE001 — chaos/IO surface as finding
            self._publish_fail_c.inc()
            self._find("publish_torn", m.session_id, tmp, repr(e))
            return False
        self._published_c.inc()
        self._spool("publish", session=m.session_id,
                    blocks=m.n_blocks, tokens=len(m.token_ids))
        return True

    def load(self, session_id: str,
             expect_model: Optional[str] = None) -> Optional[SessionManifest]:
        """Resolve a session id to a validated manifest, or ``None`` with
        a typed finding. Fires the ``kv.session_resume`` chaos seam; an
        injected fault degrades to ``None`` (callers full-prefill)."""
        fpath = self.path_for(session_id)
        from ..resilience.chaos import fault_point
        try:
            fault_point("kv.session_resume")
        except Exception as e:  # noqa: BLE001 — injected resume fault
            self._corrupt_c.inc()
            self._find("resume_fault", session_id, fpath, repr(e))
            return None
        if not os.path.exists(fpath):
            kind = ("torn_manifest" if os.path.exists(fpath + ".tmp")
                    else "missing")
            self._find(kind, session_id, fpath,
                       "only a .tmp exists (publish crashed mid-write)"
                       if kind == "torn_manifest" else "no manifest")
            if kind == "torn_manifest":
                self._corrupt_c.inc()
            return None
        try:
            raw = open(fpath, "rb").read()
            doc = json.loads(raw)
        except (OSError, ValueError) as e:
            self._corrupt_c.inc()
            self._find("unreadable", session_id, fpath, repr(e))
            return None
        body = {k: v for k, v in doc.items() if k != "crc"}
        want = zlib.crc32(
            json.dumps(body, sort_keys=True).encode()) & 0xFFFFFFFF
        if doc.get("crc") != want:
            self._corrupt_c.inc()
            self._find("checksum_mismatch", session_id, fpath,
                       f"document crc {doc.get('crc')} != {want}")
            return None
        tokens = doc.get("tokens", [])
        bs = int(doc.get("block_size", 0) or 0)
        if bs < 1 or len(tokens) != doc.get("n_tokens"):
            self._corrupt_c.inc()
            self._find("checksum_mismatch", session_id, fpath,
                       "token count / block size fields inconsistent")
            return None
        chain = chain_hashes(tokens, bs)
        entries = doc.get("blocks", [])
        if len(entries) != len(chain):
            self._corrupt_c.inc()
            self._find("hash_drift", session_id, fpath,
                       f"{len(entries)} entries != {len(chain)} full blocks")
            return None
        for i, (h, entry) in enumerate(zip(chain, entries)):
            blk = tokens[i * bs:(i + 1) * bs]
            crc = zlib.crc32(_pack_tokens(blk)) & 0xFFFFFFFF
            if entry.get("crc") != crc:
                self._corrupt_c.inc()
                self._find("entry_checksum_mismatch", session_id, fpath,
                           f"block {i} crc {entry.get('crc')} != {crc}")
                return None
            if entry.get("h") != f"{h:016x}":
                self._corrupt_c.inc()
                self._find("hash_drift", session_id, fpath,
                           f"block {i} hash {entry.get('h')} != {h:016x}")
                return None
        if expect_model and doc.get("model") and doc["model"] != expect_model:
            self._find("model_mismatch", session_id, fpath,
                       f"manifest model {doc['model']!r} != "
                       f"{expect_model!r}")
            return None
        m = SessionManifest(session_id=doc["session_id"], token_ids=tokens,
                            block_size=bs, chain=chain,
                            model=doc.get("model", ""),
                            last_activity=float(
                                doc.get("last_activity", 0.0)))
        self._resumed_c.inc()
        self._spool("load", session=session_id, blocks=m.n_blocks,
                    tokens=len(tokens))
        return m

    def delete(self, session_id: str) -> bool:
        fpath = self.path_for(session_id)
        removed = False
        for p in (fpath, fpath + ".tmp"):
            try:
                os.unlink(p)
                removed = True
            except OSError:
                pass
        if removed:
            self._spool("delete", session=session_id)
        return removed

    def drain_findings(self) -> List[SessionFinding]:
        out, self.findings = self.findings, []
        return out
