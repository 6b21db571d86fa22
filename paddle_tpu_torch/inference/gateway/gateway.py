"""The serving control plane: one gateway over N batcher replicas
(counterpart of ``paddle_tpu/inference/gateway/gateway.py``).

The layer the single-process batchers stop at: a ``Gateway`` owns a
``ReplicaPool`` of ``ContinuousBatcher``/``PagedContinuousBatcher``
replicas, an SLO-aware admission front door (tenant token-bucket quotas,
two-level priority queue with an anti-starvation share, deadline
feasibility), a pluggable ``Router`` (least-loaded / session+bucket
affinity / weighted round-robin), and ``StreamingSession`` delivery.

Control flow is single-threaded and deterministic — ``step()`` advances
the whole plane one tick (expire, dispatch, step every live replica,
poll tokens, harvest) — so an N-replica deployment simulates exactly in
tests with no multiprocessing. The same loop shape drives a real
deployment where each replica's step dispatches one compiled decode on
its own chip set.

Failure policy: a replica whose step exhausts the pool's
``resilience.retry`` policy (or raises non-retryably) is declared dead;
its in-flight requests requeue at the head of the gateway queue
(``gateway.requeued``) and resume on survivors from
``prompt ⧺ delivered`` — token-exact under greedy decoding, the same
recompute contract the paged batcher's preemption path uses. Sampled
requests resume too, but their continuation re-draws (document, not a
bug: exactness needs a deterministic decoder).

Typed rejections reuse the batchers' exception family
(``resilience.recovery.Overloaded`` / ``DeadlineExceeded``): quota and
queue-capacity sheds raise ``Overloaded``; infeasible or expired
deadlines raise ``DeadlineExceeded``. One family, every serving layer.

Durable sessions: with a ``session_store`` (a ``SessionStore`` or its
directory, shared by every replica and gateway), ``pause_session`` pins a
finished session's KV chain on the replica that served it and publishes
its crash-safe manifest; ``resume_session`` rebuilds the context from the
manifest (or, when that is missing or rejected, from the gateway's own
record or the caller's tokens, counted in ``session.resume_fallbacks``)
and submits the next turn on whichever replica the router picks.
"""
from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ...observability import trace_context as _trace
from ...observability.fleet import spool_event
from ...observability.metrics import get_registry
from ...resilience.recovery import DeadlineExceeded, Overloaded
from ...perf.buckets import resolve_ladder
from ..session_store import SessionManifest, SessionStore, model_identity
from .quota import TenantQuotas
from .replica import Replica, ReplicaPool
from .router import (DispatchQueue, PRIORITY_HIGH, PRIORITY_LOW,
                     SessionAffinityPolicy, resolve_policy)
from .streaming import StreamingSession

__all__ = ["Gateway", "GatewayRequest"]

_PRIORITIES = {"high": PRIORITY_HIGH, "interactive": PRIORITY_HIGH,
               "low": PRIORITY_LOW, "batch": PRIORITY_LOW,
               PRIORITY_HIGH: PRIORITY_HIGH, PRIORITY_LOW: PRIORITY_LOW}


@dataclass
class GatewayRequest:
    """One request's gateway-side lifecycle record."""

    gid: int
    tenant: str
    prompt: np.ndarray              # [s] int64 — the ORIGINAL prompt
    max_new_tokens: int
    priority: int
    session_id: Optional[str] = None
    resumed: bool = False           # came back via resume_session
    bucket: Optional[int] = None    # perf.buckets rung (affinity key)
    submit_t: float = 0.0
    deadline_t: Optional[float] = None
    delivered: List[int] = field(default_factory=list)
    attempts: int = 0               # dispatch attempts (requeues)
    replica: Optional[str] = None   # current assignment
    rid: Optional[int] = None       # batcher-side request id
    _consumed: int = 0              # tokens read from the CURRENT rid
    finished: bool = False
    failure: Optional[Exception] = None
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    trace: Optional[object] = None  # observability.TraceContext
    spans: Dict[str, object] = field(default_factory=dict)

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.delivered)


class _GatewayStats:
    """Local counters for ``stats()`` + the process-wide ``gateway.*``
    registry series (the pattern ``_ServingStats`` set)."""

    def __init__(self):
        reg = get_registry()
        self.requests_c = reg.counter(
            "gateway.requests", "requests accepted at the gateway")
        self.dispatch_c = reg.counter(
            "gateway.dispatches", "request placements onto replicas")
        self.completions_c = reg.counter(
            "gateway.completions", "requests finished across the pool")
        self.requeued_c = reg.counter(
            "gateway.requeued",
            "in-flight requests requeued off a dead/removed replica")
        self.shed_c = reg.counter(
            "gateway.shed", "requests rejected: gateway queue at capacity")
        self.tenant_shed_c = reg.counter(
            "gateway.tenant_shed", "requests rejected by tenant quota",
            labelnames=("tenant",))
        self.infeasible_c = reg.counter(
            "gateway.infeasible",
            "requests rejected: deadline infeasible at admission")
        self.expired_c = reg.counter(
            "gateway.deadline_expired",
            "requests abandoned on an expired deadline")
        self.failures_c = reg.counter(
            "gateway.failures", "requests failed (non-deadline)")
        self.tokens_c = reg.counter(
            "gateway.tokens", "tokens delivered to callers")
        self.queue_depth_g = reg.gauge(
            "gateway.queue_depth", "requests waiting in the gateway queue")
        self.inflight_g = reg.gauge(
            "gateway.inflight", "requests placed on replicas right now")
        self.ttft_h = reg.histogram(
            "gateway.ttft_seconds", "gateway submit to first token")
        self.ttft_rung_h = reg.histogram(
            "gateway.ttft_seconds_by_rung",
            "gateway submit to first token, by resolved prompt rung",
            labelnames=("rung",))
        self.tpot_h = reg.histogram(
            "gateway.tpot_seconds", "per-token latency after the first")
        self.reset()

    def reset(self):
        self.requests = 0
        self.completions = 0
        self.requeued = 0
        self.shed = 0
        self.infeasible = 0
        self.expired = 0
        self.failures = 0
        self.tokens = 0
        self.t0 = _time.perf_counter()


class Gateway:
    """Multi-replica serving front door. See the module docstring.

    policy: routing policy spec (``"least_loaded"``, ``"affinity"``,
    ``"weighted_rr"``, or a ``RoutePolicy``). quotas: ``TenantQuotas``
    or a ``{tenant: TokenBucket}`` dict. max_queue_depth: gateway-queue
    shed threshold. low_share: every K-th dispatch serves the low lane
    (anti-starvation). max_request_attempts: dispatches per request
    before a requeue storm fails it. slo_tpot_s / slo_ttft_s: seed the
    deadline-feasibility estimate (later refined by a completion-time
    EWMA); with no estimate the check is skipped.
    """

    def __init__(self, policy="least_loaded", quotas=None,
                 max_queue_depth: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 low_share: int = 4, max_request_attempts: int = 3,
                 step_retry=None, slo_tpot_s: Optional[float] = None,
                 slo_ttft_s: Optional[float] = None,
                 prompt_buckets="pow2", session_store=None):
        self.pool = ReplicaPool(step_retry=step_retry)
        # durable sessions: the shared manifest store every replica can
        # resolve a returning session id from, and the gateway's own record
        # of each session's last full sequence and serving replica (the
        # local fast path and the pin target)
        if isinstance(session_store, str):
            session_store = SessionStore(session_store)
        self.session_store = session_store
        self._session_tokens: Dict[str, np.ndarray] = {}
        self._session_last_replica: Dict[str, str] = {}
        self.router = resolve_policy(policy)
        self.quotas = (quotas if isinstance(quotas, TenantQuotas)
                       else TenantQuotas(quotas))
        self._queue = DispatchQueue(low_share=low_share)
        # admit lock: serializes off-thread submitters (an RPC frontend)
        # against the control loop's dispatch/expire queue harvest.
        # Held only for queue/bookkeeping spans — never across a replica
        # step or a batcher submit (those block on device work; see
        # CC402). Lock order when nested elsewhere is always
        # Gateway._admit -> Batcher._intake, never the reverse.
        from ...utils.locks import TracedRLock
        self._admit = TracedRLock("Gateway._admit")
        self._max_queue_depth = max_queue_depth
        self._default_deadline_s = default_deadline_s
        self.max_request_attempts = max_request_attempts
        self._slo_tpot_s = slo_tpot_s
        self._slo_ttft_s = slo_ttft_s
        self._tpot_ewma: Optional[float] = None
        self._ladder = resolve_ladder(prompt_buckets)
        self._next_gid = 0
        # every live (queued or in-flight) request; terminal ones move to
        # _finished/_failed exactly once
        self._requests: Dict[int, GatewayRequest] = {}
        self._finished: Dict[int, GatewayRequest] = {}
        self._failed: Dict[int, Exception] = {}
        self._sessions: Dict[int, StreamingSession] = {}
        self._tele = _GatewayStats()

    # -- pool lifecycle -------------------------------------------------------
    def add_replica(self, name: str, batcher,
                    weight: float = 1.0) -> Replica:
        return self.pool.add(name, batcher, weight=weight)

    def drain_replica(self, name: str, requeue: bool = False):
        """Stop routing new work to ``name``. By default in-flight work
        finishes on the draining replica (it keeps stepping). With
        ``requeue`` the in-flight requests move back to the gateway
        queue NOW and resume on survivors — token-exact from
        ``prompt ⧺ delivered`` with the same lost/dup accounting guard
        as the death path — so the replica empties immediately
        (scale-down and remediation don't wait out a long decode).
        Post-drain spans carry ``drained=1`` baggage."""
        rep = self.pool.get(name)
        self.pool.drain(name)
        if requeue and rep.alive and rep.load > 0:
            if isinstance(self.router, SessionAffinityPolicy):
                self.router.forget_replica(name)
            self._requeue_from(rep, drained=True)
        # session pins stay across a drain: the replica stays warm, so a
        # later resume can still ride its tiered chain; the manifests in
        # the shared store are untouched
        pins = len(getattr(rep.batcher, "_session_pins", {}) or {})
        if pins:
            spool_event("session", op="drain_preserve", replica=name,
                        sessions=pins)

    def remove_replica(self, name: str, force: bool = False) -> Replica:
        """Remove ``name`` from the pool. ``force`` requeues its
        in-flight requests onto the survivors first (the administrative
        twin of the death path — same ``gateway.requeued`` accounting)."""
        rep = self.pool.get(name)
        if force and rep.load > 0:
            self._requeue_from(rep)
        return self.pool.remove(name, force=force)

    # -- admission ------------------------------------------------------------
    def _feasible(self, max_new: int, budget: float) -> bool:
        tpot = self._slo_tpot_s if self._slo_tpot_s is not None \
            else self._tpot_ewma
        if tpot is None:
            return True             # no estimate yet — admit
        ttft = self._slo_ttft_s if self._slo_ttft_s is not None else tpot
        return ttft + max(0, max_new - 1) * tpot <= budget

    def submit(self, prompt_ids, max_new_tokens: int,
               tenant: str = "default", priority=PRIORITY_HIGH,
               deadline_s: Optional[float] = None,
               session_id: Optional[str] = None) -> int:
        """Admit a request into the gateway queue; returns its gid.

        Raises ``Overloaded`` when the tenant's token bucket can't cover
        ``len(prompt) + max_new_tokens`` or the gateway queue is at
        capacity, ``DeadlineExceeded`` when the deadline cannot be met
        even by the current TPOT estimate, ``ValueError`` when no
        replica in the pool could ever hold the request.
        """
        prompt = np.asarray(prompt_ids, np.int64).reshape(-1)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        pr = _PRIORITIES.get(priority)
        if pr is None:
            raise ValueError(f"unknown priority {priority!r} "
                             f"(high/low or 0/1)")
        reps = self.pool.replicas()
        if reps and len(prompt) + max_new_tokens > max(
                r.batcher.s_max for r in reps):
            raise ValueError(
                f"prompt {len(prompt)} + {max_new_tokens} exceeds every "
                f"replica's slot capacity")
        cost = len(prompt) + max_new_tokens
        if not self.quotas.admit(tenant, cost):
            self._tele.tenant_shed_c.labels(tenant=tenant).inc()
            raise Overloaded(
                f"tenant {tenant!r} quota exhausted "
                f"(cost {cost} tokens)")
        with self._admit:
            if self._max_queue_depth is not None \
                    and len(self._queue) >= self._max_queue_depth:
                self._tele.shed += 1
                self._tele.shed_c.inc()
                raise Overloaded(
                    f"gateway queue at capacity "
                    f"({len(self._queue)}/{self._max_queue_depth})")
            budget = deadline_s if deadline_s is not None \
                else self._default_deadline_s
            if budget is not None and not self._feasible(max_new_tokens,
                                                         budget):
                self._tele.infeasible += 1
                self._tele.infeasible_c.inc()
                raise DeadlineExceeded(
                    f"deadline {budget:.3f}s infeasible for "
                    f"{max_new_tokens} tokens at the current latency "
                    f"estimate")
            now = _time.perf_counter()
            gid = self._next_gid
            self._next_gid += 1
            req = GatewayRequest(
                gid=gid, tenant=tenant, prompt=prompt,
                max_new_tokens=max_new_tokens, priority=pr,
                session_id=session_id,
                bucket=(self._ladder.bucket(len(prompt))
                        if self._ladder is not None else None),
                submit_t=now,
                deadline_t=None if budget is None else now + budget)
            if _trace.enabled():
                # one trace per request, minted HERE: every downstream
                # span (queue/admit/prefill/decode/stream) shares this
                # trace_id, including after a requeue off a dead replica
                req.trace = _trace.new_trace("gateway.request", gid=gid,
                                             tenant=tenant,
                                             rung=req.bucket)
                req.spans["queue"] = req.trace.begin(
                    "queue", priority=req.priority)
            self._requests[gid] = req
            self._queue.push(req)
        self._tele.requests += 1
        self._tele.requests_c.inc()
        self._tele.queue_depth_g.set(len(self._queue))
        return gid

    def stream(self, prompt_ids, max_new_tokens: int,
               max_buffered: int = 64, **kw) -> StreamingSession:
        """submit + open_stream in one call."""
        gid = self.submit(prompt_ids, max_new_tokens, **kw)
        return self.open_stream(gid, max_buffered=max_buffered)

    def open_stream(self, gid: int,
                    max_buffered: int = 64) -> StreamingSession:
        req = self._requests.get(gid)
        if req is None:
            raise KeyError(f"request {gid} is not live "
                           f"(finished, failed, or unknown)")
        if gid in self._sessions:
            return self._sessions[gid]
        sess = StreamingSession(self, req, max_buffered=max_buffered)
        self._sessions[gid] = sess
        return sess

    def _on_session_closed(self, sess: StreamingSession):
        self._sessions.pop(sess.gid, None)

    # -- the control loop -----------------------------------------------------
    def step(self) -> List[int]:
        """One control-plane tick: expire queued deadlines, dispatch,
        step every live replica (under the pool's retry/death policy),
        deliver new tokens, harvest finished requests. Returns the gids
        that finished during THIS call."""
        self._expire_queued()
        self._dispatch()
        for rep in list(self.pool.live()):
            if not rep.batcher._has_work():
                continue
            status, payload = self.pool.step_replica(rep)
            if status == "dead":
                if isinstance(self.router, SessionAffinityPolicy):
                    self.router.forget_replica(rep.name)
                self._requeue_from(rep)
        finished = self._poll()
        self._update_gauges()
        from ...observability.fleet import autospool_tick
        autospool_tick()   # rank-sharded metrics spool; no-op unarmed
        return finished

    def _expire_queued(self):
        now = _time.perf_counter()
        with self._admit:
            expired = [r for r in self._requests.values()
                       if r.replica is None and r.deadline_t is not None
                       and now > r.deadline_t]
            for req in expired:
                self._queue.remove(req)
        for req in expired:
            self._fail(req, DeadlineExceeded(
                f"request {req.gid} expired in the gateway queue"))

    def _throttled(self) -> bool:
        return any(s.throttled for s in self._sessions.values())

    def _dispatch(self):
        if self._throttled():
            # backpressure: a full session buffer pauses INTAKE (a
            # batched decode can't pause one slot); decode continues
            _stream_backpressure()
            return
        while True:
            # queue inspection + pop under the admit lock; the actual
            # assignment (which enters the replica batcher's submit and
            # may do real work) runs with it released
            with self._admit:
                if not len(self._queue):
                    break
                req = self._queue.peek()
                need = (len(req.prompt) + len(req.delivered)
                        + req.remaining)
                cands = [r for r in self.pool.routable()
                         if r.free_slots > 0 and need <= r.batcher.s_max]
                if not cands:
                    break
                rep = self.router.select(req, cands)
                self._queue.pop()
            try:
                self._assign(req, rep)
            except Overloaded:
                # replica-side queue rejected it after our capacity
                # check (a tiny batcher max_queue_depth): keep it ours
                with self._admit:
                    self._queue.push_front(req)
                break

    def _assign(self, req: GatewayRequest, rep: Replica):
        now = _time.perf_counter()
        budget = None if req.deadline_t is None else req.deadline_t - now
        if budget is not None and budget <= 0:
            with self._admit:
                self._queue.remove(req)
            self._fail(req, DeadlineExceeded(
                f"request {req.gid} expired before dispatch"))
            return
        ids = (np.concatenate([req.prompt,
                               np.asarray(req.delivered, np.int64)])
               if req.delivered else req.prompt)
        qs = req.spans.pop("queue", None)
        if qs is not None:
            qs.end(replica=rep.name, attempt=req.attempts + 1)
        if req.trace is not None:
            # baggage merges into every span begun from here on: batcher
            # spans name the replica serving them — after a requeue the
            # NEXT assignment overwrites it, so post-failover spans carry
            # the survivor
            req.trace.baggage["replica"] = rep.name
        req.rid = rep.batcher.submit(ids, req.remaining,
                                     deadline_s=budget,
                                     trace=req.trace)
        req.replica = rep.name
        req._consumed = 0
        req.attempts += 1
        self.router.on_dispatch(req, rep)
        self._tele.dispatch_c.inc()

    def _requeue_from(self, rep: Replica, drained: bool = False):
        """Move every request assigned to ``rep`` back into the gateway
        queue (head of its lane). Called on replica death, forced
        removal, and requeue-drain (``drained``: the replica is ALIVE —
        deliver its pending decoded tokens first, then withdraw the
        batcher-side request so both engines never decode the same
        request). Requests that already exhausted their attempt budget
        fail typed instead of cycling forever."""
        for req in [r for r in self._requests.values()
                    if r.replica == rep.name]:
            # a request that FINISHED before the death is a completion,
            # not a casualty — harvest it (its final poll may not have
            # run yet). On a live drain, poll unconditionally: tokens a
            # healthy engine already decoded are valid — delivering them
            # now shrinks the survivor's recompute to exactly
            # prompt ⧺ delivered
            breq = rep.batcher.request(req.rid)
            if breq is not None and (breq.finished or drained):
                self._poll_one(req, rep)
                if req.gid not in self._requests:
                    continue
            if drained:
                rep.batcher.abort(req.rid)
            # close the old replica's open batcher spans, then mark the
            # trace so every span begun AFTER this point carries
            # requeued=1 (baggage merges at begin time)
            if breq is not None and breq.spans:
                _trace.end_open_spans(breq.spans, interrupted=1)
            if req.trace is not None:
                req.trace.baggage["requeued"] = 1
                if drained:
                    req.trace.baggage["drained"] = 1
                req.trace.event("requeue", replica=rep.name,
                                drained=int(drained),
                                delivered=len(req.delivered))
            req.replica = None
            req.rid = None
            req._consumed = 0
            if req.attempts >= self.max_request_attempts:
                self._fail(req, Overloaded(
                    f"request {req.gid} exhausted "
                    f"{self.max_request_attempts} dispatch attempts "
                    f"(replicas kept dying under it)"))
                continue
            with self._admit:
                self._queue.push_front(req)
            if req.trace is not None:
                req.spans["queue"] = req.trace.begin("queue",
                                                     priority=req.priority)
            self._tele.requeued += 1
            self._tele.requeued_c.inc()

    # -- token delivery / harvest ---------------------------------------------
    def _poll(self) -> List[int]:
        finished = []
        for req in [r for r in self._requests.values()
                    if r.replica is not None]:
            rep = self.pool.get(req.replica)
            if self._poll_one(req, rep):
                finished.append(req.gid)
        return finished

    def _poll_one(self, req: GatewayRequest, rep: Replica) -> bool:
        """Deliver new tokens for one assignment; harvest if terminal.
        Returns True when the request FINISHED during this poll."""
        breq = rep.batcher.request(req.rid)
        if breq is not None and len(breq.tokens) > req._consumed:
            self._deliver(req, [int(t)
                                for t in breq.tokens[req._consumed:]])
            req._consumed = len(breq.tokens)
        if rep.batcher.failure(req.rid) is not None:
            try:
                rep.batcher.pop_result(req.rid)
            except Exception as exc:  # noqa: BLE001 — typed, re-homed
                self._fail(req, exc)
            return False
        if breq is not None and breq.finished:
            out = rep.batcher.pop_result(req.rid)
            full = np.concatenate(
                [req.prompt, np.asarray(req.delivered, np.int64)])
            if not np.array_equal(out, full):
                # a mismatch here IS a lost/duplicated token — fail loud
                raise RuntimeError(
                    f"gateway token accounting diverged for request "
                    f"{req.gid}: replica returned {len(out)} tokens, "
                    f"gateway delivered {len(full)}")
            self._finish(req)
            return True
        return False

    def _deliver(self, req: GatewayRequest, toks: List[int]):
        now = _time.perf_counter()
        if req.first_token_t is None and toks:
            req.first_token_t = now
            ttft = now - req.submit_t
            self._tele.ttft_h.observe(ttft)
            if req.bucket is not None:
                # rung-labeled twin (the unlabeled series stays — slo.py
                # and the benches consume it by exact name)
                self._tele.ttft_rung_h.labels(
                    rung=str(req.bucket)).observe(ttft)
        req.delivered.extend(toks)
        self._tele.tokens += len(toks)
        self._tele.tokens_c.inc(len(toks))
        sess = self._sessions.get(req.gid)
        if sess is not None:
            sess.push(toks)

    def _finish(self, req: GatewayRequest):
        req.finished = True
        req.finish_t = _time.perf_counter()
        if req.session_id is not None:
            # the session's context after this turn: what pause_session
            # publishes and a local resume reuses
            self._session_tokens[req.session_id] = np.concatenate(
                [req.prompt, np.asarray(req.delivered, np.int64)])
            if req.replica is not None:
                self._session_last_replica[req.session_id] = req.replica
        if req.spans:
            _trace.end_open_spans(req.spans)
        if req.trace is not None:
            req.trace.finish(tokens=len(req.delivered),
                             attempts=req.attempts)
        del self._requests[req.gid]
        self._finished[req.gid] = req
        self._tele.completions += 1
        self._tele.completions_c.inc()
        n = len(req.delivered)
        if n > 1 and req.first_token_t is not None:
            tpot = (req.finish_t - req.first_token_t) / (n - 1)
            self._tele.tpot_h.observe(tpot)
            self._tpot_ewma = (tpot if self._tpot_ewma is None
                               else 0.8 * self._tpot_ewma + 0.2 * tpot)

    def _fail(self, req: GatewayRequest, exc: Exception):
        req.failure = exc
        if req.spans:
            _trace.end_open_spans(req.spans, error=type(exc).__name__)
        if req.trace is not None:
            req.trace.finish(error=type(exc).__name__)
        self._requests.pop(req.gid, None)
        self._failed[req.gid] = exc
        if isinstance(exc, DeadlineExceeded):
            self._tele.expired += 1
            self._tele.expired_c.inc()
        else:
            self._tele.failures += 1
            self._tele.failures_c.inc()

    def _update_gauges(self):
        self._tele.queue_depth_g.set(len(self._queue))
        self._tele.inflight_g.set(
            sum(1 for r in self._requests.values()
                if r.replica is not None))
        buffered = sum(s.buffered for s in self._sessions.values())
        _stream_buffered_gauge().set(buffered)

    # -- durable sessions -----------------------------------------------------
    def _session_paged_target(self, session_id: str):
        """The replica whose cache should hold the session's chain: the one
        that served its last turn if it is still in the pool and alive,
        else None (a resume routes by prefix depth or falls back)."""
        name = self._session_last_replica.get(session_id)
        if name is None and isinstance(self.router, SessionAffinityPolicy):
            name = self.router._sessions.get(session_id)
        if name is None:
            return None
        try:
            rep = self.pool.get(name)
        except KeyError:
            return None
        return rep if rep.alive else None

    def pause_session(self, session_id: str) -> bool:
        """Pause a conversation the gateway served: session-pin its KV chain
        on the replica that holds it (churn may demote the chain but cannot
        drop it past the last tier) and publish the crash-safe manifest to
        the shared store, so the session survives that replica's death and
        a rescale. True iff the manifest published atomically. Raises
        ``KeyError`` for a session id with no finished turn."""
        toks = self._session_tokens.get(session_id)
        if toks is None:
            raise KeyError(f"session {session_id!r}: no finished turn "
                           f"to pause")
        rep = self._session_paged_target(session_id)
        pinned = 0
        for r in self.pool.replicas():
            b = r.batcher
            if not hasattr(b, "pin_session"):
                continue
            if rep is not None and r.name == rep.name:
                pinned = b.pin_session(session_id, toks)
            elif session_id in getattr(b, "_session_pins", {}):
                # a stale pin from an earlier turn on another replica
                b.unpin_session(session_id)
        published = False
        if self.session_store is not None:
            src = rep if rep is not None else next(
                (r for r in self.pool.replicas()
                 if hasattr(r.batcher, "block_size")), None)
            bs = src.batcher.block_size if src is not None else 16
            ident = (model_identity(src.batcher.model)
                     if src is not None else "")
            published = self.session_store.publish(SessionManifest(
                session_id=session_id,
                token_ids=[int(t) for t in toks],
                block_size=bs, model=ident))
        spool_event("session", op="pause", session=session_id,
                    replica=rep.name if rep is not None else "",
                    blocks=pinned, published=int(published))
        return published

    def resume_session(self, session_id: str, new_tokens=None,
                       max_new_tokens: int = 32, tenant: str = "default",
                       priority=PRIORITY_HIGH,
                       deadline_s: Optional[float] = None,
                       fallback_tokens=None) -> int:
        """Resume a paused session on whichever replica the router picks:
        the context comes from the shared manifest (replica-independent:
        this works on a gateway that never saw the session), or, when the
        manifest is missing, torn or corrupt, from the gateway's own record
        or the caller's ``fallback_tokens`` (a typed finding lands in the
        store and the resume prefills in full, token-exact either way). The
        turn's ``new_tokens`` are appended to the context; returns the
        gid."""
        base = None
        source = "manifest"
        if self.session_store is not None:
            m = self.session_store.load(session_id)
            if m is not None:
                base = np.asarray(m.token_ids, np.int64)
        if base is None:
            base = self._session_tokens.get(session_id)
            source = "local"
            if base is None and fallback_tokens is not None:
                base = np.asarray(fallback_tokens, np.int64).reshape(-1)
                source = "caller"
            if base is None:
                raise KeyError(
                    f"session {session_id!r}: no manifest, no local "
                    f"record, no fallback_tokens — cannot reconstruct "
                    f"context")
            self._session_fallback_c().inc()
        if new_tokens is not None and len(np.atleast_1d(new_tokens)):
            prompt = np.concatenate(
                [base, np.asarray(new_tokens, np.int64).reshape(-1)])
        else:
            prompt = base
        gid = self.submit(prompt, max_new_tokens, tenant=tenant,
                          priority=priority, deadline_s=deadline_s,
                          session_id=session_id)
        self._requests[gid].resumed = True
        spool_event("session", op="resume", session=session_id,
                    source=source, tokens=len(prompt), gid=gid)
        return gid

    def release_session(self, session_id: str,
                        delete_manifest: bool = False):
        """Forget a session fleet-wide: unpin its chain on every replica,
        drop the gateway's own record and sticky routing, and (opt-in)
        delete the manifest."""
        for r in self.pool.replicas():
            if hasattr(r.batcher, "unpin_session"):
                r.batcher.unpin_session(session_id)
        self._session_tokens.pop(session_id, None)
        self._session_last_replica.pop(session_id, None)
        if isinstance(self.router, SessionAffinityPolicy):
            self.router.forget_session(session_id)
        if delete_manifest and self.session_store is not None:
            self.session_store.delete(session_id)
        spool_event("session", op="release", session=session_id,
                    deleted=int(delete_manifest))

    def _session_fallback_c(self):
        if not hasattr(self, "_session_fb_c"):
            self._session_fb_c = get_registry().counter(
                "session.resume_fallbacks",
                "resumes served from local/caller context because the "
                "manifest was missing or rejected (full re-prefill)")
        return self._session_fb_c

    # -- results --------------------------------------------------------------
    def _has_work(self) -> bool:
        return bool(self._requests)

    def result(self, gid: int) -> np.ndarray:
        """Full sequence (prompt + generated); raises the request's typed
        failure if it was shed/expired instead of completed."""
        if gid in self._failed:
            raise self._failed[gid]
        req = self._finished[gid]
        return np.concatenate(
            [req.prompt, np.asarray(req.delivered, np.int64)])

    def pop_result(self, gid: int) -> np.ndarray:
        if gid in self._failed:
            raise self._failed.pop(gid)
        out = self.result(gid)
        del self._finished[gid]
        self._sessions.pop(gid, None)
        return out

    def run_until_done(self, max_steps: int = 10000) -> Dict[int, np.ndarray]:
        """Drive the plane until every live request completes; returns
        (and releases) THIS run's finished results. Raises when the step
        budget runs out with work stranded (e.g. the whole pool died) —
        a silent partial dict would read as lost requests."""
        done: List[int] = []
        for _ in range(max_steps):
            done += self.step()
            if not self._has_work():
                break
        else:
            raise RuntimeError(
                f"run_until_done: {len(self._queue)} queued / "
                f"{sum(1 for r in self._requests.values() if r.replica)} "
                f"in-flight requests remain after {max_steps} steps")
        return {gid: self.pop_result(gid) for gid in done}

    # -- monitoring -----------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        t = self._tele
        dt = max(_time.perf_counter() - t.t0, 1e-9)
        return {
            "requests": t.requests,
            "completions": t.completions,
            "requeued": t.requeued,
            "shed": t.shed,
            "infeasible": t.infeasible,
            "deadline_expired": t.expired,
            "failures": t.failures,
            "delivered_tokens": t.tokens,
            "tokens_per_sec": t.tokens / dt,
            "queue_depth": len(self._queue),
            "inflight": sum(1 for r in self._requests.values()
                            if r.replica is not None),
            "replicas": {r.name: {"alive": r.alive,
                                  "draining": r.draining,
                                  "load": r.load,
                                  "health": r.health.state}
                         for r in self.pool.replicas()},
            "elapsed_s": dt,
        }

    def reset_stats(self):
        self._tele.reset()


def _stream_backpressure():
    from .streaming import _stream_metrics
    _stream_metrics()[1].inc()


def _stream_buffered_gauge():
    from .streaming import _stream_metrics
    return _stream_metrics()[0]

