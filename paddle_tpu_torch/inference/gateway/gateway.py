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

Not ported yet (ROADMAP.md, queue 1, item 1.4: the host and disk tiers,
with sessions): durable sessions. ``Gateway(session_store=...)``,
``pause_session`` and ``resume_session`` raise ``NotImplementedError``
naming that item; ``release_session`` works (it forgets the session's
sticky routing, and unpins on batchers that pin).
"""
from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ...observability import trace_context as _trace
from ...resilience.recovery import DeadlineExceeded, Overloaded
from ...perf.buckets import resolve_ladder
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
        from ...observability.metrics import get_registry
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
        if session_store is not None:
            _no_sessions("Gateway(session_store=...)")
        self.pool = ReplicaPool(step_retry=step_retry)
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
    def pause_session(self, session_id: str) -> bool:
        """Not ported yet: pin a session's KV chain and publish its
        manifest (ROADMAP.md, queue 1, item 1.4)."""
        _no_sessions("Gateway.pause_session")

    def resume_session(self, session_id: str, *args, **kwargs) -> int:
        """Not ported yet: resume a paused session from its manifest
        (ROADMAP.md, queue 1, item 1.4)."""
        _no_sessions("Gateway.resume_session")

    def release_session(self, session_id: str,
                        delete_manifest: bool = False):
        """Forget a session fleet-wide: unpin its chain on every replica
        that pins, and drop its sticky routing. With no session store (the
        port has none yet) there is no manifest to delete, as in the JAX
        package's gateway without one."""
        for r in self.pool.replicas():
            if hasattr(r.batcher, "unpin_session"):
                r.batcher.unpin_session(session_id)
        if isinstance(self.router, SessionAffinityPolicy):
            self.router.forget_session(session_id)
        from ...observability.fleet import spool_event
        spool_event("session", op="release", session=session_id,
                    deleted=int(delete_manifest))

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


def _no_sessions(what: str):
    raise NotImplementedError(
        f"{what}: durable sessions are not ported yet (ROADMAP.md, queue "
        "1, item 1.4: the host and disk tiers, with sessions)")
