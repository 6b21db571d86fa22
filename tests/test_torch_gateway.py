"""The port's serving gateway against the JAX package's, on the CPU.

Both packages' ``inference.gateway`` run side by side on the same inputs,
and must agree:

- The host pieces, on one injected clock: ``TokenBucket`` and
  ``TenantQuotas`` (levels, admissions and the quota gauge), the order a
  ``DispatchQueue(low_share=3)`` gives, ``RetryPolicy``'s seeded delays and
  give-up, ``FlapGuard``'s freeze ladder, and the affinity policy's
  prefix-depth tier over each package's ``RadixPrefixCache``.
- Scenarios over a stub engine (``FakeBatcher``: the batcher surface the
  gateway reads, each package's own ``HealthStateMachine`` and chaos
  registry, and a token that is a hash of the request's whole context, so
  a requeued request resumes with the same tokens). The gateway modules'
  clock is replaced by one fake clock that both packages read, and each
  tick advances it, so every figure is deterministic. Tick for tick: which
  replica each gid is on, the delivered tokens, the finished gids,
  ``stats()``, every ``gateway.*``, ``replica.*``, ``autoscaler.*`` and
  ``retry_*`` series (counters and histogram buckets as deltas over the
  scenario, gauges as values, zeroed before it), and the typed rejections (class name and
  message).
- Scenarios on the JAX tests' tiny GPT-2 with the same weights in both
  packages (moved across by ``gpt2_state_from_paddle_tpu``): least-loaded
  over two dense replicas, a replica's death requeued token-exact (with
  its streaming consumer and the requeue's spans), and the prefix-depth
  affinity over two paged replicas with the radix cache. Tokens, routing,
  the series and the page audits must equal the JAX gateway's.
- The unported parts raise ``NotImplementedError`` naming their
  ``ROADMAP.md`` item: tensor-parallel shard groups, speculation, the lock
  witness and the self-healing loop. Sessions with a store are held to
  the JAX gateway in tests/test_torch_sessions.py.

The model scenarios use tests/test_torch_gpt2_serving.py's shapes (the
dense prefill of one 16-token row and decode at batch 2 and s_max 32; the
paged batcher's 2 slots of 8 blocks of 4 and 8-token chunks), so that the
JAX package compiles those ops once for both files, and each JAX scenario
is computed once (on first use).
"""
import contextlib
import os
import threading

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import gateway as j_gw
from paddle_tpu.inference import prefix_cache as j_prefix
from paddle_tpu.inference import serving as j_serving
from paddle_tpu.inference.gateway import gateway as j_gw_gateway
from paddle_tpu.inference.gateway import replica as j_gw_replica
from paddle_tpu.inference.gateway import router as j_gw_router
from paddle_tpu.models import GPT2Config as JaxGPT2Config
from paddle_tpu.models import GPT2ForCausalLM as JaxGPT2
from paddle_tpu.observability import flight as j_flight
from paddle_tpu.observability import metrics as j_metrics
from paddle_tpu.observability import trace_context as j_trace
from paddle_tpu.resilience import chaos as j_chaos
from paddle_tpu.resilience import recovery as j_recovery
from paddle_tpu.resilience import remediator as j_remediator
from paddle_tpu.resilience import retry as j_retry
from paddle_tpu_torch.inference import gateway as p_gw
from paddle_tpu_torch.inference import prefix_cache as p_prefix
from paddle_tpu_torch.inference import serving as p_serving
from paddle_tpu_torch.inference.gateway import gateway as p_gw_gateway
from paddle_tpu_torch.inference.gateway import replica as p_gw_replica
from paddle_tpu_torch.inference.gateway import router as p_gw_router
from paddle_tpu_torch.models import (GPT2Config, GPT2ForCausalLM,
                                     gpt2_state_from_paddle_tpu)
from paddle_tpu_torch.observability import flight as p_flight
from paddle_tpu_torch.observability import metrics as p_metrics
from paddle_tpu_torch.observability import trace_context as p_trace
from paddle_tpu_torch.resilience import chaos as p_chaos
from paddle_tpu_torch.resilience import recovery as p_recovery
from paddle_tpu_torch.resilience import remediator as p_remediator
from paddle_tpu_torch.resilience import retry as p_retry
from paddle_tpu_torch.utils import locks as p_locks
from test_torch_refcache import jax_refs, normalize, register  # noqa: F401

MARGIN = 1e-3
TINY = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=64, dropout=0.0,
            initializer_range=0.2)
DENSE = dict(max_batch=2, s_max=32, prompt_buckets="fixed:16")
PAGED = dict(max_batch=2, s_max=32, block_size=4, n_pages=15,
             prefill_chunk=8, policy="ondemand", prefix_cache=True)
SERIES = ("gateway.", "replica.", "autoscaler.", "retry_")
TICK = 0.5                   # fake seconds a gateway step takes


class _Side:
    """One package's modules, so a scenario runs the same code on either."""

    def __init__(self, jax, gw, clocked, chaos, recovery, retry, remediator,
                 metrics, prefix):
        self.jax = jax
        self.gw = gw
        self.clocked = clocked         # the gateway modules that read _time
        self.chaos = chaos
        self.recovery = recovery
        self.retry = retry
        self.remediator = remediator
        self.metrics = metrics
        self.prefix = prefix


JAX = _Side(True, j_gw, (j_gw_gateway, j_gw_router, j_gw_replica), j_chaos,
            j_recovery, j_retry, j_remediator, j_metrics, j_prefix)
PORT = _Side(False, p_gw, (p_gw_gateway, p_gw_router, p_gw_replica),
             p_chaos, p_recovery, p_retry, p_remediator, p_metrics, p_prefix)


class FakeClock:
    """Stands in for the ``time`` module of the gateway modules: one clock
    both packages read."""

    def __init__(self, t=100.0):
        self.t = t

    def perf_counter(self):
        return self.t

    def monotonic(self):
        return self.t

    def __call__(self):
        return self.t


@contextlib.contextmanager
def _clocked(side, clock):
    """Point the side's gateway modules at ``clock``, chaos disarmed."""
    saved = [(m, m._time) for m in side.clocked]
    for m in side.clocked:
        m._time = clock
    side.chaos.disarm()
    try:
        yield
    finally:
        side.chaos.disarm()
        for m, t in saved:
            m._time = t


def _error(fn):
    """(class name, message) of what ``fn()`` raises; the packages' classes
    differ, their names and texts must not."""
    with pytest.raises(Exception) as info:
        fn()
    return [type(info.value).__name__, str(info.value)]


# -- the registry, as deltas over a scenario --------------------------------

def _zero_gauges(side):
    """Gauges are levels, not counts: zero the gateway's before a scenario,
    so that one another test left set on one side only reads alike."""
    for inst in side.metrics.get_registry()._instruments():
        if inst.kind == "gauge" and inst.name.startswith(SERIES):
            inst.set(0)


def _series(side):
    out = {}
    for inst in side.metrics.get_registry()._instruments():
        s = inst._series()
        if not s["name"].startswith(SERIES):
            continue
        key = (s["name"], tuple(sorted((s["labels"] or {}).items())))
        if s["type"] == "histogram":
            out[key] = ("histogram", list(s["bucket_counts"]))
        else:
            out[key] = (s["type"], float(s["value"]))
    return out


def _delta(now, base):
    out = {}
    for key, (kind, v) in now.items():
        if kind == "gauge":
            if v:
                out[key] = v
            continue
        b = base.get(key, (kind, None))[1]
        if kind == "histogram":
            d = v if b is None else [x - y for x, y in zip(v, b)]
            if any(d):
                out[key] = d
        else:
            d = v - (b or 0.0)
            if d:
                out[key] = d
    return sorted(out.items())


class Run:
    """A scenario's record: what the gateway shows after every tick."""

    def __init__(self, side, clock):
        self.side, self.clock = side, clock
        _zero_gauges(side)
        self.base = _series(side)
        self.log = []

    def series(self):
        return _delta(_series(self.side), self.base)

    def note(self, *what):
        self.log.append(list(what))

    def tick(self, gw):
        self.clock.t += TICK
        finished = gw.step()
        st = dict(gw.stats())
        self.log.append([
            sorted(finished),
            {g: [r.replica, list(r.delivered)]
             for g, r in sorted(gw._requests.items())},
            st, self.series()])
        return finished

    def until_done(self, gw, cap=300):
        done = []
        for _ in range(cap):
            if not gw._has_work():
                return done
            done += self.tick(gw)
        raise AssertionError("the gateway did not finish its work")

    def error(self, fn):
        self.log.append(_error(fn))

    def results(self, gw, gids):
        out = []
        for g in gids:
            try:
                out.append(gw.pop_result(g).tolist())
            except Exception as e:       # noqa: BLE001 — typed, compared
                out.append([type(e).__name__, str(e)])
        self.log.append(out)


# -- the stub engine ----------------------------------------------------------

class FakeRequest:
    def __init__(self, rid, prompt, max_new_tokens, deadline_t):
        self.rid = rid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.deadline_t = deadline_t
        self.tokens = []
        self.finished = False
        self.spans = {}


class FakeBatcher:
    """A deterministic engine with the batcher surface the gateway reads
    (``submit``, ``step``, ``request``, ``failure``, ``abort``,
    ``pop_result``, ``_has_work``, ``active``, ``pending``, ``_admitting``,
    ``health``, ``max_batch``, ``s_max``, ``stats``). A step admits pending
    requests into free slots with one token each (the prefill's), then
    gives every active request one token, as the dense batcher does; it
    passes the ``serving.step`` chaos point and feeds its health machine
    first. A request past its deadline on ``clock`` fails with the side's
    ``DeadlineExceeded``."""

    def __init__(self, side, clock, max_batch=2, s_max=64):
        self.side, self.clock = side, clock
        self.max_batch, self.s_max = max_batch, s_max
        self.health = side.recovery.HealthStateMachine(
            capacity=2 * max_batch, engine="fake")
        self._admitting = None
        self._pending, self._active = [], {}
        self._done, self._failed = {}, {}
        self._next_rid = 0
        self.completed = 0

    @staticmethod
    def token(context):
        return (sum((i + 1) * t for i, t in enumerate(context)) * 31
                + len(context)) % 97

    def submit(self, prompt_ids, max_new_tokens, deadline_s=None,
               trace=None):
        req = FakeRequest(self._next_rid, [int(t) for t in prompt_ids],
                          max_new_tokens,
                          None if deadline_s is None
                          else self.clock.t + deadline_s)
        self._next_rid += 1
        self._pending.append(req)
        return req.rid

    def _emit(self, req, finished):
        req.tokens.append(self.token(req.prompt + req.tokens))
        if len(req.tokens) >= req.max_new_tokens:
            req.finished = True
            del self._active[req.rid]
            self._done[req.rid] = req
            self.completed += 1
            finished.append(req.rid)

    def step(self):
        try:
            self.side.chaos.fault_point("serving.step")
        except Exception:
            self.health.on_step_error()
            raise
        for req in list(self._active.values()):
            if req.deadline_t is not None and self.clock.t > req.deadline_t:
                del self._active[req.rid]
                self._failed[req.rid] = self.side.recovery.DeadlineExceeded(
                    f"request {req.rid} expired after {len(req.tokens)} "
                    "tokens")
        finished = []
        while self._pending and len(self._active) < self.max_batch:
            req = self._pending.pop(0)
            self._active[req.rid] = req
            self._emit(req, finished)
        for req in list(self._active.values()):
            self._emit(req, finished)
        self.health.on_step_ok(len(self._pending))
        return finished

    def request(self, rid):
        for req in self._pending:
            if req.rid == rid:
                return req
        return self._active.get(rid) or self._done.get(rid)

    def failure(self, rid):
        return self._failed.get(rid)

    def abort(self, rid):
        for req in self._pending:
            if req.rid == rid:
                self._pending.remove(req)
                return True
        return self._active.pop(rid, None) is not None

    def pop_result(self, rid):
        if rid in self._failed:
            raise self._failed.pop(rid)
        req = self._done.pop(rid)
        return np.asarray(req.prompt + req.tokens, np.int64)

    def _has_work(self):
        return bool(self._pending or self._active)

    @property
    def active(self):
        return len(self._active)

    @property
    def pending(self):
        return len(self._pending)

    def stats(self):
        return {"completed_requests": self.completed}


def _prompts(seed, lengths, vocab=128):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (s,)).astype(np.int64) for s in lengths]


# -- stub scenarios -----------------------------------------------------------

def _pool(side, clock, names=("r0", "r1"), **gw_kw):
    kw = {k: gw_kw.pop(k) for k in ("max_batch", "s_max") if k in gw_kw}
    gw = side.gw.Gateway(**gw_kw)
    for name in names:
        gw.add_replica(name, FakeBatcher(side, clock, **kw))
    return gw


def least_loaded(run, side, clock):
    gw = _pool(side, clock)
    gids = [gw.submit(p, 8) for p in _prompts(0, (5, 9, 7, 12))]
    run.until_done(gw)
    run.results(gw, gids)
    run.note({r.name: r.batcher.completed for r in gw.pool.replicas()})


def affinity(run, side, clock):
    """Session stickiness a turn at a time, then bucket warmth without a
    session (test_gateway.py::test_gateway_session_affinity_sticks_and_
    stays_exact)."""
    gw = _pool(side, clock, policy="affinity")
    gids = []
    for i, p in enumerate(_prompts(1, (6, 20, 6, 20))):
        gids.append(gw.submit(p, 6, session_id=f"s{i % 2}"))
        run.tick(gw)
        run.note(dict(gw.router._sessions))
    run.until_done(gw)
    run.results(gw, gids)
    gw2 = _pool(side, clock, policy="affinity", max_batch=4)
    g = [gw2.submit(_prompts(2, (6,))[0], 6)]
    run.tick(gw2)
    g.append(gw2.submit(_prompts(3, (7,))[0], 6))      # the same rung
    run.tick(gw2)
    run.note({r.name: [r.load, sorted(r.warm_buckets)]
              for r in gw2.pool.replicas()})
    gw2.release_session("s0")
    run.until_done(gw2)
    run.results(gw2, g)


def weighted_rr(run, side, clock):
    gw = side.gw.Gateway(policy="weighted_rr")
    gw.add_replica("heavy", FakeBatcher(side, clock, max_batch=8),
                   weight=2.0)
    gw.add_replica("light", FakeBatcher(side, clock, max_batch=8),
                   weight=1.0)
    gids = [gw.submit(p, 4) for p in _prompts(2, (4,) * 6)]
    run.until_done(gw)
    run.results(gw, gids)


def quota_and_starvation(run, side, clock):
    quotas = side.gw.TenantQuotas(
        {"free": side.gw.TokenBucket(rate=0.5, burst=20.0, clock=clock)})
    gw = _pool(side, clock, quotas=quotas)
    gids = [gw.submit(np.arange(4), 8, tenant="free")]        # cost 12
    run.error(lambda: gw.submit(np.arange(4), 8, tenant="free"))
    gids.append(gw.submit(np.arange(4), 8, tenant="paid"))
    clock.t += 20.0                                           # +10 tokens
    run.note(quotas.bucket("free").level)
    gids.append(gw.submit(np.arange(5), 4, tenant="free"))    # cost 9
    run.until_done(gw)
    run.results(gw, gids)
    # saturating high-priority load on one slot: the low lane's share
    gw = _pool(side, clock, names=("r0",), max_batch=1, low_share=2)
    high = [gw.submit(p, 4, tenant="interactive")
            for p in _prompts(3, (4, 4, 4, 4))]
    low = gw.submit(_prompts(4, (4,))[0], 4, tenant="batch",
                    priority="low")
    run.error(lambda: gw.submit(np.arange(4), 4, priority="urgent"))
    order = run.until_done(gw)
    run.note(order, order.index(low))
    run.results(gw, high + [low])


def slo_and_shedding(run, side, clock):
    gw = _pool(side, clock, slo_tpot_s=10.0)
    run.error(lambda: gw.submit(np.arange(4), 10, deadline_s=0.5))
    run.error(lambda: gw.submit(np.arange(40), 30))           # > s_max 64
    run.error(lambda: gw.submit(np.arange(4), 0))
    # no replicas: the work waits in the queue and expires there
    gw2 = side.gw.Gateway()
    g = gw2.submit(np.arange(4), 4, deadline_s=1.0)
    run.tick(gw2)
    clock.t += 2.0
    run.tick(gw2)
    run.error(lambda: gw2.result(g))
    gw3 = side.gw.Gateway(max_queue_depth=1)
    gw3.submit(np.arange(4), 4)
    run.error(lambda: gw3.submit(np.arange(4), 4))
    run.note(gw2.stats()["deadline_expired"], gw3.stats()["shed"])
    # the completion-time estimate (no SLO seed): one request finishes,
    # then a deadline it cannot meet is refused, and a replica-side
    # expiry is re-homed as the request's typed failure
    gw4 = _pool(side, clock, names=("r0",))
    g4 = [gw4.submit(np.arange(6), 5)]
    run.until_done(gw4)
    run.note(gw4._tpot_ewma)
    run.error(lambda: gw4.submit(np.arange(6), 8, deadline_s=1.0))
    g4.append(gw4.submit(np.arange(6), 20, deadline_s=30.0))
    run.until_done(gw4)
    run.results(gw4, g4)


def drain_and_remove(run, side, clock):
    gw = _pool(side, clock)
    prompts = _prompts(5, (5, 7, 9, 6))
    g = [gw.submit(prompts[0], 5)]
    run.tick(gw)
    gw.drain_replica("r0")                 # in-flight work finishes there
    g += [gw.submit(p, 5) for p in prompts[1:3]]
    run.until_done(gw)
    run.results(gw, g)
    run.note({r.name: [r.batcher.completed, r.health.state, r.routable()]
              for r in gw.pool.replicas()})
    gw.remove_replica("r0")
    run.note(sorted(r.name for r in gw.pool.replicas()))
    # requeue-drain and forced removal move in-flight work to survivors
    gw = _pool(side, clock, names=("a", "b", "c"))
    g = [gw.submit(p, 8) for p in prompts + _prompts(6, (8, 4))]
    run.tick(gw)
    run.tick(gw)
    run.error(lambda: gw.remove_replica("b"))
    gw.drain_replica("a", requeue=True)
    run.note(gw.stats()["requeued"], gw.pool.get("a").load)
    gw.remove_replica("b", force=True)
    run.until_done(gw)
    run.results(gw, g)
    run.note(sorted(r.name for r in gw.pool.replicas()))


def replica_death(run, side, clock):
    """Chaos raises at r1's third step, with work in flight (the per-
    replica seam bypasses the retry policy); then a flaky step that the
    retry policy rides out, and one that exhausts it."""
    gw = _pool(side, clock)
    gids = [gw.submit(p, 10) for p in _prompts(6, (5, 9, 7, 11))]
    sess = gw.open_stream(gids[1])
    side.chaos.arm_scenario("seed=0; gateway.step.r1:transient_error:"
                            "after=2,count=1")
    streamed = list(sess)
    run.note(streamed, [r.alive for r in gw.pool.replicas()])
    run.until_done(gw)
    run.results(gw, gids)
    side.chaos.arm_scenario("seed=0; serving.step:transient_error:"
                            "after=3,count=2")
    gw = _pool(side, clock)
    gids = [gw.submit(p, 6) for p in _prompts(7, (5, 6, 7))]
    run.until_done(gw)
    run.results(gw, gids)
    side.chaos.arm_scenario("seed=0; serving.step:transient_error:"
                            "after=3,count=3")
    gw = _pool(side, clock, max_request_attempts=1)
    gids = [gw.submit(p, 6) for p in _prompts(8, (5, 6, 7))]
    run.until_done(gw)
    run.results(gw, gids)
    run.note({r.name: [r.alive, r.health.state] for r in gw.pool.replicas()})
    side.chaos.disarm()
    # the whole pool dead: run_until_done raises on the stranded work
    gw = _pool(side, clock, names=("r0",))
    gw.submit(np.arange(5), 4)
    side.chaos.arm_scenario("seed=0; gateway.step.r0:transient_error")
    run.error(lambda: gw.run_until_done(max_steps=5))


def streaming(run, side, clock):
    """A full session buffer pauses intake; reading it resumes intake
    (test_gateway.py::test_gateway_streaming_delivery_and_backpressure)."""
    gw = _pool(side, clock, names=("r0",), max_batch=4)
    sess = gw.stream(_prompts(7, (6,))[0], 8, max_buffered=2)
    while not sess.throttled:
        run.tick(gw)
    late = gw.submit(_prompts(8, (4,))[0], 4)
    run.tick(gw)
    run.note(gw.stats()["queue_depth"], sess.buffered)
    got = sess.read_available()
    run.tick(gw)
    run.note(gw.stats()["queue_depth"])
    got += list(sess)
    run.note(got, sess.done)
    run.until_done(gw)
    run.results(gw, [late, sess.gid])
    run.error(lambda: gw.open_stream(sess.gid))
    # a closed session stops counting toward the throttle
    sess = gw.stream(np.arange(5), 6, max_buffered=1)
    run.tick(gw)
    sess.close()
    run.until_done(gw)
    run.note(sess.read_available(), sess.closed)
    run.results(gw, [sess.gid])


def autoscale(run, side, clock):
    """test_selfheal.py::test_autoscaler_scales_up_under_queue_pressure_
    and_drains_back over stub engines, then a TTFT-driven scale-up and a
    flap guard that freezes."""
    gw = _pool(side, clock)
    asc = side.gw.Autoscaler(gw, lambda name: FakeBatcher(side, clock),
                             min_replicas=2, max_replicas=3, queue_high=4,
                             queue_low=0, hysteresis=2, cooldown_s=1.0,
                             clock=clock)
    rng = np.random.RandomState(3)
    gids = [gw.submit(rng.randint(0, 128, (8,)), 4) for _ in range(12)]
    run.note(asc.tick())
    clock.t += 2.0
    run.note(asc.tick(), sorted(r.name for r in gw.pool.replicas()))
    run.until_done(gw)
    run.results(gw, gids)
    for _ in range(2):
        clock.t += 2.0
        run.note(asc.tick())
    run.until_done(gw)
    clock.t += 2.0
    run.note(asc.tick(), sorted(r.name for r in gw.pool.replicas()))
    run.note(asc.events)
    # TTFT pressure: every completion over the SLO; the guard allows one
    # action a window, so the second scale-up is refused and freezes it
    guard = side.remediator.FlapGuard(max_actions=1, window_s=100.0,
                                      freeze_s=50.0, clock=clock)
    gw = _pool(side, clock, names=("r0",), max_batch=1)
    asc = side.gw.Autoscaler(gw, lambda name: FakeBatcher(side, clock,
                                                          max_batch=1),
                             min_replicas=1, max_replicas=4, queue_high=99,
                             ttft_slo_s=0.1, min_breach_samples=2,
                             hysteresis=1, cooldown_s=0.0, flap_guard=guard,
                             clock=clock)
    for round_ in range(3):
        gids = [gw.submit(np.arange(3 + i), 3) for i in range(3)]
        run.until_done(gw)
        run.results(gw, gids)
        clock.t += 1.0
        run.note(asc.tick(), guard.frozen_until, guard.escalations)
    run.note(asc.scale_down(reason="command"), asc.events)


STUB_SCENARIOS = [least_loaded, affinity, weighted_rr, quota_and_starvation,
                  slo_and_shedding, drain_and_remove, replica_death,
                  streaming, autoscale]


def _run(scenario, side, *args):
    """The scenario's record on one side, on a fresh fake clock."""
    clock = FakeClock()
    with _clocked(side, clock):
        run = Run(side, clock)
        scenario(run, side, clock, *args)
    return run.log


@pytest.mark.parametrize("scenario", STUB_SCENARIOS,
                         ids=lambda f: f.__name__)
def test_stub_scenario_matches_the_jax_gateway(scenario):
    got = _run(scenario, PORT)
    ref = _run(scenario, JAX)
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a == b, f"{scenario.__name__}: record {i} differs"


# -- the host pieces ----------------------------------------------------------

def _buckets(side, clock):
    out = []
    b = side.gw.TokenBucket(rate=10.0, burst=20.0, clock=clock)
    for dt, take in ((0, 20), (0, 1), (0.5, None), (0, 5), (0, 0.1),
                     (99.5, None), (0.25, 2.5)):
        clock.t += dt
        out.append(b.level if take is None else b.try_take(take))
    q = side.gw.TenantQuotas(
        {"metered": side.gw.TokenBucket(1.0, 4.0, clock=clock)})
    q.set_quota("capped", side.gw.TokenBucket(0.0, 3.0, clock=clock))
    out += [q.admit("unmetered", 10_000), q.admit("metered", 4),
            q.admit("metered", 1), q.admit("capped", 2),
            q.admit("capped", 2), q.bucket("nobody")]
    gauge = side.metrics.get_registry().get("gateway.quota.level")
    out.append({t: gauge.labels(tenant=t).value
                for t in ("metered", "capped")})
    out.append(_error(lambda: side.gw.TokenBucket(-1.0, 1.0)))
    out.append(_error(lambda: side.gw.TokenBucket(1.0, 0.0)))
    return out


def test_token_bucket_and_quotas_match():
    assert _buckets(PORT, FakeClock()) == _buckets(JAX, FakeClock())


def _queue(side):
    class R:
        def __init__(self, tag, priority):
            self.tag, self.priority = tag, priority
            self.submit_t = 0.0

    q = side.gw.DispatchQueue(low_share=3)
    for i in range(6):
        q.push(R(f"h{i}", side.gw.PRIORITY_HIGH))
    q.push(R("low", side.gw.PRIORITY_LOW))
    order = [q.pop().tag for _ in range(len(q))]
    for i in range(4):
        q.push(R(f"x{i}", i % 2))
    q.push_front(R("front", side.gw.PRIORITY_LOW))
    peek = q.peek().tag
    gone = R("gone", 0)
    removed = [q.remove(gone), q.remove(q._lanes[0][0])]
    strict = side.gw.DispatchQueue(low_share=0)
    strict.push(R("l", 1))
    strict.push(R("h", 0))
    return [order, peek, removed, [r.tag for r in q.drain()], len(q),
            [strict.pop().tag, strict.pop().tag, strict.pop()],
            _error(lambda: side.gw.DispatchQueue(low_share=-1))]


def test_dispatch_queue_order_matches():
    got = _queue(PORT)
    assert got == _queue(JAX)
    assert got[0] == ["h0", "h1", "low", "h2", "h3", "h4", "h5"]


def _retries(side):
    """Seeded jitter, the deadline and the give-up, with the sleeps
    recorded instead of slept."""
    TransientChaosError = side.chaos.TransientChaosError
    out = []
    reg = side.metrics.get_registry()
    points = ("t.ok", "t.giveup", "t.deadline", "t.wrap")

    def counts():
        return {p: [reg.counter(n, labelnames=("point",)).labels(
            point=p).value for n in ("retry_attempts_total",
                                     "retry_giveups_total")]
                for p in points}

    before = counts()

    def flaky(n, exc=TransientChaosError):
        calls = [0]

        def fn():
            calls[0] += 1
            if calls[0] <= n:
                raise exc(f"failure {calls[0]}")
            return calls[0]
        return fn

    for seed in (0, 7):
        slept = []
        pol = side.retry.RetryPolicy(max_attempts=5, base_delay=0.1,
                                     max_delay=0.5, multiplier=3.0,
                                     jitter=0.5, seed=seed,
                                     sleep_fn=slept.append)
        out.append([pol.call(flaky(4), point="t.ok"), slept,
                    [pol.backoff(i) for i in range(5)]])
        slept = []
        pol = side.retry.RetryPolicy(max_attempts=3, seed=seed,
                                     sleep_fn=slept.append)
        with pytest.raises(side.retry.RetryGiveUp) as info:
            pol.call(flaky(9, ConnectionError), point="t.giveup")
        out.append([str(info.value), type(info.value.last).__name__,
                    type(info.value.__cause__).__name__, slept])
    pol = side.retry.RetryPolicy(deadline=0.0, sleep_fn=out.append)
    out.append(_error(lambda: pol.call(flaky(1), point="t.deadline")))
    pol = side.retry.RetryPolicy(giveup=(TransientChaosError,),
                                 sleep_fn=out.append)
    out.append(_error(lambda: pol.call(flaky(1), point="t.never")))
    out.append(_error(lambda: pol.call(flaky(1, ValueError))))
    wrapped = side.retry.RetryPolicy(seed=1, sleep_fn=out.append).wrap(
        flaky(2), point="t.wrap")
    out.append(wrapped())
    out.append(_error(lambda: side.retry.RetryPolicy(max_attempts=0)))
    out.append(_error(lambda: side.retry.RetryPolicy(multiplier=0.5)))
    after = counts()
    # the counters are process-wide: what this run added
    out.append({p: [a - b for a, b in zip(after[p], before[p])]
                for p in points})
    return out


def test_retry_policy_delays_and_give_up_match():
    got = _retries(PORT)
    assert got == _retries(JAX)
    assert len(got[0][1]) == 4 and all(d > 0 for d in got[0][1])
    assert got[-1]["t.giveup"] == [6, 2]


def _flap(side):
    clock = FakeClock(0.0)
    g = side.remediator.FlapGuard(max_actions=2, window_s=10.0,
                                  freeze_s=5.0, max_freeze_s=15.0,
                                  clock=clock)
    out = []
    for t, act in ((0, True), (1, True), (2, True), (3, False), (7.5, True),
                   (8, True), (20, False), (22, True), (23, True),
                   (24, True), (40, True), (41, True), (60, True),
                   (75, True), (80, False), (95, True)):
        clock.t = float(t)
        ok, why = g.check()
        if ok and act:
            g.record()
        out.append([t, ok, why, g.frozen_until, g.escalations])
    out.append(_error(lambda: side.remediator.FlapGuard(max_actions=0)))
    return out


def test_flap_guard_freeze_matches():
    got = _flap(PORT)
    assert got == _flap(JAX)
    assert any(r[2] == "flap_frozen" for r in got[:-1])
    assert max(r[4] for r in got[:-1]) >= 2          # the ladder doubled


def _prefix_tier(side):
    """The affinity policy's prefix-depth tier over each package's radix
    cache (test_gateway.py::test_affinity_policy_prefers_deepest_cached_
    prefix)."""
    class FakeRep:
        def __init__(self, name, cache, load=0):
            self.name, self._cache, self.load = name, cache, load
            self.warm_buckets = set()

        def prefix_summary(self):
            return None if self._cache is None else self._cache.summary()

    class Req:
        def __init__(self, prompt, session_id="sticky", bucket=None):
            self.prompt, self.session_id = prompt, session_id
            self.bucket = bucket

    deep = side.prefix.RadixPrefixCache(4)
    deep.insert(np.arange(8), [0, 1], 0, 2)
    shallow = side.prefix.RadixPrefixCache(4)
    shallow.insert(np.arange(4), [0], 0, 1)
    twin = side.prefix.RadixPrefixCache(4)
    twin.insert(np.arange(8), [3, 4], 0, 2)
    reps = [FakeRep("a", shallow), FakeRep("b", deep, load=5),
            FakeRep("c", None), FakeRep("d", twin, load=1)]
    pol = side.gw.SessionAffinityPolicy()
    pol._sessions["sticky"] = "a"
    reg = side.metrics.get_registry()
    names = ("gateway.route.prefix_hit", "gateway.route.affinity_hit",
             "gateway.route.fallback")
    before = [reg.counter(n).value for n in names]
    picks = [pol.select(Req(np.arange(12)), reps).name,
             pol.select(Req(np.arange(100, 112)), reps).name,
             pol.select(Req(np.arange(100, 112), None), reps).name]
    reps[0].warm_buckets.add(16)
    picks.append(pol.select(Req(np.arange(100, 112), None, 16), reps).name)
    pol.forget_replica("a")
    picks.append(pol.select(Req(np.arange(100, 112)), reps).name)
    return [picks, deep.summary()["hashes"] == {
        h: i + 1 for i, h in enumerate(side.prefix.chain_hashes(
            np.arange(8), 4))},
        [reg.counter(n).value - b for n, b in zip(names, before)],
        [side.gw.resolve_policy(s).name
         for s in (None, "least_loaded", " Affinity ", "weighted_rr")],
        _error(lambda: side.gw.resolve_policy("random")),
        _error(lambda: side.gw.resolve_policy(3))]


def test_affinity_prefix_depth_tier_matches():
    got = _prefix_tier(PORT)
    assert got == _prefix_tier(JAX)
    assert got[0][0] == "d" and got[1]            # deepest, then least loaded


def test_the_port_s_flight_ring_reads_back_in_the_jax_package(
        tmp_path, monkeypatch):
    """The port writes the JAX package's ring format: its events (a chaos
    injection, written before the fault fires, and the spans of a traced
    request) read back with the JAX package's read_ring, and a reopened
    ring bumps its epoch and keeps one seq order. Disarmed, nothing is
    written."""
    p_flight.reset_flight()
    p_flight.flight_record("nothing", x=1)
    assert p_flight.get_flight() is None
    monkeypatch.setenv("PADDLE_TELEMETRY_DIR", str(tmp_path))
    p_flight.reset_flight()
    try:
        p_chaos.arm_scenario("seed=0; t.point:transient_error:count=1")
        with pytest.raises(p_chaos.TransientChaosError):
            p_chaos.fault_point("t.point")
        trace = p_trace.new_trace("t.request", gid=3)
        trace.event("requeue", replica="r1")
        trace.finish()
        p_flight.flight_record("big", blob="x" * 1000)
        path = p_flight.get_flight().path
        p_flight.reset_flight()
        rec = p_flight.FlightRecorder(path)
        rec.record("after_reopen", n=1)
        rec.close()
    finally:
        p_chaos.disarm()
        p_flight.reset_flight()
    events = j_flight.read_ring(path)
    assert [e["kind"] for e in events] == [
        "chaos", "span_open", "span_open", "span_close", "span_close",
        "big", "after_reopen"]
    assert events[0]["point"] == "t.point"
    assert events[5].get("truncated") is True
    assert [e["_seq"] for e in events] == list(range(7))
    assert events[-1]["_epoch"] == events[0]["_epoch"] + 1
    assert os.path.basename(path) == "flight-rank00000.ring"


def test_unported_parts_raise_by_name(monkeypatch):
    """The parts still to port raise naming their item; sessions (item 1.4,
    ported) give the JAX gateway's typed errors without a store
    (tests/test_torch_sessions.py holds them with one)."""
    gw = p_gw.Gateway()
    ref = j_gw.Gateway()
    for name, args in (("pause_session", ("s0",)),
                       ("resume_session", ("s0", [1]))):
        assert (_error(lambda: getattr(gw, name)(*args))
                == _error(lambda: getattr(ref, name)(*args)))
    gw.release_session("s0", delete_manifest=True)      # no store: no-op
    assert gw.session_store is None

    class Sharded(FakeBatcher):
        shard_group = object()

    with pytest.raises(NotImplementedError, match="queue 1, item 7"):
        gw.add_replica("tp0", Sharded(PORT, FakeClock()))
    assert len(gw.pool) == 0
    # speculative replicas (item 1.5) are ported: a draft that is not a
    # model fails on its config in both packages alike
    target = GPT2ForCausalLM(GPT2Config(**TINY), device="cpu")
    assert (_error(lambda: p_serving.PagedContinuousBatcher(
        target, compile=False, draft_model=object()))
        == _error(lambda: j_serving.PagedContinuousBatcher(
            target, compile=False, draft_model=object())))
    with pytest.raises(NotImplementedError, match="queue 1, item 9"):
        p_remediator.AutoRemediator(gw)
    monkeypatch.setenv("PADDLE_LOCK_WITNESS", "1")
    for factory in (p_locks.TracedLock, p_locks.TracedRLock):
        with pytest.raises(NotImplementedError, match="queue 1, item 9"):
            factory("x")
    monkeypatch.setenv("PADDLE_LOCK_WITNESS", "0")
    assert type(p_locks.TracedLock("x")) is type(threading.Lock())
    assert type(p_locks.TracedRLock("x")) is type(threading.RLock())


# -- the tiny GPT-2 in both packages -----------------------------------------

def _gpt2_state(jm):
    """The JAX model's float32 state with drawn biases and LayerNorms."""
    rng = np.random.RandomState(0)
    out = {}
    for k, v in jm.state_dict().items():
        a = np.asarray(v.numpy(), np.float32)
        if k.endswith(".bias"):
            a = (0.2 * rng.randn(*a.shape)).astype(np.float32)
        elif ".ln_" in k:
            a = (1.0 + 0.3 * rng.randn(*a.shape)).astype(np.float32)
        out[k] = a
    return out


def _build_models():
    """(jax_model, port_model): the tiny GPT-2 with the same weights."""
    paddle.seed(0)
    jm = JaxGPT2(JaxGPT2Config(**TINY))
    jm.eval()
    state = _gpt2_state(jm)
    jm.set_state_dict(state)
    pm = GPT2ForCausalLM(GPT2Config(**TINY), device="cpu").eval()
    pm.load_state_dict(gpt2_state_from_paddle_tpu(state))
    return jm, pm




@pytest.fixture(scope="module")
def models():
    return _build_models()


def _margin_guard(b):
    """Every greedy pick of a JAX batcher's live row (or of an admission's
    logits) must clear the top-1/top-2 margin, so a near-tie shows up as a
    fixture problem rather than as a port fault."""
    pick = b._pick

    def guarded(logits_np):
        rows = (list(b._slot_req) if logits_np.shape[0] == b.max_batch
                and b._slot_req else [0])
        top2 = np.sort(logits_np[rows], axis=-1)[:, -2:]
        assert np.all(top2[:, 1] - top2[:, 0] > MARGIN), "fixture near-tie"
        return pick(logits_np)

    b._pick = guarded
    return b


def _engines(models, side):
    model = models[0] if side.jax else models[1]
    serving = j_serving if side.jax else p_serving

    def make(cls, **kw):
        b = getattr(serving, cls)(model, compile=False, **kw)
        return _margin_guard(b) if side.jax else b
    return (lambda: make("ContinuousBatcher", **DENSE),
            lambda: make("PagedContinuousBatcher", **PAGED))


def _spans(side, gw, gid):
    """A finished request's spans: name, the replica it ran on and the
    recompute tags, in recording order."""
    rec = (j_trace if side.jax else p_trace).get_recorder()
    tr = gw._finished[gid].trace
    return [[s.name, s.tags.get("replica"), s.tags.get("requeue_recompute"),
             s.tags.get("requeued")] for s in rec.spans(tr.trace_id)
            if s.name != "gateway.request"]


def model_least_loaded(run, side, clock, models):
    dense, _ = _engines(models, side)
    gw = side.gw.Gateway(policy="least_loaded")
    gw.add_replica("r0", dense())
    gw.add_replica("r1", dense())
    gids = [gw.submit(p, 8) for p in _prompts(0, (5, 9, 7, 12))]
    run.until_done(gw)
    run.results(gw, gids)
    run.note({r.name: r.batcher.stats()["completed_requests"]
              for r in gw.pool.replicas()})


def model_replica_death(run, side, clock, models):
    """r1 dies at its third step with two requests in flight; they resume
    on r0 from prompt + delivered, token-exact, and the streaming consumer
    of one of them sees every token once (test_gateway.py::
    test_gateway_replica_death_requeues_token_exact)."""
    dense, _ = _engines(models, side)
    gw = side.gw.Gateway(policy="least_loaded")
    gw.add_replica("r0", dense())
    gw.add_replica("r1", dense())
    gids = [gw.submit(p, 8) for p in _prompts(6, (5, 4, 7, 6))]
    sess = gw.open_stream(gids[1])
    side.chaos.arm_scenario("seed=0; gateway.step.r1:transient_error:"
                            "after=2,count=1")
    run.note(list(sess))
    run.until_done(gw)
    run.note([r.alive for r in gw.pool.replicas()],
             {g: _spans(side, gw, g) for g in gids})
    run.results(gw, gids)


def model_prefix_affinity(run, side, clock, models):
    """Two paged replicas with the radix cache under the affinity policy:
    the replica holding a prompt's shared prefix takes it while it has a
    free slot, whatever its load; the next goes to the other replica."""
    _, paged = _engines(models, side)
    gw = side.gw.Gateway(policy="affinity")
    gw.add_replica("r0", paged())
    gw.add_replica("r1", paged())
    rng = np.random.RandomState(3)
    shared = rng.randint(0, 128, (16,))
    prompts = [np.concatenate([shared, rng.randint(0, 128, (5 + i,))])
               for i in range(4)]
    gids = [gw.submit(prompts[0], 8)]
    run.until_done(gw)
    gids += [gw.submit(p, 8) for p in prompts[1:]]
    run.tick(gw)
    run.until_done(gw)
    run.results(gw, gids)
    run.note({r.name: [r.batcher.audit_pages(),
                       r.batcher.prefix_cache.stats()["hit_tokens"],
                       r.batcher.free_page_count]
              for r in gw.pool.replicas()})


MODEL_SCENARIOS = [model_least_loaded, model_replica_death,
                   model_prefix_affinity]


class _Results(dict):
    """Each model scenario's record on the JAX side, computed on first
    use."""

    def __init__(self, models):
        super().__init__()
        self.models = models

    def __missing__(self, name):
        fn = next(f for f in MODEL_SCENARIOS if f.__name__ == name)
        with paddle.no_grad():
            self[name] = result = _run(fn, JAX, self.models)
        return result


REFS = register("gateway.model_scenarios", TINY,
                [f.__name__ for f in MODEL_SCENARIOS],
                lambda: _Results(_build_models()),
                lambda results, name: results[name])


@pytest.fixture(scope="module")
def jax_results(jax_refs):
    """Every model scenario computed once a run (test_torch_refcache.py)."""
    return jax_refs(REFS)


@pytest.mark.parametrize("scenario", MODEL_SCENARIOS,
                         ids=lambda f: f.__name__)
def test_model_scenario_matches_the_jax_gateway(models, jax_results,
                                                scenario):
    got = normalize(_run(scenario, PORT, models))
    ref = jax_results[scenario.__name__]
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a == b, f"{scenario.__name__}: record {i} differs"
