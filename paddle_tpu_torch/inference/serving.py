"""Continuous batching over the KV-cache decode step (counterpart of
``paddle_tpu/inference/serving.py:1-752``: ``Request``, ``_ServingStats``,
``_BatcherBase`` and the dense ``ContinuousBatcher``).

The batcher owns ``max_batch`` SLOTS, one fixed ``[L, 2, B, KV, S, D]``
cache on the model's device, and a host-side scheduler that admits
pending requests into free slots at step boundaries, evicts finished
ones, and steps every slot through one decode step of fixed shape.
Inactive slots decode garbage into a scratch row (``s_max - 1``) that
admission's prefill overwrites before any real read (causality: a slot's
attention never reads rows past its own t), so the decode step keeps one
shape, and with ``compile=True`` one CUDA graph serves every step.

Not ported yet: ``PagedContinuousBatcher`` (paged cache, prefix cache,
promotion, speculative decode, int8), the tensor-parallel shard group and
the gateway's requeue tags on the prefill span.
"""
from __future__ import annotations

import threading
import time as _time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import to_torch_dtype
from ..jit import to_static
from ..models.generation import select_token
from ..observability import roofline_attr
from ..observability.fleet import autospool_tick
from ..observability.metrics import get_registry
from ..observability.trace_context import end_open_spans
from ..perf.buckets import pad_amount, resolve_ladder
from ..resilience.chaos import fault_point
from ..resilience.recovery import (DeadlineExceeded, HealthStateMachine,
                                   Overloaded)

__all__ = ["ContinuousBatcher", "Request"]


@dataclass
class Request:
    rid: int
    prompt: np.ndarray          # [s] int64
    max_new_tokens: int
    tokens: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    finished: bool = False
    submit_t: float = 0.0       # perf_counter at submit (TTFT anchor)
    deadline_t: Optional[float] = None  # perf_counter; None = no deadline
    # propagated request trace (observability.trace_context): a fronting
    # layer mints it; the batcher opens admit/prefill/decode spans under
    # it; ``spans`` holds the OPEN ones so abort paths can close them
    trace: Optional[object] = None
    spans: Dict[str, object] = field(default_factory=dict)

    @property
    def done(self) -> bool:
        return self.finished


class _ServingStats:
    """Per-batcher serving telemetry, reported TWICE: local counters keep
    the ``stats()`` contract exact per instance (and resettable after
    warmup), while every event also lands in the process-wide metrics
    registry as ``serving_*`` series labeled by engine."""

    def __init__(self, engine: str):
        reg = get_registry()
        eng = ("engine",)

        def c(name, help):
            return reg.counter(name, help, labelnames=eng).labels(
                engine=engine)

        def g(name, help):
            return reg.gauge(name, help, labelnames=eng).labels(
                engine=engine)

        def h(name, help):
            return reg.histogram(name, help, labelnames=eng).labels(
                engine=engine)

        self.requests = c("serving_requests_total", "requests submitted")
        self.admissions = c("serving_admissions_total",
                            "requests admitted into slots")
        self.completions = c("serving_completions_total",
                             "requests finished")
        # series of the paged batcher's preemptions and K-step blocks: the
        # dense batcher registers them and leaves them at 0, as in the JAX
        # package
        c("serving_preemptions_total",
          "requests preempted back to the queue")
        self.tokens_c = c("serving_tokens_total", "tokens generated")
        self.steps_c = c("serving_steps_total", "decode steps")
        c("serving_decode_blocks_total", "K-step decode blocks dispatched")
        self.queue_depth = g("serving_queue_depth",
                             "pending requests right now")
        self.active_slots = g("serving_active_slots",
                              "occupied slots right now")
        self.ttft = h("serving_ttft_seconds",
                      "submit to first generated token")
        self.step_seconds = h("serving_step_seconds",
                              "one decode dispatch wall time")
        self.token_seconds = h("serving_per_token_seconds",
                               "per-token decode latency")
        self.shed_c = c("requests_shed_total",
                        "requests rejected at admission (queue full)")
        self.expired_c = c("serving_deadline_expired_total",
                           "requests abandoned on an expired deadline")
        self.reset()

    def reset(self):
        """Re-baseline the per-instance counters (the registry series are
        process-cumulative by design and keep running)."""
        self.steps = 0
        self.tokens = 0
        self.occupancy_sum = 0
        self.completed = 0
        self.shed = 0
        self.expired = 0
        self.t0 = _time.perf_counter()

    # -- events -------------------------------------------------------------
    def on_submit(self, pending_now: int):
        self.requests.inc()
        self.queue_depth.set(pending_now)

    def on_admit(self):
        self.admissions.inc()

    def on_token(self, req: Request):
        self.tokens += 1
        self.tokens_c.inc()
        if len(req.tokens) == 1 and req.submit_t:
            self.ttft.observe(_time.perf_counter() - req.submit_t)

    def on_step(self):
        self.steps += 1
        self.steps_c.inc()

    def on_occupancy(self, n: int):
        self.occupancy_sum += n

    def on_decode_time(self, dt: float, tokens: int):
        self.step_seconds.observe(dt)
        self.token_seconds.observe(dt)
        # join the dispatch against a registered roofline's serving token
        # bound (roofline.serving.* gauges; no-op without a model)
        roofline_attr.observe_serving_step(dt, tokens)

    def on_complete(self):
        self.completed += 1
        self.completions.inc()

    def on_shed(self):
        self.shed += 1
        self.shed_c.inc()

    def on_deadline_expired(self):
        self.expired += 1
        self.expired_c.inc()

    def set_gauges(self, pending: int, active: int):
        self.queue_depth.set(pending)
        self.active_slots.set(active)

    # -- the stats() contract -----------------------------------------------
    def snapshot(self, max_batch: int, pending: int,
                 active: int) -> Dict[str, float]:
        dt = max(_time.perf_counter() - self.t0, 1e-9)
        steps = max(self.steps, 1)
        return {
            "steps": self.steps,
            "generated_tokens": self.tokens,
            "tokens_per_sec": self.tokens / dt,
            "mean_active_slots": self.occupancy_sum / steps,
            "slot_utilization": self.occupancy_sum / steps / max_batch,
            "completed_requests": self.completed,
            # the paged batcher's keys, constant here: a dense slot is
            # never preempted, its cache is not int8, and it decodes one
            # token a dispatch
            "preemptions": 0,
            "pending_now": pending,
            "active_now": active,
            "elapsed_s": dt,
            "cachekv_clip_rate": 0.0,
            "decode_blocks": 0,
            "requests_shed": self.shed,
            "deadline_expired": self.expired,
        }


class _BatcherBase:
    """Request lifecycle: FIFO submission, finish-on-EOS-or-budget, result
    retrieval, deadline expiry + load shedding, health reporting, and the
    drive loop. Subclasses own the cache layout and implement
    ``_release_slot(slot)`` plus ``_step_impl()`` (one engine step; the
    base ``step()`` wraps it with deadline/health/chaos policy)."""

    _engine = "serving"        # registry label; subclasses override

    def _init_queues(self, max_queue_depth: Optional[int] = None,
                     default_deadline_s: Optional[float] = None):
        self._slot_req: Dict[int, Request] = {}
        self._pending: List[Request] = []
        self._finished: Dict[int, Request] = {}
        self._failed: Dict[int, Exception] = {}
        self._next_rid = 0
        # intake lock: serializes submit-side producers (a fronting RPC
        # layer may call submit/abort off-thread) against the step loop's
        # queue harvest. Slot/device/cache state stays step-loop-owned and
        # is deliberately NOT under this lock: holding it across
        # prefill/decode would block every submitter for a full device
        # dispatch. Reentrant: submit and the step loop both nest
        # _expire_pending.
        self._intake = threading.RLock()
        self._max_queue_depth = max_queue_depth
        self._default_deadline_s = default_deadline_s
        self._tele = _ServingStats(self._engine)
        self.health = HealthStateMachine(
            capacity=max_queue_depth or 2 * self.max_batch,
            engine=self._engine)

    def reset_stats(self):
        """Zero the counters and restart the clock -- call after warmup so
        steady-state throughput excludes capture time."""
        self._tele.reset()

    def stats(self) -> Dict[str, float]:
        """Throughput/occupancy counters for monitoring: decode steps,
        generated tokens, tokens/sec since construction, mean active
        slots per step, utilization (active/max_batch), completions,
        queue depth right now."""
        return self._tele.snapshot(self.max_batch, len(self._pending),
                                   len(self._slot_req))

    @staticmethod
    def _check_window(cfg, s_max: int):
        if s_max > cfg.max_position_embeddings:
            raise ValueError(f"s_max={s_max} exceeds "
                             f"max_position_embeddings="
                             f"{cfg.max_position_embeddings}")

    def _validate(self, prompt: np.ndarray, max_new_tokens: int):
        if max_new_tokens < 1:
            # admission emits one token from the prefill logits, so a
            # zero-token request cannot match generate(max_new_tokens=0)
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) + max_new_tokens > self.s_max:
            raise ValueError(f"prompt {len(prompt)} + {max_new_tokens} "
                             f"exceeds slot capacity {self.s_max}")

    def submit(self, prompt_ids, max_new_tokens: int,
               deadline_s: Optional[float] = None,
               trace: Optional[object] = None) -> int:
        """Queue a request. Raises typed ``Overloaded`` when the pending
        queue is at ``max_queue_depth`` (load shedding -- a fronting layer
        maps it to 429). ``deadline_s`` (or the batcher's default) bounds
        the request's total latency: an expired request is abandoned at
        the next step boundary and its result() raises
        ``DeadlineExceeded``. ``trace`` (a ``TraceContext``) propagates a
        fronting layer's request trace: the batcher opens its
        admit/prefill/decode spans under it."""
        prompt = np.asarray(prompt_ids, np.int64).reshape(-1)
        self._validate(prompt, max_new_tokens)
        # purge already-expired queued requests BEFORE the capacity
        # check: a dead-on-arrival queue entry must not cause a shed
        # (shed and deadline_expired stay disjoint per request)
        self._expire_pending()
        shed_depth = None
        with self._intake:
            if self._max_queue_depth is not None \
                    and len(self._pending) >= self._max_queue_depth:
                shed_depth = len(self._pending)
            else:
                rid = self._next_rid
                self._next_rid += 1
                budget = deadline_s if deadline_s is not None \
                    else self._default_deadline_s
                now = _time.perf_counter()
                self._pending.append(Request(
                    rid, prompt, max_new_tokens, submit_t=now,
                    deadline_t=None if budget is None else now + budget,
                    trace=trace))
                depth = len(self._pending)
        # telemetry/health callbacks run OUTSIDE _intake: they can
        # re-enter the batcher or block on an exporter
        if shed_depth is not None:
            self._tele.on_shed()
            self.health.on_shed()
            raise Overloaded(
                f"pending queue at capacity "
                f"({shed_depth}/{self._max_queue_depth})")
        self._tele.on_submit(depth)
        return rid

    # -- request-trace hooks (observability.trace_context) -------------------
    # All no-ops when the request carries no TraceContext: one attribute
    # check per event.
    def _trace_admit_begin(self, req: Request):
        if req.trace is not None:
            req.spans["admit"] = req.trace.begin("admit",
                                                 engine=self._engine)

    def _trace_prefill_begin(self, req: Request):
        if req.trace is not None:
            req.spans["prefill"] = req.trace.begin(
                "prefill", parent=req.spans.get("admit"))

    def _trace_prefill_end(self, req: Request, **tags):
        sp = req.spans.pop("prefill", None)
        if sp is not None:
            sp.end(**tags)

    def _trace_admit_end(self, req: Request, slot: int):
        """Close the admit span and open the decode span (which stays
        open across batched steps until the request finishes)."""
        sp = req.spans.pop("admit", None)
        if sp is not None:
            sp.end(slot=slot)
        if req.trace is not None:
            req.spans["decode"] = req.trace.begin("decode", slot=slot)

    def _trace_close(self, req: Request, **tags):
        if req.spans:
            end_open_spans(req.spans, **tags)

    def _fail(self, req: Request, exc: Exception):
        req.slot = None
        req.finished = True
        self._trace_close(req, error=type(exc).__name__)
        self._failed[req.rid] = exc

    def _expire_pending(self):
        """Abandon QUEUED requests whose deadline passed. Runs both at
        the step boundary and at submit time (before the capacity
        check), so an expired queue entry frees its spot instead of
        pushing a live request into a shed."""
        now = _time.perf_counter()
        with self._intake:
            expired = [r for r in self._pending
                       if r.deadline_t is not None and now > r.deadline_t]
            for req in expired:
                self._pending.remove(req)
        # fail/notify outside _intake: _fail closes the request trace and
        # on_deadline_expired is a telemetry callback
        for req in expired:
            self._fail(req, DeadlineExceeded(
                f"request {req.rid} expired while queued"))
            self._tele.on_deadline_expired()

    def _expire_deadlines(self):
        """Abandon requests whose deadline passed -- pending ones silently
        leave the queue, active ones release their slot so live traffic
        gets the capacity back."""
        self._expire_pending()
        now = _time.perf_counter()
        for slot, req in list(self._slot_req.items()):
            if req.deadline_t is not None and now > req.deadline_t:
                del self._slot_req[slot]
                self._release_slot(slot)
                self._fail(req, DeadlineExceeded(
                    f"request {req.rid} expired after "
                    f"{len(req.tokens)} tokens"))
                self._tele.on_deadline_expired()

    def step(self) -> List[int]:
        """Expire deadlines, then run one engine step (subclass
        ``_step_impl``); feeds the health state machine and the
        ``serving.step`` chaos point. Returns rids finishing during THIS
        call."""
        self._expire_deadlines()
        try:
            fault_point("serving.step")
            finished = self._step_impl()
        except Exception:
            self.health.on_step_error()
            raise
        self.health.on_step_ok(len(self._pending))
        autospool_tick()   # per-rank metrics spool; no-op unarmed
        return finished

    def _pick(self, logits_np):
        """Next-token selection (greedy or sampled) on host logits [B, V];
        the JAX package's sampling semantics (``select_token``)."""
        return select_token(logits_np, self._do_sample, self._temperature,
                            self._top_k, self._top_p, self._rng)

    def _maybe_finish(self, req: Request, tok: int) -> bool:
        if (self.eos_id is not None and tok == self.eos_id) \
                or len(req.tokens) >= req.max_new_tokens:
            slot = req.slot
            req.slot = None
            req.finished = True
            del self._slot_req[slot]
            self._release_slot(slot)
            self._trace_close(req, tokens=len(req.tokens))
            self._finished[req.rid] = req
            self._tele.on_complete()
            return True
        return False

    def _release_slot(self, slot: int):          # pragma: no cover
        raise NotImplementedError

    def result(self, rid: int) -> np.ndarray:
        """Full sequence (prompt + generated) of a finished request.
        Raises the request's typed failure (``DeadlineExceeded``) if it
        was abandoned instead of completed."""
        if rid in self._failed:
            raise self._failed[rid]
        req = self._finished[rid]
        return np.concatenate([req.prompt, np.asarray(req.tokens)])

    def pop_result(self, rid: int) -> np.ndarray:
        """result() + release the request's memory -- long-lived batchers
        must pop (or use run_until_done, which pops) or _finished grows
        with every request ever served."""
        if rid in self._failed:
            raise self._failed.pop(rid)
        out = self.result(rid)
        del self._finished[rid]
        return out

    def _has_work(self) -> bool:
        return bool(self._pending or self._slot_req)

    def run_until_done(self, max_steps: int = 10000) -> Dict[int, np.ndarray]:
        """Drive until every submitted request completes; returns (and
        releases) exactly THIS run's results. Raises if the step budget
        is exhausted with work still pending/active -- a silent partial
        dict would read as lost requests."""
        done: List[int] = []
        for _ in range(max_steps):
            done += self.step()
            if not self._has_work():
                break
        else:
            raise RuntimeError(
                f"run_until_done: {len(self._pending)} pending / "
                f"{len(self._slot_req)} active requests remain after "
                f"{max_steps} steps")
        return {rid: self.pop_result(rid) for rid in done}

    @property
    def active(self) -> int:
        return len(self._slot_req)

    @property
    def pending(self) -> int:
        return len(self._pending)

    def request(self, rid: int) -> Optional[Request]:
        """The live ``Request`` record for ``rid`` -- queued, active, or
        finished-but-unpopped; None once popped or failed. Read-only view
        for fronting layers (a gateway polls ``.tokens`` off it for
        streaming delivery)."""
        for req in self._pending:
            if req.rid == rid:
                return req
        for req in self._slot_req.values():
            if req.rid == rid:
                return req
        return self._finished.get(rid)

    def failure(self, rid: int) -> Optional[Exception]:
        """The stored typed failure for ``rid`` (``DeadlineExceeded``,
        ...) without raising/popping it; None while healthy."""
        return self._failed.get(rid)

    def abort(self, rid: int) -> bool:
        """Withdraw a LIVE request without recording a failure -- the
        caller re-owns it (and may resume it token-exact from
        ``prompt + delivered``). Pending requests leave the queue; active
        ones release their slot. Returns True when something was
        withdrawn; False for an unknown rid or a terminal request
        (finished results stay poppable, failures stay raised by
        ``pop_result``)."""
        with self._intake:
            for req in list(self._pending):
                if req.rid == rid:
                    self._pending.remove(req)
                    return True
        for slot, req in list(self._slot_req.items()):
            if req.rid == rid:
                del self._slot_req[slot]
                self._release_slot(slot)
                req.slot = None
                return True
        return False


class ContinuousBatcher(_BatcherBase):
    """Continuous batcher over a causal LM's dense KV cache.

    model: any model exposing ``prefill(input_ids, s_max, n_valid)`` and
    ``decode_step(tok, caches, t)`` with the ``[B, 1]`` t convention; in
    the port that is ``LlamaForCausalLM`` (``GPT2ForCausalLM`` has no
    serving methods yet). max_batch: slot count (one decode step of this
    batch serves every step). s_max: per-slot cache rows (prompt +
    generation must fit). eos_id: optional early-stop token.

    compile: capture the decode step as a CUDA graph (``jit.to_static``,
    the caches donated: the graph updates ``self._caches`` in place, and
    admission writes a slot into that same tensor) and replay it every
    step. It needs a model on the card; ``compile=False`` runs the step
    eagerly on either device. The prefill stays eager: it is device-bound,
    so one graph per bucket would save little.

    do_sample / temperature / top_k / top_p / seed: the host token pick
    (``models.generation.select_token``). max_queue_depth: shed with
    ``Overloaded`` past it. default_deadline_s: the deadline of requests
    submitted without one. prompt_buckets: the ladder admission pads
    prompts onto (``perf.buckets`` spec; None disables).
    """

    _engine = "dense"

    def __init__(self, model, max_batch: int = 8, s_max: int = 256,
                 eos_id: Optional[int] = None, compile: bool = True,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: Optional[float] = None,
                 seed: Optional[int] = None,
                 max_queue_depth: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 prompt_buckets="pow2"):
        device = next(model.parameters()).device
        if compile and device.type != "cuda":
            raise ValueError(
                f"ContinuousBatcher(compile=True) captures the decode step "
                f"as a CUDA graph, which needs a model on the card (this "
                f"one is on {device}); pass compile=False to run the step "
                "eagerly")
        self.model = model
        self._device = device
        self._do_sample = do_sample
        self._temperature = temperature
        self._top_k = top_k
        self._top_p = top_p
        self._rng = np.random.RandomState(seed)
        self.max_batch = max_batch
        self.s_max = s_max
        self.eos_id = eos_id
        cfg = model.config
        self._check_window(cfg, s_max)
        L, d = cfg.num_hidden_layers, cfg.head_dim
        # GQA models cache at kv-head count (unexpanded)
        kvh = getattr(cfg, "num_key_value_heads", None) \
            or cfg.num_attention_heads
        self._caches = torch.zeros(L, 2, max_batch, kvh, s_max, d,
                                   dtype=to_torch_dtype(cfg.dtype),
                                   device=device)
        self._t = np.full((max_batch, 1), s_max - 1, np.int32)  # parked
        self._free = list(range(max_batch))
        self._init_queues(max_queue_depth=max_queue_depth,
                          default_deadline_s=default_deadline_s)
        self._last_tok = np.zeros((max_batch, 1), np.int64)
        # Admission pads prompts up this ladder (None disables), capped at
        # s_max so the top rung is always admissible.
        self._prompt_ladder = resolve_ladder(prompt_buckets, hi=s_max)
        if compile:
            # donate the caches (argument 1): the graph updates them in
            # place instead of copying them each step
            self._step_fn = to_static(model.decode_step, donate_args=(1,))
        else:
            self._step_fn = model.decode_step
        self._prefill_fn = model.prefill

    # -- request lifecycle --------------------------------------------------
    def _release_slot(self, slot: int):
        self._free.append(slot)
        self._t[slot, 0] = self.s_max - 1  # park

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(self._device)

    def _host_logits(self, logits: torch.Tensor) -> np.ndarray:
        """The last position's logits [B, V] as float32 numpy (exactly the
        bf16 values, for a bf16 model)."""
        return logits[:, -1].float().cpu().numpy()

    def _admit(self) -> List[int]:
        """Move pending requests into free slots (prefill writes the slot's
        cache rows). Prompts are right-padded up the bucket ladder
        (``prompt_buckets``) and the model gathers the true last-token
        logits at ``n_valid - 1``. Padded tokens are counted in
        ``serving.bucket_pad_waste``. Returns rids that finished AT
        admission (max_new_tokens == 1 or EOS on the prefill token)."""
        finished = []
        while True:
            with self._intake:
                if not (self._pending and self._free):
                    break
                req = self._pending.pop(0)
            slot = self._free.pop(0)
            self._trace_admit_begin(req)
            prompt = req.prompt
            n = len(prompt)
            n_valid = None
            if self._prompt_ladder is not None:
                pad = pad_amount(self._prompt_ladder, n)
                if pad:
                    # labeled by the rung so waste can be attributed per
                    # bucket without re-deriving the ladder
                    get_registry().counter(
                        "serving.bucket_pad_waste",
                        "pad tokens admission added to reach the prompt "
                        "bucket",
                        labelnames=("rung",)).labels(
                            rung=str(n + pad)).inc(pad)
                    prompt = np.concatenate(
                        [prompt, np.zeros(pad, prompt.dtype)])
                # passed even for exact-rung prompts, as in the JAX
                # package, so every admission in a bucket runs one way
                n_valid = self._to_device(np.full((1, 1), n, np.int32))
            ids = self._to_device(prompt[None, :])
            self._trace_prefill_begin(req)
            with torch.no_grad():
                logits, cache, _t = self._prefill_fn(ids, self.s_max,
                                                     n_valid)
            self._trace_prefill_end(req, prompt_tokens=n,
                                    padded_to=len(prompt))
            self._caches[:, :, slot] = cache[:, :, 0]
            tok = int(self._pick(self._host_logits(logits))[0])
            req.slot = slot
            req.tokens.append(tok)
            self._tele.on_admit()
            self._tele.on_token(req)
            self._slot_req[slot] = req
            self._t[slot, 0] = n
            self._last_tok[slot, 0] = tok
            self._trace_admit_end(req, slot)
            if self._maybe_finish(req, tok):
                finished.append(req.rid)
        return finished

    # -- the engine ---------------------------------------------------------
    def _step_impl(self) -> List[int]:
        """Admit, decode one token for every active slot, evict finished.
        Returns the rids that finished during THIS call (including ones
        that finished at admission)."""
        finished = self._admit()
        self._tele.set_gauges(len(self._pending), len(self._slot_req))
        if not self._slot_req:
            return finished
        self._tele.on_step()
        self._tele.on_occupancy(len(self._slot_req))
        n_active = len(self._slot_req)
        t0 = _time.perf_counter()
        with torch.no_grad():
            logits, self._caches, _ = self._step_fn(
                self._to_device(self._last_tok), self._caches,
                self._to_device(self._t))
        next_tok = self._pick(self._host_logits(logits))
        for slot, req in list(self._slot_req.items()):
            tok = int(next_tok[slot])
            self._t[slot, 0] += 1
            req.tokens.append(tok)
            self._tele.on_token(req)
            self._last_tok[slot, 0] = tok
            if self._maybe_finish(req, tok):
                finished.append(req.rid)
        self._tele.on_decode_time(_time.perf_counter() - t0, n_active)
        self._tele.set_gauges(len(self._pending), len(self._slot_req))
        return finished
