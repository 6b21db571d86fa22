"""Continuous batching over the KV-cache decode step (counterpart of
``paddle_tpu/inference/serving.py``: ``Request``, ``_ServingStats``,
``_BatcherBase``, the dense ``ContinuousBatcher`` and the
``PagedContinuousBatcher``).

The batcher owns ``max_batch`` SLOTS, one fixed ``[L, 2, B, KV, S, D]``
cache on the model's device, and a host-side scheduler that admits
pending requests into free slots at step boundaries, evicts finished
ones, and steps every slot through one decode step of fixed shape.
Inactive slots decode garbage into a scratch row (``s_max - 1``) that
admission's prefill overwrites before any real read (causality: a slot's
attention never reads rows past its own t), so the decode step keeps one
shape, and with ``compile=True`` one CUDA graph serves every step.

The paged batcher keeps one page pool instead: admission and preemption
move pages, not tensors, and a radix prefix cache can share a prompt's
pages across requests (``PagedContinuousBatcher``'s docstring).

Not ported yet: the paged batcher's int8 pages, host and disk tiers with
promotion, sessions and speculative decode; the tensor-parallel shard
group.
"""
from __future__ import annotations

import os as _os
import threading
import time as _time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import to_torch_dtype
from ..jit import to_static
from ..models.generation import paged_state, select_token
from ..observability import roofline_attr
from ..observability.fleet import autospool_tick
from ..observability.metrics import get_registry
from ..observability.trace_context import end_open_spans
from ..perf.buckets import pad_amount, resolve_ladder
from ..resilience.chaos import fault_point
from ..resilience.recovery import (DeadlineExceeded, HealthStateMachine,
                                   Overloaded)
from .prefix_cache import RadixPrefixCache

__all__ = ["ContinuousBatcher", "PagedContinuousBatcher", "Request"]


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
        self.preempt_c = c("serving_preemptions_total",
                           "requests preempted back to the queue")
        self.tokens_c = c("serving_tokens_total", "tokens generated")
        self.steps_c = c("serving_steps_total", "decode steps")
        self.blocks_c = c("serving_decode_blocks_total",
                          "K-step decode blocks dispatched")
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
        self.preempted = 0
        self.decode_blocks = 0
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

    def on_step(self, substeps: int = 1):
        self.steps += substeps
        self.steps_c.inc(substeps)

    def on_occupancy(self, n: int):
        self.occupancy_sum += n

    def on_decode_time(self, dt: float, substeps: int = 1,
                       tokens: int = 0):
        self.step_seconds.observe(dt)
        self.token_seconds.observe(dt / max(substeps, 1))
        if tokens:
            # join the dispatch against a registered roofline's serving
            # token bound (roofline.serving.* gauges; no-op without a model)
            roofline_attr.observe_serving_step(dt, tokens)

    def on_complete(self):
        self.completed += 1
        self.completions.inc()

    def on_preempt(self):
        self.preempted += 1
        self.preempt_c.inc()

    def on_decode_block(self):
        self.decode_blocks += 1
        self.blocks_c.inc()

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
            "preemptions": self.preempted,
            "pending_now": pending,
            "active_now": active,
            "elapsed_s": dt,
            # int8 caches are not ported
            "cachekv_clip_rate": 0.0,
            "decode_blocks": self.decode_blocks,
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
    # the paged batcher's in-flight fused admission (its request, slot and
    # detached block-table row), None when there is none
    _admitting: Optional[dict] = None

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
            tags = {}
            if req.tokens:
                # preemption resume: this prefill recomputes KV the
                # eviction threw away (prompt + already-decoded tokens)
                tags["evict_recompute"] = 1
            elif req.trace.baggage.get("requeued"):
                # failover survivor: the prompt re-prefill duplicates
                # work the dead/drained replica already did
                tags["requeue_recompute"] = 1
                if req.trace.baggage.get("drained"):
                    # administrative drain, not a death — same recompute
                    # cost, different cause
                    tags["drain_recompute"] = 1
            req.spans["prefill"] = req.trace.begin(
                "prefill", parent=req.spans.get("admit"), **tags)

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

        def expired(r: Request) -> bool:
            return r.deadline_t is not None and now > r.deadline_t

        for slot, req in list(self._slot_req.items()):
            if expired(req):
                del self._slot_req[slot]
                self._release_slot(slot)
                self._fail(req, DeadlineExceeded(
                    f"request {req.rid} expired after "
                    f"{len(req.tokens)} tokens"))
                self._tele.on_deadline_expired()
        adm = self._admitting
        if adm is not None and expired(adm["req"]):
            # an in-flight fused admission: its pages back to the pool
            self._drop_admission()
            self._fail(adm["req"], DeadlineExceeded(
                f"request {adm['req'].rid} expired during admission"))
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

    def _count_pad_waste(self, rung: int, waste: int):
        """Count the pad tokens admission added to reach a prompt bucket,
        labelled by the rung, so waste is attributed per bucket without
        re-deriving the ladder."""
        get_registry().counter(
            "serving.bucket_pad_waste",
            "pad tokens admission added to reach the prompt bucket",
            labelnames=("rung",)).labels(rung=str(rung)).inc(waste)

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
        return bool(self._pending or self._slot_req
                     or self._admitting is not None)

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
        if self._admitting is not None \
                and self._admitting["req"].rid == rid:
            return self._admitting["req"]
        return self._finished.get(rid)

    def failure(self, rid: int) -> Optional[Exception]:
        """The stored typed failure for ``rid`` (``DeadlineExceeded``,
        ...) without raising/popping it; None while healthy."""
        return self._failed.get(rid)

    def abort(self, rid: int) -> bool:
        """Withdraw a LIVE request without recording a failure -- the
        caller re-owns it (and may resume it token-exact from
        ``prompt + delivered``). Pending requests leave the queue; active
        ones release their slot, and an in-flight fused admission its
        pages. Returns True when something was withdrawn; False for an
        unknown rid or a terminal request (finished results stay
        poppable, failures stay raised by ``pop_result``)."""
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
        if self._admitting is not None \
                and self._admitting["req"].rid == rid:
            self._drop_admission()
            return True
        return False


class ContinuousBatcher(_BatcherBase):
    """Continuous batcher over a causal LM's dense KV cache.

    model: any model exposing ``prefill(input_ids, s_max, n_valid)`` and
    ``decode_step(tok, caches, t)`` with the ``[B, 1]`` t convention; in
    the port ``LlamaForCausalLM`` and ``GPT2ForCausalLM`` (whose config has
    no ``num_key_value_heads``: the cache takes its head count).
    max_batch: slot count (one decode step of this batch serves every
    step). s_max: per-slot cache rows (prompt + generation must fit).
    eos_id: optional early-stop token.

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
                    self._count_pad_waste(n + pad, pad)
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
        self._tele.on_decode_time(_time.perf_counter() - t0,
                                  tokens=n_active)
        self._tele.set_gauges(len(self._pending), len(self._slot_req))
        return finished


class PagedContinuousBatcher(_BatcherBase):
    """Continuous batching over the paged (block) KV cache.

    Cache memory is a pool of physical pages, ``[n_pages + 1, KV, bs, D]``
    per layer; a block table ``[max_batch, blocks_per_seq]`` maps each live
    sequence's logical blocks onto pool rows, and the scheduler admits and
    preempts by moving pages, not tensors. The host owns the free list, the
    block table and each slot's timeline length; it copies both tables into
    the same two device tensors before every step, so with ``compile=True``
    one CUDA graph (``jit.to_static``, the state donated) serves every step
    at every occupancy. Parked slots point every block at a reserved
    scratch page (pool row ``n_pages``) with timeline length 0, so their
    garbage decode writes land in scratch and never touch a live page.

    model: a model with the paged methods (``paged_alloc``,
    ``paged_prefill_into``, ``paged_decode_step``, and
    ``paged_fused_step`` for fused admission); in the port
    ``LlamaForCausalLM`` and ``GPT2ForCausalLM``. max_batch: slot count.
    s_max: rows a sequence may hold (prompt + generation). block_size: rows
    a page. n_pages: pool size (default: every slot's worst case). eos_id:
    optional early-stop token.

    policy:
      * ``"reserve"``: admission reserves the worst-case page count
        (ceil((prompt + max_new) / bs)) up front; the queue's head waits
        when the pool cannot cover it. No preemption.
      * ``"ondemand"``: admission reserves only the prompt's pages; a
        sequence takes one more page as it crosses each block boundary. On
        a dry pool the most recently admitted request is preempted: its
        pages return to the pool and it re-queues with prompt + generated
        so far, which a later prefill recomputes exactly.

    prefill_chunk: feed prompts through fixed-width append chunks (the tail
    chunk shortens at the slot's capacity). prefix_cache: a
    ``RadixPrefixCache`` over the pool; admission reuses the cached pages
    of the longest full-block prefix and prefills only the suffix.
    prompt_buckets: the ladder the (suffix) prefill pads onto
    (``perf.buckets`` spec; None keeps exact lengths).

    fused_admission (needs ``prefill_chunk``): admission reserves the
    prompt's pages in a row of its own and streams the prompt one chunk a
    step through ``paged_fused_step``, beside every decoding slot's token,
    so decode never pauses for a prefill. The slot's own row stays scratch
    until the last chunk, and a live decode that needs a page aborts the
    admission when nothing else can be preempted.

    decode_block=K (greedy only): when no request waits or admits, K decode
    steps run as one call with the argmax on the device feeding the next
    step; the host reads back K x B token ids and drops what a slot made
    past its EOS or budget. A block runs only when every slot's kept rows
    can be backed without preempting; otherwise the per-step path runs.

    compile: capture as CUDA graphs (``jit.to_static``, the pools donated)
    and replay the decode step, the fused step, the K-step block and the
    fixed-width chunk (at most two: the full width and a tail shortened at
    the capacity); it needs a model on the card, and ``compile=False`` runs
    them eagerly on either device. Whole-prompt and ladder prefills stay
    eager: each length or rung would be a graph of its own. do_sample /
    temperature / top_k / top_p / seed: the host token pick.
    max_queue_depth: shed with ``Overloaded`` past it. default_deadline_s:
    the deadline of requests submitted without one.

    Not ported yet, each raising ``NotImplementedError`` that names its
    ROADMAP.md item when set: ``cache_quant``, ``kv_quant`` and
    ``tier_quant`` (queue 1, item 1.3); ``host_kv_gib``, ``disk_kv_dir``
    and ``session_store`` (item 1.4); ``draft_model``, speculative decode
    and its failover (item 1.5).
    """

    _engine = "paged"

    def __init__(self, model, max_batch: int = 8, s_max: int = 256,
                 block_size: int = 16, n_pages: Optional[int] = None,
                 eos_id: Optional[int] = None, compile: bool = True,
                 policy: str = "reserve",
                 prefill_chunk: Optional[int] = None,
                 cache_quant: Optional[str] = None,
                 kv_quant: Optional[str] = None,
                 tier_quant: Optional[str] = None,
                 fused_admission: bool = False,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: Optional[float] = None,
                 seed: Optional[int] = None,
                 decode_block: Optional[int] = None,
                 max_queue_depth: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 prefix_cache: bool = False,
                 host_kv_gib: Optional[float] = None,
                 disk_kv_dir: Optional[str] = None,
                 session_store=None,
                 prompt_buckets=None,
                 draft_model=None):
        # the JAX package's guards, in its order, before the options that
        # wait: a combination it refuses raises its ValueError here too
        if policy not in ("reserve", "ondemand"):
            raise ValueError(f"unknown policy {policy!r}")
        if prefix_cache and cache_quant:
            raise ValueError(
                "prefix_cache shares pages across requests; dynamic "
                "cachekv quant scales are per-request, so a shared page "
                "would replay with the wrong scales — use static "
                "calibration or disable one")
        if prefix_cache and fused_admission:
            raise ValueError(
                "prefix_cache is not supported with fused_admission "
                "(the fused chunk streams the FULL prompt at a fixed "
                "offset grid; a cached-prefix suffix start would need a "
                "second executable per offset)")
        if decode_block is not None:
            if decode_block < 2:
                raise ValueError("decode_block must be >= 2 (1 is the "
                                 "plain per-step path)")
            if do_sample:
                # the in-block feedback is an on-device argmax; sampled
                # selection stays on the host path
                raise ValueError("decode_block requires greedy decoding "
                                 "(do_sample=False)")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if fused_admission and not prefill_chunk:
            raise ValueError("fused_admission needs prefill_chunk (the "
                             "chunk width of the fused executable)")
        if fused_admission and cache_quant:
            raise ValueError("fused_admission + dynamic cachekv quant is "
                             "not supported; use static calibration")
        if prefill_chunk is not None and prefill_chunk > s_max:
            raise ValueError(f"prefill_chunk={prefill_chunk} exceeds "
                             f"s_max={s_max}")
        if fused_admission:
            cap = -(-s_max // block_size) * block_size
            if cap % prefill_chunk:
                # the fused chunk is fixed-width; a tail shortened at the
                # capacity would be a second graph, and one padded past it
                # would write the sequence's last real page
                raise ValueError(
                    f"fused_admission needs the slot capacity ({cap}) to "
                    f"be a multiple of prefill_chunk ({prefill_chunk})")
        # each option with the ROADMAP.md queue 1 item that ports it
        waiting = {"cache_quant": (cache_quant, "1.3"),
                   "kv_quant": (kv_quant, "1.3"),
                   "tier_quant": (tier_quant, "1.3"),
                   "draft_model": (draft_model, "1.5"),
                   "host_kv_gib": (host_kv_gib, "1.4"),
                   "disk_kv_dir": (disk_kv_dir, "1.4"),
                   "session_store": (session_store, "1.4")}
        if prefix_cache and float(_os.environ.get("PADDLE_KV_HOST_GIB", "0")
                                  or 0.0) > 0:
            waiting["PADDLE_KV_HOST_GIB"] = (
                _os.environ["PADDLE_KV_HOST_GIB"], "1.4")
        for name, (value, item) in waiting.items():
            if value is not None:
                raise NotImplementedError(
                    f"PagedContinuousBatcher: {name}={value!r} is not "
                    f"ported yet (ROADMAP.md, queue 1, item {item})")
        device = next(model.parameters()).device
        if compile and device.type != "cuda":
            raise ValueError(
                f"PagedContinuousBatcher(compile=True) captures the decode "
                f"step as a CUDA graph, which needs a model on the card "
                f"(this one is on {device}); pass compile=False to run the "
                "step eagerly")
        self._check_window(model.config, s_max)
        self.model = model
        self._device = device
        self.max_batch = max_batch
        self.s_max = s_max
        self.block_size = block_size
        self.blocks_per_seq = -(-s_max // block_size)
        if n_pages is None:
            n_pages = max_batch * self.blocks_per_seq
        self.n_pages = n_pages
        self.eos_id = eos_id
        self.policy = policy
        self.prefill_chunk = prefill_chunk
        self.fused_admission = fused_admission
        self.decode_block = decode_block
        self._do_sample = do_sample
        self._temperature = temperature
        self._top_k = top_k
        self._top_p = top_p
        self._rng = np.random.RandomState(seed)

        self._scratch = n_pages                     # reserved pool row
        self._free_pages = list(range(n_pages))
        self._bt = np.full((max_batch, self.blocks_per_seq), self._scratch,
                           np.int32)
        self._dec = np.zeros((max_batch,), np.int32)
        self._free_slots = list(range(max_batch))
        self._init_queues(max_queue_depth=max_queue_depth,
                          default_deadline_s=default_deadline_s)
        self._admit_order: List[int] = []           # slots, oldest first
        self._last_tok = np.zeros((max_batch,), np.int64)

        # cross-request radix prefix reuse: admission matches the longest
        # cached full-block prefix, points the slot's block-table front at
        # the cached pages and prefills only the suffix; the tree pins pages
        # under live slots and LRU-evicts idle chains on page pressure
        self.prefix_cache = (RadixPrefixCache(block_size) if prefix_cache
                             else None)
        self._slot_nodes: Dict[int, list] = {}
        self._prompt_ladder = resolve_ladder(prompt_buckets, hi=s_max)
        reg = get_registry()
        self._prefix_hit_c = reg.counter(
            "serving.prefix_hit_tokens",
            "prompt tokens served from the radix prefix cache")
        self._prefix_miss_c = reg.counter(
            "serving.prefix_miss_tokens",
            "prompt tokens actually prefilled (no cached prefix)")
        self._prefix_evict_c = reg.counter(
            "serving.prefix_evictions",
            "prefix-cache pages LRU-evicted under page pressure")
        self._tier_hit_c = reg.counter(
            "serving.prefix_tier_hit_tokens",
            "cached prompt tokens served, by the tier they were resident "
            "in at match time", labelnames=("tier",))
        self._pages_leaked_g = reg.gauge(
            "serving.pages_leaked",
            "pages unaccounted for by free-list + block tables + prefix "
            "cache (an OOM-much-later bug if ever nonzero)")

        # the device state: one tensor each for the block table, the
        # timelines and the last tokens, which the host overwrites before
        # every step, so the captured step's donated leaves never move
        self._state = paged_state(
            model.paged_alloc(n_pages + 1, block_size),
            self._to_device(self._bt), max_batch, 0, block_size,
            self.blocks_per_seq)
        self._tok_dev = self._to_device(self._last_tok)

        def static(fn, donate):
            return to_static(fn, donate_args=(donate,)) if compile else fn

        # donate the state (argument 1): the graph appends into the page
        # pool in place and reads the host's tables from the state's own
        # tensors
        self._step_fn = static(model.paged_decode_step, 1)
        if prefill_chunk is not None:
            # one fixed-width append call serves every prompt length; the
            # pools donated (argument 1), as the decode step's
            def _chunk(ids, layers, bt_row, dec, at):
                return model.paged_prefill_into(
                    ids, layers, bt_row, block_size, dec_base=dec,
                    logits_at=at)
            self._chunk_fn = static(_chunk, 1)
        if fused_admission:
            # the admission chunk's inputs: device tensors the host
            # overwrites before each fused call (the idle values when no
            # admission is in flight)
            self._idle_chunk = (
                np.zeros((prefill_chunk,), np.int64),
                np.full((1, self.blocks_per_seq), self._scratch, np.int32),
                np.zeros((1,), np.int32), np.zeros((1,), np.int32))
            self._chunk_dev = tuple(self._to_device(a)
                                    for a in self._idle_chunk)
            self._fused_fn = static(model.paged_fused_step, 5)
        if decode_block:
            # K decode steps as one call, the argmax on the device feeding
            # the next step: one dispatch and one [K, B] read-back a block
            def _block_body(tok, state, _k=decode_block):
                toks = []
                for _ in range(_k):
                    logits, state = model.paged_decode_step(tok, state)
                    tok = torch.argmax(logits, dim=-1)
                    toks.append(tok)
                return torch.stack(toks), state
            self._block_fn = static(_block_body, 1)

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(self._device)

    def close(self):
        """The JAX package retires its promotion worker here; with no tiers
        ported there is nothing to retire."""

    # -- page accounting ----------------------------------------------------
    def _pages_for(self, n_rows: int) -> int:
        return -(-n_rows // self.block_size)

    def _alloc_pages_row(self, row: np.ndarray, upto_row: int) -> bool:
        """Grow a block-table row (a slot's row of ``_bt`` or an
        admission's detached one) so rows [0, upto_row) are backed. A dry
        free list LRU-evicts idle prefix-cache chains first (cached but
        idle pages are reclaimable capacity, not occupancy). Returns False
        (allocating nothing) if even that cannot cover it."""
        need_blocks = self._pages_for(upto_row)
        have = int(np.sum(row != self._scratch))
        grow = need_blocks - have
        if grow <= 0:
            return True
        if grow > len(self._free_pages) and self.prefix_cache is not None:
            self._evict_cache_pages(grow - len(self._free_pages))
        if grow > len(self._free_pages):
            return False
        for b in range(have, need_blocks):
            row[b] = self._free_pages.pop()
        return True

    def _alloc_pages(self, slot: int, upto_row: int) -> bool:
        return self._alloc_pages_row(self._bt[slot], upto_row)

    def _available_pages(self) -> int:
        """Pages an allocation could obtain right now: the free list and
        what the prefix cache would give up to eviction."""
        n = len(self._free_pages)
        if self.prefix_cache is not None:
            n += self.prefix_cache.evictable_pages()
        return n

    def _evict_cache_pages(self, n: int) -> List[int]:
        """Reclaim up to n pages from the prefix cache into the free
        list."""
        freed = self.prefix_cache.evict(n)
        if freed:
            self._free_pages.extend(freed)
            self._prefix_evict_c.inc(len(freed))
        return freed

    def _release_row(self, row: np.ndarray, keep=()):
        """Reset a block-table row to scratch, returning its pages to the
        free list, except ``keep`` (pages the prefix cache owns: the
        cache's refcounts, not this row, decide their lifetime)."""
        for b in range(self.blocks_per_seq):
            if row[b] != self._scratch:
                if int(row[b]) not in keep:
                    self._free_pages.append(int(row[b]))
                row[b] = self._scratch

    def _release_slot(self, slot: int):
        keep = ()
        if self.prefix_cache is not None:
            nodes = self._slot_nodes.pop(slot, None)
            if nodes:
                self.prefix_cache.unpin(nodes)
                keep = {n.page for n in nodes}
        self._release_row(self._bt[slot], keep)
        self._dec[slot] = 0
        self._free_slots.append(slot)
        self._admit_order.remove(slot)
        self.audit_pages()

    def audit_pages(self) -> int:
        """Reconcile the page pool after every release: free list, block
        table rows and prefix-cache pages must cover range(n_pages) exactly
        once (a block-table row and the cache may share a page: that is
        the prefix cache's point; free and anything else is a double
        free). Publishes ``serving.pages_leaked`` and raises on any
        anomaly, so a leak fails the releasing operation instead of
        surfacing as an out-of-memory much later. Returns the leak count
        (0 whenever it returns)."""
        free_set = set(self._free_pages)
        used = {int(b) for b in self._bt.reshape(-1) if b != self._scratch}
        if self._admitting is not None:
            used.update(int(b) for b in self._admitting["row"]
                        if b != self._scratch)
        cache_pages = set()
        if self.prefix_cache is not None:
            cp = self.prefix_cache.pages()
            cache_pages = set(cp)
            if len(cache_pages) != len(cp):
                raise RuntimeError("page accounting bug: prefix cache "
                                   "holds a page in two nodes")
        leaked = set(range(self.n_pages)) - free_set - used - cache_pages
        self._pages_leaked_g.set(len(leaked))
        if len(free_set) != len(self._free_pages):
            raise RuntimeError("page accounting bug: free list holds a "
                               "page twice")
        double = free_set & (used | cache_pages)
        if leaked or double:
            raise RuntimeError(
                f"page accounting bug: leaked={sorted(leaked)} "
                f"free-but-used={sorted(double)}")
        if self.prefix_cache is not None:
            self.prefix_cache.audit_tiers()
        return 0

    @property
    def free_page_count(self) -> int:
        return len(self._free_pages)

    # -- request lifecycle --------------------------------------------------
    def _validate(self, prompt: np.ndarray, max_new_tokens: int):
        super()._validate(prompt, max_new_tokens)
        worst = len(prompt) + max_new_tokens
        cap = self.blocks_per_seq * self.block_size
        if self.prefill_chunk:
            # chunk padding can demand more rows than the timeline (a
            # resumed prompt pads up to one chunk beyond); reject now
            # rather than stall admission later
            worst = max(worst, min(
                -(-worst // self.prefill_chunk) * self.prefill_chunk, cap))
        elif self._prompt_ladder is not None:
            # the ladder can round a resumed prompt past the timeline too
            worst = max(worst, min(self._prompt_ladder.bucket(worst), cap))
        pages = self._pages_for(worst)
        if pages > self.n_pages:
            raise ValueError(f"request needs {pages} pages but the pool "
                             f"holds {self.n_pages}")

    def _admission_plan(self, req: Request, m_rows: int = 0):
        """The resume ids, chunk or ladder padding and page budget of an
        admission. ``m_rows`` is the cached-prefix row count: only the
        suffix is prefilled, so padding applies to the suffix and is
        clamped to the capacity left after the cached rows. Returns
        (ids, L, padded_len, upto): the admission ids and their length,
        the padded timeline length, and the rows to back with pages."""
        ids_np = np.concatenate(
            [req.prompt, np.asarray(req.tokens, np.int64)]) \
            if req.tokens else req.prompt
        L = len(ids_np)
        S = L - m_rows
        cap = self.blocks_per_seq * self.block_size
        if self.prefill_chunk:
            pad_s = min(-(-S // self.prefill_chunk) * self.prefill_chunk,
                        cap - m_rows)
        elif self._prompt_ladder is not None:
            pad_s = min(self._prompt_ladder.bucket(S), cap - m_rows)
        else:
            pad_s = S
        padded_len = m_rows + pad_s
        if self.policy == "reserve":
            upto = max(padded_len, L + req.max_new_tokens - len(req.tokens))
        else:
            upto = max(padded_len, L + 1)
        return ids_np, L, padded_len, upto

    def _admit(self) -> List[int]:
        """FIFO admission into free slots, gated by page availability
        (reserve: the worst case up front; ondemand: the prompt and the
        first step). The queue's head blocks those behind it, which keeps
        arrival order. Returns rids that finished at admission."""
        finished = []
        while self._pending and self._free_slots:
            req = self._pending[0]
            matched = []
            if self.prefix_cache is not None:
                ids_full = np.concatenate(
                    [req.prompt, np.asarray(req.tokens, np.int64)]) \
                    if req.tokens else req.prompt
                # at least one suffix token must prefill: the first
                # generated token needs its logits
                matched = self.prefix_cache.match(
                    ids_full, max_blocks=(len(ids_full) - 1)
                    // self.block_size)
                if matched:
                    # pin before the availability gate: the gate may admit
                    # on the promise of evicting other chains, and eviction
                    # must not take these pages
                    self.prefix_cache.pin(matched)
            m_rows = len(matched) * self.block_size
            ids_np, L, padded_len, upto = self._admission_plan(req, m_rows)
            need = self._pages_for(upto) - len(matched)
            if need > self._available_pages():
                if matched:
                    self.prefix_cache.unpin(matched)
                break
            with self._intake:
                self._pending.pop(0)
            slot = self._free_slots.pop(0)
            if matched:
                self._bt[slot, :len(matched)] = [n.page for n in matched]
            if not self._alloc_pages(slot, upto):
                raise RuntimeError("page accounting bug: admission gate "
                                   "passed but allocation failed")
            self._trace_admit_begin(req)
            self._trace_prefill_begin(req)
            bt_row = self._to_device(self._bt[slot:slot + 1])
            S = L - m_rows
            with torch.no_grad():
                if self.prefill_chunk:
                    logits = self._prefill_chunked(ids_np[m_rows:], bt_row,
                                                   dec0=m_rows)
                elif m_rows or self._prompt_ladder is not None:
                    # suffix prefill: S real tokens appended after the
                    # m_rows cached rows, padded up to the rung (pad rows
                    # lie past the timeline; decode overwrites them before
                    # any read)
                    pad_s = padded_len - m_rows
                    if pad_s != S:
                        self._count_pad_waste(pad_s, pad_s - S)
                    sfx = np.zeros((1, pad_s), np.int64)
                    sfx[0, :S] = ids_np[m_rows:]
                    logits, _ = self.model.paged_prefill_into(
                        self._to_device(sfx), self._state["layers"],
                        bt_row, self.block_size,
                        dec_base=self._to_device(
                            np.array([m_rows], np.int32)),
                        logits_at=self._to_device(
                            np.array([S - 1], np.int32)))
                else:
                    logits, _ = self.model.paged_prefill_into(
                        self._to_device(ids_np[None, :]),
                        self._state["layers"], bt_row, self.block_size)
            if self.prefix_cache is not None:
                self._prefix_hit_c.inc(m_rows)
                self._prefix_miss_c.inc(S)
                self._tier_hit_c.labels(tier="device").inc(m_rows)
                self.prefix_cache.hit_tokens += m_rows
                self.prefix_cache.miss_tokens += S
                new_nodes = self.prefix_cache.insert(
                    ids_np, self._bt[slot], len(matched),
                    L // self.block_size)
                self._slot_nodes[slot] = list(matched) + new_nodes
            self._trace_prefill_end(req, prompt_tokens=len(ids_np),
                                    pages=need, prefix_hit=m_rows,
                                    padded_to=padded_len)
            tok = int(self._pick(logits.float().cpu().numpy())[0])
            req.slot = slot
            req.tokens.append(tok)
            self._tele.on_admit()
            self._tele.on_token(req)
            self._slot_req[slot] = req
            self._admit_order.append(slot)
            self._dec[slot] = len(ids_np)
            self._last_tok[slot] = tok
            self._trace_admit_end(req, slot)
            if self._maybe_finish(req, tok):
                finished.append(req.rid)
        return finished

    def _prefill_chunked(self, ids_np, bt_row, dec0: int = 0):
        """Feed ``ids_np`` through fixed-width append chunks after ``dec0``
        rows already in the slot's pages (a cached prefix), one
        ``_chunk_fn`` call (a graph replay with ``compile=True``) a chunk.
        The tail chunk is zero-padded, and shortened at the slot's
        capacity; pad rows land past the true timeline and decode
        overwrites them before any read reaches them. Returns the last real
        position's logits [1, V]."""
        C = self.prefill_chunk
        L = len(ids_np)
        cap = self.blocks_per_seq * self.block_size
        padded_len = min(-(-L // C) * C, cap - dec0)
        padded = np.zeros((1, padded_len), np.int64)
        padded[0, :L] = ids_np
        dec = 0
        logits = None
        while dec < padded_len:
            w = min(C, padded_len - dec)     # the tail shortens at capacity
            has_last = 0 <= (L - 1) - dec < w
            # a copy, so the ids keep one layout (a captured graph keys
            # its inputs' strides) whatever the prompt's length
            lg, _ = self._chunk_fn(
                self._to_device(padded[:, dec:dec + w].copy()),
                self._state["layers"], bt_row,
                self._to_device(np.array([dec0 + dec], np.int32)),
                self._to_device(np.array(
                    [(L - 1) - dec if has_last else 0], np.int32)))
            if has_last:
                logits = lg
            dec += w
        return logits

    def _sync_tables(self):
        """Copy the host's block table and timelines into the state's own
        device tensors (the captured step's donated leaves)."""
        self._state["block_tables"].copy_(torch.from_numpy(self._bt))
        self._state["dec_lens"].copy_(torch.from_numpy(self._dec))

    def _preempt_latest(self, protect: int) -> bool:
        """Evict the most recently admitted active request (not
        ``protect``) back to the front of the queue; its pages return to
        the pool. Returns False when there is no victim."""
        for slot in reversed(self._admit_order):
            if slot == protect:
                continue
            req = self._slot_req.pop(slot)
            req.slot = None
            self._release_slot(slot)
            with self._intake:
                self._pending.insert(0, req)
            self._trace_close(req, preempted=1)
            self._tele.on_preempt()
            return True
        return False

    def _grow_for_step(self):
        """ondemand: every active slot is about to write kv row dec[slot];
        back it with a page, preempting (other slots, then an in-flight
        fused admission) if the pool is dry."""
        for slot in list(self._admit_order):
            if slot not in self._slot_req:
                continue
            while not self._alloc_pages(slot, int(self._dec[slot]) + 1):
                if self._preempt_latest(protect=slot):
                    continue
                if self._admitting is not None:
                    # the admission's detached row holds pages too: abort
                    # it rather than fail a live decode
                    self._abort_admission()
                    continue
                raise RuntimeError(
                    f"page pool exhausted: slot {slot} needs a page at "
                    f"row {int(self._dec[slot])}, no free pages and no "
                    f"other request to preempt (n_pages={self.n_pages})")

    # -- the engine ---------------------------------------------------------
    def _slot_active_mask(self) -> np.ndarray:
        m = np.zeros((self.max_batch,), bool)
        for slot in self._slot_req:
            m[slot] = True
        return m

    def _step_prologue(self):
        """On-demand page growth, step counters, and the host-to-device
        table copy. The host owns the block table and the timelines:
        copying both every step keeps parked slots from drifting (the
        device step adds 1 to every slot's timeline, the host only to the
        active ones')."""
        if self.policy == "ondemand":
            self._grow_for_step()
        self._tele.on_step()
        self._tele.on_occupancy(len(self._slot_req))
        self._tele.set_gauges(len(self._pending), len(self._slot_req))
        self._sync_tables()

    def _advance_decoders(self, logits, finished: List[int]):
        """Consume a step's logits: advance timelines, append the picked
        tokens, evict finished slots."""
        self._dec += self._slot_active_mask().astype(np.int32)
        next_tok = self._pick(logits.float().cpu().numpy())
        for slot, req in list(self._slot_req.items()):
            tok = int(next_tok[slot])
            req.tokens.append(tok)
            self._tele.on_token(req)
            self._last_tok[slot] = tok
            if self._maybe_finish(req, tok):
                finished.append(req.rid)

    def _decode_tail(self, finished: List[int]):
        """One decode step for every slot (parked ones into scratch), or a
        K-step block when nothing waits or admits and the block's rows can
        be backed. The plain engine's step and the fused engine's idle
        one."""
        if not self._slot_req:
            return
        if self.decode_block and not self._pending \
                and self._admitting is None \
                and self._block_backed(self.decode_block):
            self._decode_block_tail(finished)
            return
        self._step_prologue()
        n_active = len(self._slot_req)
        t0 = _time.perf_counter()
        self._tok_dev.copy_(torch.from_numpy(self._last_tok))
        with torch.no_grad():
            # the pools are updated in place and the host re-uploads the
            # tables, so the returned state is not kept
            logits, _ = self._step_fn(self._tok_dev, self._state)
        self._advance_decoders(logits, finished)
        self._tele.on_decode_time(_time.perf_counter() - t0,
                                  tokens=n_active)

    # -- K-step decode blocks -----------------------------------------------
    def _block_backed(self, K: int) -> bool:
        """Whether a K-step block may run: for every active slot, dec + K
        stays inside the slot's capacity and the rows it keeps (up to its
        remaining budget) are backed by pages. Rows written past the budget
        land in the slot's own pages or in scratch (unbacked table entries
        stay scratch). On demand, every slot is probed before any page
        moves, and a dry pool declines (no preemption: the per-step path
        keeps that policy), so a declined block leaves no slot holding
        pages it will not use."""
        cap = self.blocks_per_seq * self.block_size
        plan = []                      # (slot, upto) to allocate on a pass
        need = 0
        for slot in list(self._admit_order):
            req = self._slot_req.get(slot)
            if req is None:
                continue
            if int(self._dec[slot]) + K > cap:
                return False
            keep = min(K, req.max_new_tokens - len(req.tokens))
            if keep <= 0:
                continue
            upto = int(self._dec[slot]) + keep
            have = int(np.sum(self._bt[slot] != self._scratch))
            need += max(0, self._pages_for(upto) - have)
            plan.append((slot, upto))
        if self.policy != "ondemand":
            return True                # reserve backed everything up front
        if need > self._available_pages():
            return False
        for slot, upto in plan:
            if not self._alloc_pages(slot, upto):   # pragma: no cover
                raise RuntimeError("page accounting bug: block probe "
                                   "passed but allocation failed")
        return True

    def _decode_block_tail(self, finished: List[int]):
        """One K-step block, then its K x B tokens consumed on the host
        sub-step by sub-step, finishing and evicting as the per-step path
        would. A slot that finishes mid-block decoded garbage for the rest
        of the block: those tokens are dropped here, and their K/V rows
        went to its own (about to be freed) pages or to scratch."""
        K = self.decode_block
        self._tele.on_step(K)
        self._tele.on_decode_block()
        self._tele.set_gauges(len(self._pending), len(self._slot_req))
        self._sync_tables()
        n_active = len(self._slot_req)
        t0 = _time.perf_counter()
        self._tok_dev.copy_(torch.from_numpy(self._last_tok))
        with torch.no_grad():
            toks, _ = self._block_fn(self._tok_dev, self._state)
        toks_np = toks.cpu().numpy()                        # [K, B]
        self._tele.on_decode_time(_time.perf_counter() - t0, K,
                                  tokens=K * n_active)
        # survivors consumed all K rows; evicted slots' timelines reset at
        # their next admission
        self._dec += K * self._slot_active_mask().astype(np.int32)
        for k in range(K):
            # occupancy at each sub-step's entry (after earlier
            # evictions), as _step_prologue counts it
            self._tele.on_occupancy(len(self._slot_req))
            for slot, req in list(self._slot_req.items()):
                tok = int(toks_np[k, slot])
                req.tokens.append(tok)
                self._tele.on_token(req)
                self._last_tok[slot] = tok
                if self._maybe_finish(req, tok):
                    finished.append(req.rid)

    # -- fused admission ----------------------------------------------------
    def _start_admission(self) -> bool:
        """Reserve a slot and the padded prompt's pages for the queue's
        head; its prompt then streams through the fused step one chunk a
        step while the other slots keep decoding."""
        if self._admitting is not None or not self._pending \
                or not self._free_slots:
            return False
        req = self._pending[0]
        ids_np, L, padded_len, upto = self._admission_plan(req)
        if self._pages_for(upto) > len(self._free_pages):
            return False
        with self._intake:
            self._pending.pop(0)
        slot = self._free_slots.pop(0)
        row = np.full((self.blocks_per_seq,), self._scratch, np.int32)
        if not self._alloc_pages_row(row, upto):
            raise RuntimeError("page accounting bug: admission gate "
                               "passed but allocation failed")
        padded = np.zeros((padded_len,), np.int64)
        padded[:L] = ids_np
        # the slot's own row stays scratch until the admission completes,
        # so its garbage decode writes land in scratch, not in the rows the
        # chunks are filling
        self._admitting = {"req": req, "slot": slot, "row": row,
                           "ids": padded, "L": L, "offset": 0}
        self._trace_admit_begin(req)
        self._trace_prefill_begin(req)
        return True

    def _drop_admission(self):
        """Give the in-flight admission's pages and slot back."""
        adm = self._admitting
        self._release_row(adm["row"])
        self._free_slots.append(adm["slot"])
        self._admitting = None

    def _abort_admission(self):
        """Preempt the in-flight admission: its pages back to the pool, the
        request to the front of the queue (it restarts from its first
        chunk; the recompute is exact, as a preempted slot's is)."""
        req = self._admitting["req"]
        self._drop_admission()
        with self._intake:
            self._pending.insert(0, req)
        self._trace_close(req, preempted=1)
        self._tele.on_preempt()
        self.audit_pages()

    def _fused_chunk_inputs(self):
        """The admission chunk's ids [C], block-table row [1, bps], rows
        already written [1] and the last real token's place in the chunk
        [1] (0 when the chunk does not hold it), as numpy arrays; the idle
        values when no admission is in flight."""
        adm = self._admitting
        if adm is None:
            return self._idle_chunk
        C = self.prefill_chunk
        o = adm["offset"]
        at = adm["L"] - 1 - o
        return (adm["ids"][o:o + C],       # always full: capacity % C == 0
                adm["row"][None, :], np.array([o], np.int32),
                np.array([at if 0 <= at < C else 0], np.int32))

    def _finish_admission(self, chunk_logits, finished: List[int]):
        """Advance the in-flight admission by one chunk; after its last
        chunk, install its block-table row and make it a decoding slot."""
        adm = self._admitting
        if adm is None:
            return
        C = self.prefill_chunk
        o, L = adm["offset"], adm["L"]
        adm["offset"] = o + C
        if not o <= L - 1 < o + C:
            return
        req, slot = adm["req"], adm["slot"]
        self._trace_prefill_end(req, prompt_tokens=L, fused=1)
        tok = int(self._pick(chunk_logits.float().cpu().numpy())[0])
        self._bt[slot] = adm["row"]
        self._dec[slot] = L
        self._last_tok[slot] = tok
        req.slot = slot
        req.tokens.append(tok)
        self._tele.on_admit()
        self._tele.on_token(req)
        self._slot_req[slot] = req
        self._admit_order.append(slot)
        self._admitting = None
        self._trace_admit_end(req, slot)
        if self._maybe_finish(req, tok):
            finished.append(req.rid)

    def _step_fused(self) -> List[int]:
        """One fused call: every decoding slot advances and the in-flight
        admission streams its next chunk. With no admission in flight the
        decode step (or a block) runs instead: an idle chunk would still
        take C tokens through the model for nothing."""
        finished: List[int] = []
        self._start_admission()
        if self._admitting is None:
            self._decode_tail(finished)
            return finished
        self._step_prologue()          # may abort the admission
        n_active = len(self._slot_req)
        t0 = _time.perf_counter()
        self._tok_dev.copy_(torch.from_numpy(self._last_tok))
        for dev, host in zip(self._chunk_dev, self._fused_chunk_inputs()):
            dev.copy_(torch.from_numpy(host))
        with torch.no_grad():
            dec_logits, chunk_logits, _ = self._fused_fn(
                self._tok_dev, *self._chunk_dev, self._state)
        self._advance_decoders(dec_logits, finished)
        self._finish_admission(chunk_logits, finished)
        self._tele.on_decode_time(_time.perf_counter() - t0,
                                  tokens=n_active)
        return finished

    def _step_impl(self) -> List[int]:
        """Admit, grow pages (ondemand), decode one token per active slot
        (or a K-step block), evict finished. With fused admission, one
        fused call admits a chunk and decodes. Returns rids finishing
        during this call."""
        if self.fused_admission:
            return self._step_fused()
        finished = self._admit()
        self._decode_tail(finished)
        return finished
