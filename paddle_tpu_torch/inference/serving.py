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
pages across requests (``PagedContinuousBatcher``'s docstring). Its pool
may hold int8 pages, with calibrated static scales (``kv_quant="int8"``)
or per-request dynamic ones (``cache_quant="dynamic_int8"``).

The paged batcher's prefix cache may spill to host and disk tiers, whose
chains come back by an asynchronous promotion stream, and it pins paused
sessions' chains (``PagedContinuousBatcher``'s docstring).

Not ported yet: speculative decode; the tensor-parallel shard group.
"""
from __future__ import annotations

import os as _os
import threading
import time as _time
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import to_torch_dtype
from ..jit import to_static
from ..models.generation import paged_state, select_token
from ..observability import roofline_attr
from ..observability.fleet import autospool_tick, spool_event
from ..observability.metrics import get_registry
from ..observability.trace_context import end_open_spans
from ..perf.buckets import pad_amount, resolve_ladder
from ..perf.prefetch import AsyncLoader, consume
from ..resilience.chaos import fault_point
from ..resilience.recovery import (DeadlineExceeded, HealthStateMachine,
                                   Overloaded)
from .prefix_cache import DiskTier, HostTier, RadixPrefixCache, blob_nbytes
from .session_store import SessionManifest, SessionStore, model_identity

__all__ = ["ContinuousBatcher", "PagedContinuousBatcher", "Request"]

# a layer's dynamic int8 scales, in the order the batcher stores them
_SCALE_KEYS = ("kq", "vq", "kdq", "vdq")


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
        self.cachekv_elems = 0
        self.cachekv_clipped = 0
        self.warned_cachekv_clip = False
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

    def on_cachekv(self, clipped: int, total: int):
        self.cachekv_elems += total
        self.cachekv_clipped += clipped

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
            "cachekv_clip_rate": (self.cachekv_clipped
                                  / max(self.cachekv_elems, 1)),
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

    # the saturation counters of dynamic int8 pages, under the JAX
    # package's names
    @property
    def _stat_cachekv_elems(self) -> int:
        return self._tele.cachekv_elems

    @property
    def _stat_cachekv_clipped(self) -> int:
        return self._tele.cachekv_clipped

    @property
    def _warned_cachekv_clip(self) -> bool:
        return self._tele.warned_cachekv_clip

    @_warned_cachekv_clip.setter
    def _warned_cachekv_clip(self, v: bool):
        self._tele.warned_cachekv_clip = v

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

    kv_quant="int8": the pool holds int8 pages quantized with the model's
    static per-head scales (``model.calibrate_cachekv_int8`` first; a
    calibrated model allocates int8 pages either way, and this option
    makes the contract explicit). cache_quant="dynamic_int8": int8 pages
    with per-request scales, computed by each prompt's prefill (with
    ``prefill_chunk``, by its first chunk, whose pad tail is kept out of
    the statistics; later chunks and decode quantize with them) and kept in
    one fixed device tensor per (slot, head) that the host overwrites on
    admission and release. Later chunks' rows above the first chunk's amax
    saturate: ``stats()["cachekv_clip_rate"]`` samples the top-bin share
    of each long prompt's last chunk, and one ``RuntimeWarning`` fires
    when it exceeds max(1%, 3 x the first chunk's). The gauges
    ``serving.kv_quant_enabled`` and ``serving.kv_quant_bytes_saved`` say
    whether the pool is int8 and what that saves against the model's
    parameter type.

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
    the capacity; with dynamic int8, a first chunk and a later chunk); it
    needs a model on the card, and ``compile=False`` runs
    them eagerly on either device. Whole-prompt and ladder prefills stay
    eager: each length or rung would be a graph of its own. do_sample /
    temperature / top_k / top_p / seed: the host token pick.
    max_queue_depth: shed with ``Overloaded`` past it. default_deadline_s:
    the deadline of requests submitted without one.

    Tiers (with ``prefix_cache``): ``host_kv_gib`` (else
    ``PADDLE_KV_HOST_GIB``) bounds a host tier that eviction demotes
    chains into instead of dropping them, each page read off the pool in
    one gather and one copy into host memory (pinned on the card);
    ``disk_kv_dir`` (else ``PADDLE_KV_DISK_DIR``) adds a disk tier of
    ``disk_kv_gib`` (else ``PADDLE_KV_DISK_GIB``, 16) below it for the
    host tier's overflow. ``tier_quant="int8"`` stores demoted pages as
    int8 codes with a float32 scale per head (the JAX package's numpy
    arithmetic, bit for bit), half the bytes. A match whose tail is off
    the device opens a promotion stream for the queue's head: the tail's
    pages are reserved, and ``promo_chunk_blocks``-block chunks, up to
    ``promo_slots`` at a time, are read from their tiers and copied to the
    card on a stream of their own by ``perf.prefetch.AsyncLoader``'s
    workers while decode steps go on; the main thread installs each
    finished chunk at a step boundary, in place into the pools (a
    captured graph's leaves), so the next replay reads it.
    ``promo_timeout_s`` bounds the progress between two chunks; a stream
    that stalls, fails or loses its pages to a live decode is cancelled
    and its request prefills in full. ``close()`` retires the workers.

    Sessions: ``pin_session`` holds a chain so that churn may demote it
    but not drop it out of the last tier; ``pause_session`` also
    publishes the session's manifest to ``session_store`` (a
    ``SessionStore`` or its directory), from which ``resume_session`` on
    any replica returns the tokens to resubmit.

    Not ported yet, raising ``NotImplementedError`` that names its
    ROADMAP.md item when set: ``draft_model``, speculative decode and its
    failover (queue 1, item 1.5).
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
                 disk_kv_gib: Optional[float] = None,
                 promo_timeout_s: float = 5.0,
                 promo_slots: int = 2,
                 promo_chunk_blocks: Optional[int] = 4,
                 session_store=None,
                 prompt_buckets=None,
                 draft_model=None):
        # the JAX package's guards, in its order, before the option that
        # waits: a combination it refuses raises its ValueError here too
        if policy not in ("reserve", "ondemand"):
            raise ValueError(f"unknown policy {policy!r}")
        if promo_slots < 1:
            raise ValueError("promo_slots must be >= 1")
        if promo_chunk_blocks is not None and promo_chunk_blocks < 1:
            raise ValueError("promo_chunk_blocks must be >= 1 (or None "
                             "for one whole-tail chunk)")
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
        if cache_quant not in (None, "dynamic_int8"):
            raise ValueError(f"unknown cache_quant {cache_quant!r} "
                             f"(use None or 'dynamic_int8'; static int8 "
                             f"comes from model.calibrate_cachekv_int8)")
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unknown kv_quant {kv_quant!r} "
                             f"(use None or 'int8')")
        if kv_quant:
            if cache_quant:
                raise ValueError(
                    "kv_quant='int8' (static calibrated pages) and "
                    "cache_quant (dynamic per-request scales) are two "
                    "quantizers for the same pool; pick one")
            if getattr(model, "_cachekv_scales", None) is None:
                raise ValueError(
                    "kv_quant='int8' needs static per-head cache scales: "
                    "run model.calibrate_cachekv_int8(sample_ids) before "
                    "constructing the batcher")
            if draft_model is not None:
                raise ValueError(
                    "kv_quant is not supported with draft_model (the "
                    "draft pool would need its own calibration pass)")
        if tier_quant not in (None, "int8"):
            raise ValueError(f"unknown tier_quant {tier_quant!r} "
                             f"(use None or 'int8')")
        if tier_quant:
            if not prefix_cache:
                raise ValueError(
                    "tier_quant quantizes demoted host/disk tier blobs — "
                    "it needs prefix_cache=True (with a host tier)")
            if getattr(model, "_cachekv_scales", None) is not None:
                raise ValueError(
                    "tier_quant is redundant with calibrated int8 pages: "
                    "an int8 pool already spills int8 blobs natively "
                    "(and re-quantizing int8 codes would lose bits)")
        if cache_quant and prefill_chunk == 1:
            # a 1-token first chunk is decode-shaped: the attention's
            # scale opt-in guard would refuse it at the first admission
            raise ValueError("cache_quant='dynamic_int8' needs "
                             "prefill_chunk >= 2 (a 1-token chunk is "
                             "indistinguishable from a decode step)")
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
        if draft_model is not None:
            raise NotImplementedError(
                f"PagedContinuousBatcher: draft_model={draft_model!r} is "
                "not ported yet (ROADMAP.md, queue 1, item 1.5)")
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
        self.prefix_cache = None
        self._slot_nodes: Dict[int, list] = {}
        # tiered KV: one in-flight promotion stream (the queue's head only:
        # the batcher is single-threaded, so only the head can wait),
        # pipelined as up to promo_slots chunks of promo_chunk_blocks
        # blocks in flight through the AsyncLoader; finished chunks install
        # in order at step boundaries while later chunks and decode go on.
        # _promo_denied lists requests whose promotion already failed
        # (they prefill in full and never retry)
        self._promo = None
        self._promo_denied: set = set()
        self._promoter = None
        self.promo_timeout_s = promo_timeout_s
        self.promo_slots = promo_slots
        self.promo_chunk_blocks = promo_chunk_blocks
        self._demoted_seen = 0      # cache.demoted_bytes already countered
        # durable sessions: session id -> its session-pinned node chain,
        # and the shared manifest store that makes a pause resumable on
        # any replica
        self.session_store = (SessionStore(session_store)
                              if isinstance(session_store, str)
                              else session_store)
        self._session_pins: Dict[str, list] = {}
        if prefix_cache:
            host_gib = (host_kv_gib if host_kv_gib is not None else
                        float(_os.environ.get("PADDLE_KV_HOST_GIB", "0")
                              or 0.0))
            host_tier = None
            if host_gib > 0:
                ddir = disk_kv_dir or _os.environ.get("PADDLE_KV_DISK_DIR")
                nxt = None
                if ddir:
                    dgib = (disk_kv_gib if disk_kv_gib is not None else
                            float(_os.environ.get("PADDLE_KV_DISK_GIB",
                                                  "16") or 16.0))
                    nxt = DiskTier(ddir, int(dgib * (1 << 30)))
                host_tier = HostTier(int(host_gib * (1 << 30)),
                                     next_tier=nxt)
            self.prefix_cache = RadixPrefixCache(
                block_size, host_tier=host_tier,
                spill=self._read_page_blob if host_tier is not None
                else None)
            if host_tier is not None:
                self._promoter = AsyncLoader(
                    depth=max(2, promo_slots),
                    device=device if device.type == "cuda" else None,
                    workers=max(1, promo_slots))
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
        self._kv_quant_g = reg.gauge(
            "serving.kv_quant_enabled",
            "1 when the paged KV pool stores int8 pages (static "
            "calibrated scales), else 0")
        self._kv_quant_saved_g = reg.gauge(
            "serving.kv_quant_bytes_saved",
            "pool bytes saved by int8 KV pages vs the model fp dtype")
        self._promote_h = reg.histogram(
            "serving.prefix_promotion_seconds",
            "host->device prefix promotion latency (submit to install)")
        self._promo_c = reg.counter(
            "serving.prefix_promotions",
            "prefix pages promoted host/disk -> device")
        self._promo_fail_c = reg.counter(
            "serving.prefix_promotion_failures",
            "promotions that failed/timed out/lost the page race "
            "(admission degraded to full prefill)")
        self._demote_bytes_c = reg.counter(
            "serving.prefix_demoted_bytes",
            "KV bytes spilled device -> host tier on eviction")
        self._demote_h = reg.histogram(
            "serving.prefix_demotion_seconds",
            "device->host read of one demoted page (gather, optional "
            "int8 quantization, copy to host memory)")
        self._host_bytes_g = reg.gauge(
            "serving.kv_host_bytes",
            "bytes currently held by the host KV tier")
        self._spill_raw_c = reg.counter(
            "serving.prefix_spill_raw_bytes",
            "pre-quantization KV bytes demoted to the host tier "
            "(what the spill WOULD cost stored raw)")
        self._spill_blob_c = reg.counter(
            "serving.prefix_spill_blob_bytes",
            "as-stored KV bytes demoted to the host tier (int8+scales "
            "when tier_quant is on; equals raw otherwise)")
        self._dequant_h = reg.histogram(
            "quant.dequant_seconds",
            "main-thread blob dequantize time when installing promoted "
            "tier chunks (the overhead tier_quant pays on promotion)")

        self.cache_quant = cache_quant
        self.kv_quant = kv_quant
        self.tier_quant = tier_quant
        pool = model.paged_alloc(n_pages + 1, block_size,
                                 cache_dtype="int8" if cache_quant else None)
        # a calibrated model allocates int8 pages with or without
        # kv_quant: the gauges report the pool as allocated
        pool_int8 = pool[0][0].dtype == torch.int8
        self._kv_quant_g.set(1 if pool_int8 else 0)
        if pool_int8:
            # the float item size from the model's parameters (numpy, which
            # the JAX package asks, has no bfloat16)
            fp_itemsize = next(model.parameters()).element_size()
            elems = sum(kc.numel() + vc.numel() for kc, vc in pool)
            self._kv_quant_saved_g.set(elems * max(0, fp_itemsize - 1))

        # the device state: one tensor each for the block table, the
        # timelines and the last tokens, which the host overwrites before
        # every step, so the captured step's donated leaves never move
        self._state = paged_state(pool, self._to_device(self._bt),
                                  max_batch, 0, block_size,
                                  self.blocks_per_seq)
        self._tok_dev = self._to_device(self._last_tok)
        if cache_quant:
            # per-(slot, kv-head) dynamic scales, host-owned like the block
            # table ([L, 4, B, KV]: kq, vq, kdq, vdq; ones while a slot is
            # free), each admission's prefill filling its slot's rows. The
            # state holds views of one device copy, which _sync_tables
            # overwrites, so a captured step keeps its leaves.
            cfg = model.config
            kvh = getattr(cfg, "num_key_value_heads", None) \
                or cfg.num_attention_heads
            self._scales_host = np.ones(
                (cfg.num_hidden_layers, 4, max_batch, kvh), np.float32)
            self._scales_np = [dict(zip(_SCALE_KEYS, layer))
                               for layer in self._scales_host]
            self._scales_dev = self._to_device(self._scales_host)
            self._state["cache_scales"] = [dict(zip(_SCALE_KEYS, layer))
                                           for layer in self._scales_dev]
            self._scales_dirty = False

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
            if cache_quant:
                # dynamic int8 with chunks: two fixed-width calls, the first
                # chunk computing the sequence's scales (its pad tail kept
                # out of the statistics by nvalid) and returning them, the
                # later ones quantizing with them, so every row of the
                # timeline has one scale set
                def _chunk_dyn_first(ids, layers, bt_row, dec, at, nvalid):
                    return model.paged_prefill_into(
                        ids, layers, bt_row, block_size, dec_base=dec,
                        logits_at=at, dynamic_cache_scales=True,
                        dynamic_scale_valid=nvalid)

                def _chunk_dyn_rest(ids, layers, bt_row, dec, at, scales):
                    return model.paged_prefill_into(
                        ids, layers, bt_row, block_size, dec_base=dec,
                        logits_at=at, cache_scales=scales)
                self._chunk_dyn_first_fn = static(_chunk_dyn_first, 1)
                self._chunk_dyn_rest_fn = static(_chunk_dyn_rest, 1)
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
        """Retire the async promotion workers (idempotent; they are daemon
        threads, so skipping this only delays cleanup)."""
        if self._promoter is not None:
            self._promoter.close()

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

    # -- tiered KV: demotion and async promotion ----------------------------
    def _evict_cache_pages(self, n: int) -> List[int]:
        """Reclaim up to n pages from the prefix cache (demoting to the
        host tier when one is attached), mirroring the demoted-byte delta
        into the counter."""
        freed = self.prefix_cache.evict(n)
        if freed:
            self._free_pages.extend(freed)
            self._prefix_evict_c.inc(len(freed))
        d = self.prefix_cache.demoted_bytes - self._demoted_seen
        if d:
            self._demote_bytes_c.inc(d)
            self._demoted_seen = self.prefix_cache.demoted_bytes
        return freed

    @staticmethod
    def _quant_page(arr: torch.Tensor):
        """Per-head symmetric int8 quantization of KV page rows ``[...,
        H, block, D]``: (int8 codes, float32 dequant scale ``[..., H, 1,
        1]``), the JAX package's numpy float32 arithmetic bit for bit:
        amax over (block, D), scale amax / 127 (1 where amax is 0, so
        all-zero padding round-trips exactly), codes clip(rint(a /
        scale)). Both divisions divide by a tensor: on the card a division
        by a Python number multiplies by its reciprocal, which can differ
        in the last bit. ``torch.round`` rounds half to even, as
        ``np.rint`` does."""
        a = arr.float()
        amax = a.abs().amax(dim=(-2, -1), keepdim=True)
        scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                            torch.ones_like(amax))
        q = torch.round(a / scale).clamp_(-127, 127).to(torch.int8)
        return q, scale

    @staticmethod
    def _dequant_rows(codes: torch.Tensor, scales: torch.Tensor):
        return codes.float() * scales

    def _host_copy(self, t: torch.Tensor) -> torch.Tensor:
        """A host copy of ``t`` (pinned for a card tensor; the copy is
        queued, and the caller synchronizes once for all of them)."""
        if not t.is_cuda:
            return t
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t, non_blocking=True)
        return out

    def _read_page_blob(self, node):
        """The cache's spill callback: read one node's KV rows off the pool
        into host memory. Every layer's K and V rows of the page come out
        in one gather, ``[L, 2, KV, block, D]``, and one copy (one
        synchronization), not one per layer.

        With ``tier_quant='int8'`` the rows are quantized on the pool's
        device before the copy, so half the bytes cross the bus: the blob
        holds the codes under ``t`` and the per-head scales under ``ts``
        (the key marks a quantized blob; ``_install_chunk`` dequantizes on
        promotion), about half of what a chain costs the host and disk
        budgets. An int8 pool (static calibration) never takes this path:
        its pages spill int8 as they are and reinstall verbatim."""
        t0 = _time.perf_counter()
        page = int(node.page)
        layers = self._state["layers"]
        rows = torch.stack([t[page] for kv in layers for t in kv])
        rows = rows.view(len(layers), 2, *rows.shape[1:])
        raw = blob_nbytes(rows)
        if self.tier_quant:
            codes, scales = self._quant_page(rows)
            blob = {"t": self._host_copy(codes),
                    "ts": self._host_copy(scales)}
        else:
            blob = {"t": self._host_copy(rows)}
        if rows.is_cuda:
            torch.cuda.current_stream(rows.device).synchronize()
        self._spill_raw_c.inc(raw)
        self._spill_blob_c.inc(blob_nbytes(blob))
        self._demote_h.observe(_time.perf_counter() - t0)
        return blob

    def _submit_promo_chunk(self, promo) -> bool:
        """Move one waiting chunk into flight. Its blobs are read off their
        tiers in the worker (a callable payload the loader materializes
        before the copy), so a later chunk's host or disk read overlaps an
        earlier chunk's main-thread install and the copies in flight. Safe
        because every stream node carries ``node.promo`` and a pin for the
        duration: the evictors skip it, so its tier blob cannot move under
        the worker. A read error fails the chunk's future and the poller
        cancels the stream; False here only means the submit itself failed
        (the loader closed)."""
        chunk = promo["waiting"].pop(0)
        nodes = list(chunk["nodes"])
        cache = self.prefix_cache

        def _read():
            blobs = [cache.node_blob(n) for n in nodes]
            # a worker-side write, published to the main thread by the
            # future's event: read only after done()
            chunk["nbytes"] = [blob_nbytes(b) for b in blobs]
            return blobs

        try:
            chunk["future"] = self._promoter.submit(_read)
        except Exception:
            promo["waiting"].insert(0, chunk)
            return False
        promo["chunks"].append(chunk)
        return True

    def _start_promotion(self, req, dev: list, tail: list) -> bool:
        """Open a pipelined promotion stream for the off-device tail of
        ``req``'s matched path. Pins the whole path (the device prefix too:
        eviction must not demote what the request is about to use) and
        reserves one target page per tail node up front, so a finished
        transfer always has somewhere to land. The tail is split into
        ``promo_chunk_blocks``-block chunks, up to ``promo_slots`` of them
        in flight at once. False (nothing pinned, nothing reserved) if
        pages cannot be found or chaos says no: the caller falls back to a
        prefill after the device prefix."""
        try:
            fault_point("kv.host_promote")
        except Exception:
            self._promo_fail_c.inc()
            self.prefix_cache.promotion_failures += 1
            self._promo_denied.add(req.rid)
            return False
        pinned = dev + tail
        self.prefix_cache.pin(pinned)
        need = len(tail)
        if need > len(self._free_pages):
            self._evict_cache_pages(need - len(self._free_pages))
        if need > len(self._free_pages):
            self.prefix_cache.unpin(pinned)
            return False
        pages = [self._free_pages.pop() for _ in range(need)]
        csize = self.promo_chunk_blocks or len(tail)
        t0 = _time.perf_counter()
        promo = {"req": req, "pinned": pinned,
                 # nodes and pages shrink as chunks install: they are the
                 # not-yet-installed rest (the audit's and cancel's view)
                 "nodes": list(tail), "pages": list(pages),
                 "chunks": [],    # in flight, in order
                 "waiting": [{"nodes": tail[i:i + csize],
                              "pages": pages[i:i + csize],
                              "src_tiers": [n.residency
                                            for n in tail[i:i + csize]]}
                             for i in range(0, len(tail), csize)],
                 "t0": t0, "deadline": t0 + self.promo_timeout_s,
                 "installed_rows": 0, "src_tiers": []}
        while promo["waiting"] and len(promo["chunks"]) < self.promo_slots:
            if not self._submit_promo_chunk(promo):
                for ch in promo["chunks"] + promo["waiting"]:
                    self._free_pages.extend(ch["pages"])
                self.prefix_cache.unpin(pinned)
                self._promo_fail_c.inc()
                self.prefix_cache.promotion_failures += 1
                self._promo_denied.add(req.rid)
                # chunks already in flight are orphaned to the worker;
                # their staged tensors are dropped on arrival
                return False
        self._promo = promo
        for n in tail:
            n.promo = promo
        return True

    def _cancel_promotion(self, deny: bool):
        """Abandon the promotion stream: every chunk not yet installed
        gives its reserved pages back to the pool, and the path is
        unpinned. Chunks already installed stay (cache-owned device pages
        now: a partial promotion deepens the device prefix). ``deny``
        marks a failure (timeout, error, pages lost to a live decode): the
        request will not retry and prefills in full; deny=False is the
        benign path where the head of the queue changed."""
        promo, self._promo = self._promo, None
        for n in promo["nodes"]:
            n.promo = None
        self.prefix_cache.unpin(promo["pinned"])
        self._free_pages.extend(promo["pages"])
        if deny:
            self._promo_fail_c.inc()
            self.prefix_cache.promotion_failures += 1
            self._promo_denied.add(promo["req"].rid)

    def _install_chunk(self, promo, chunk, staged):
        """Land one finished chunk's staged blobs in the pool and hand its
        pages to the cache. Main thread only, and in place: each layer's
        pool tensor takes the chunk's pages by one ``index_copy_`` into
        its own storage, so the captured graphs, whose leaves the pools
        are, read the promoted pages at their next replay. On the card the
        main stream first waits on the chunk's copy event."""
        consume(chunk["future"], staged)
        rows = []
        for blob in staged:
            if blob.get("ts") is not None:
                # a tier_quant blob: codes and scales back to float before
                # the pool write, timed (the promotion-side cost tier_quant
                # pays)
                tq0 = _time.perf_counter()
                rows.append(self._dequant_rows(blob["t"], blob["ts"]))
                self._dequant_h.observe(_time.perf_counter() - tq0)
            else:
                rows.append(blob["t"])
        rows = torch.stack(rows)               # [n, L, 2, KV, block, D]
        idx = torch.tensor(chunk["pages"], dtype=torch.long,
                           device=self._device)
        for li, (kc, vc) in enumerate(self._state["layers"]):
            kc.index_copy_(0, idx, rows[:, li, 0].to(kc.dtype))
            vc.index_copy_(0, idx, rows[:, li, 1].to(vc.dtype))
        for node, page, nb in zip(chunk["nodes"], chunk["pages"],
                                  chunk["nbytes"]):
            self.prefix_cache.promote_node(node, page, nb)
            node.promo = None
        promo["installed_rows"] += len(chunk["nodes"]) * self.block_size
        promo["src_tiers"].extend(chunk["src_tiers"])
        done = set(id(n) for n in chunk["nodes"])
        promo["nodes"] = [n for n in promo["nodes"] if id(n) not in done]
        drop = set(chunk["pages"])
        promo["pages"] = [p for p in promo["pages"] if p not in drop]

    def _poll_promotion(self) -> str:
        """Advance the promotion stream: 'pending' while transfers run
        (decode steps go on: that is the overlap), 'ok' once every chunk
        has installed at a step boundary, 'failed' on an error or timeout
        (the remaining reserved pages reclaimed; chunks already installed
        stay, deepening the device prefix). Each finished chunk refreshes
        the deadline: the timeout bounds progress, not the stream's total
        time, so a long cold resume is not penalized for its length."""
        promo = self._promo
        while promo["chunks"]:
            head = promo["chunks"][0]
            fut = head["future"]
            if not fut.done():
                if _time.perf_counter() < promo["deadline"]:
                    return "pending"
                self._cancel_promotion(deny=True)
                return "failed"
            try:
                staged = fut.result()
            except Exception:
                self._cancel_promotion(deny=True)
                return "failed"
            self._install_chunk(promo, head, staged)
            promo["chunks"].pop(0)
            promo["deadline"] = _time.perf_counter() + self.promo_timeout_s
            while (promo["waiting"]
                   and len(promo["chunks"]) < self.promo_slots):
                if not self._submit_promo_chunk(promo):
                    self._cancel_promotion(deny=True)
                    return "failed"
        if promo["waiting"]:           # pragma: no cover — defensive
            self._cancel_promotion(deny=True)
            return "failed"
        self.prefix_cache.unpin(promo["pinned"])
        self._promote_h.observe(_time.perf_counter() - promo["t0"])
        self._promo_c.inc(promo["installed_rows"] // self.block_size)
        self._promo_installed_rows = promo["installed_rows"]
        self._promo_src_tiers = list(promo["src_tiers"])
        self._promo = None
        return "ok"

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
        if self.cache_quant:
            self._scales_host[:, :, slot] = 1.0
            self._scales_dirty = True
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
        if self._promo is not None:
            # pages reserved for an in-flight promotion are spoken for
            used.update(int(p) for p in self._promo["pages"])
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
            # the cross-tier half: host and disk blob bytes reconcile too
            rep = self.prefix_cache.audit_tiers()
            self._host_bytes_g.set(rep.get("host_bytes", 0))
        return 0

    @property
    def free_page_count(self) -> int:
        return len(self._free_pages)

    # -- durable sessions ---------------------------------------------------
    def _session_gauge(self):
        if not hasattr(self, "_session_pin_g"):
            self._session_pin_g = get_registry().gauge(
                "session.pinned_blocks",
                "prefix-cache blocks currently held by session pins")
        return self._session_pin_g

    def model_identity(self) -> str:
        return model_identity(self.model)

    def pin_session(self, session_id: str, token_ids) -> int:
        """Session-pin the cached chain covering ``token_ids``' full blocks
        (replacing any earlier pin for this id): churn may demote the
        chain to host or disk but can no longer drop it out of the last
        tier, so a resume finds it promotable. Local only: durability
        across replicas is the manifest's job (``pause_session``). Returns
        the number of pinned blocks."""
        if self.prefix_cache is None:
            return 0
        self.unpin_session(session_id)
        path = self.prefix_cache.match(token_ids)
        if path:
            self.prefix_cache.session_pin(path)
            self._session_pins[session_id] = path
        self._session_gauge().set(
            sum(len(p) for p in self._session_pins.values()))
        spool_event("session", op="pin", session=session_id,
                    blocks=len(path))
        return len(path)

    def unpin_session(self, session_id: str) -> bool:
        nodes = self._session_pins.pop(session_id, None)
        if not nodes:
            return False
        self.prefix_cache.session_unpin(nodes)
        self._session_gauge().set(
            sum(len(p) for p in self._session_pins.values()))
        return True

    def release_sessions(self):
        """Drop every local session pin (manifests are untouched: the
        sessions stay resumable elsewhere). The close and remove path."""
        for sid in list(self._session_pins):
            self.unpin_session(sid)

    def pause_session(self, session_id: str, token_ids) -> bool:
        """Pause a conversation: pin its chain locally and publish the
        crash-safe manifest (id -> chain hashes, tokens, model identity) to
        the shared store, so any replica can resume it later. True iff the
        manifest published atomically; on a torn publish (chaos, IO) the
        chain stays pinned locally: a resume here still rides the cache, one
        elsewhere falls back to a re-prefill."""
        self.pin_session(session_id, token_ids)
        if self.session_store is None:
            return False
        toks = np.asarray(token_ids, np.int64).reshape(-1)
        m = SessionManifest(session_id=session_id,
                            token_ids=[int(t) for t in toks],
                            block_size=self.block_size,
                            model=self.model_identity())
        return self.session_store.publish(m)

    def resume_session(self, session_id: str):
        """Resolve a paused session to the token ids to resubmit (``prompt
        + generated`` of the paused turn: submitting them and the new turn
        re-matches the pinned chain and streams its promotion). None when
        the manifest is missing, torn or corrupt, or the model identity
        changed (a typed finding in the store; the caller prefills from its
        own context, token-exact either way)."""
        if self.session_store is None:
            return None
        m = self.session_store.load(session_id,
                                    expect_model=self.model_identity())
        if m is None:
            return None
        # a block size mismatch only invalidates the manifest's chain
        # hashes (a routing hint); the radix tree matches raw token blocks
        return np.asarray(m.token_ids, np.int64)

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
        if self._promo is not None and (
                not self._pending
                or self._pending[0] is not self._promo["req"]):
            # the promotion's request left the head (expired, aborted):
            # a benign cancel, its pages back
            self._cancel_promotion(deny=False)
        while self._pending and self._free_slots:
            req = self._pending[0]
            matched = []
            promoted_rows = 0
            src_tiers: List[str] = []
            if self.prefix_cache is not None:
                ids_full = np.concatenate(
                    [req.prompt, np.asarray(req.tokens, np.int64)]) \
                    if req.tokens else req.prompt
                # at least one suffix token must prefill: the first
                # generated token needs its logits
                cap_blocks = (len(ids_full) - 1) // self.block_size
                matched = self.prefix_cache.match(ids_full,
                                                  max_blocks=cap_blocks)
                dev, tail = self.prefix_cache.split_device(matched)
                if self._promo is not None:
                    st = self._poll_promotion()
                    if st == "pending":
                        if not self._slot_req:
                            # nothing to overlap with: do not spin the
                            # step loop while the transfer lands
                            _time.sleep(500e-6)
                        break
                    # ok: the tail is on the device now; failed: it stays
                    # off and is prefilled below. Either way split the
                    # tree's new state again
                    matched = self.prefix_cache.match(ids_full,
                                                      max_blocks=cap_blocks)
                    dev, tail = self.prefix_cache.split_device(matched)
                    matched = dev
                    if st == "ok":
                        promoted_rows = self._promo_installed_rows
                        src_tiers = self._promo_src_tiers
                elif (tail and self._promoter is not None
                        and req.rid not in self._promo_denied):
                    if self._start_promotion(req, dev, tail):
                        break     # decode steps go on while it flies
                    matched = dev
                else:
                    # an off-device tail that cannot be used (no promoter,
                    # or this request's promotion already failed): prefill
                    # it; insert() upgrades the stale nodes in place
                    matched = dev
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
            self._promo_denied.discard(req.rid)
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
                                                   slot, dec0=m_rows)
                elif self.cache_quant:
                    logits, _, seq_scales = self.model.paged_prefill_into(
                        self._to_device(ids_np[None, :]),
                        self._state["layers"], bt_row, self.block_size,
                        dynamic_cache_scales=True)
                    self._store_slot_scales(slot, seq_scales)
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
                self.prefix_cache.hit_tokens += m_rows
                self.prefix_cache.miss_tokens += S
                self._tier_hit_c.labels(tier="device").inc(
                    m_rows - promoted_rows)
                for t in src_tiers:
                    self._tier_hit_c.labels(tier=t).inc(self.block_size)
                self.prefix_cache.host_hit_tokens += promoted_rows
                new_nodes = self.prefix_cache.insert(
                    ids_np, self._bt[slot], len(matched),
                    L // self.block_size)
                self._slot_nodes[slot] = list(matched) + new_nodes
            end_tags = dict(prompt_tokens=len(ids_np), pages=need,
                            prefix_hit=m_rows, padded_to=padded_len)
            if promoted_rows:
                # a promoted resume repaid its eviction from a tier, not by
                # recomputing
                end_tags["host_promoted"] = promoted_rows
            self._trace_prefill_end(req, **end_tags)
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

    def _prefill_chunked(self, ids_np, bt_row, slot, dec0: int = 0):
        """Feed ``ids_np`` through fixed-width append chunks after ``dec0``
        rows already in the slot's pages (a cached prefix), one
        ``_chunk_fn`` call (a graph replay with ``compile=True``) a chunk.
        The tail chunk is zero-padded, and shortened at the slot's
        capacity; pad rows land past the true timeline and decode
        overwrites them before any read reaches them. Returns the last real
        position's logits [1, V].

        Dynamic int8 (``cache_quant``): the first chunk computes the
        sequence's per-head scales from its valid rows and returns them;
        every later chunk, and decode, quantizes with them (a prompt within
        one chunk is the unchunked dynamic path exactly). The slot's scale
        rows are stored after the last chunk, and the saturation of a long
        prompt's last chunk is sampled against the first's."""
        C = self.prefill_chunk
        L = len(ids_np)
        cap = self.blocks_per_seq * self.block_size
        padded_len = min(-(-L // C) * C, cap - dec0)
        padded = np.zeros((1, padded_len), np.int64)
        padded[0, :L] = ids_np
        dec = 0
        logits = None
        scales = None
        last_rest = None          # (dec, nvalid) of the last later chunk
        first_nvalid = 0          # valid rows of the scale-setting chunk
        while dec < padded_len:
            w = min(C, padded_len - dec)     # the tail shortens at capacity
            has_last = 0 <= (L - 1) - dec < w
            # a copy, so the ids keep one layout (a captured graph keys
            # its inputs' strides) whatever the prompt's length
            args = (self._to_device(padded[:, dec:dec + w].copy()),
                    self._state["layers"], bt_row,
                    self._to_device(np.array([dec0 + dec], np.int32)),
                    self._to_device(np.array(
                        [(L - 1) - dec if has_last else 0], np.int32)))
            if not self.cache_quant:
                lg, _ = self._chunk_fn(*args)
            elif scales is None:
                first_nvalid = min(L - dec, w)
                lg, _, scales = self._chunk_dyn_first_fn(
                    *args, self._to_device(np.array([first_nvalid],
                                                    np.int32)))
            else:
                lg, _ = self._chunk_dyn_rest_fn(*args, scales)
                if L - dec > 0:
                    last_rest = (dec, min(L - dec, w))
            if has_last:
                logits = lg
            dec += w
        if scales is not None:
            if last_rest is not None:
                # sampled: one read of the scale-setting chunk (the
                # baseline), one of the last later chunk
                base = self._topbin_counts(bt_row, 0, first_nvalid)
                self._record_chunk_saturation(
                    bt_row, last_rest[0], last_rest[1],
                    baseline=None if base is None
                    else base[0] / max(base[1], 1))
            self._store_slot_scales(slot, scales)
        return logits

    def _topbin_counts(self, bt_row, dec, nvalid):
        """(top-bin entries, entries) over the int8 K/V rows at positions
        [dec, dec + nvalid) of a block-table row ``[1, bps]``, over every
        layer, or None when the pool is not int8. |code| >= 127 is a proxy:
        a saturated value and one within ~0.4% of the amax both land in the
        top bin, which is why the warning compares against a baseline. One
        read to the host: it syncs, so it runs outside every graph."""
        if nvalid <= 0:
            return None
        bt = np.asarray(bt_row.cpu() if torch.is_tensor(bt_row)
                        else bt_row)[0]
        pos = np.arange(dec, dec + nvalid)
        phys = torch.from_numpy(bt[pos // self.block_size].astype(np.int64))
        off = torch.from_numpy(pos % self.block_size)
        clipped, total = 0, 0
        for kc, vc in self._state["layers"]:
            for pool in (kc, vc):
                if pool.dtype != torch.int8:
                    return None
                rows = pool[phys.to(pool.device), :, off.to(pool.device)]
                clipped = clipped + (rows.to(torch.int32).abs()
                                     >= 127).sum()
                total += rows.numel()
        return int(clipped), total

    def _record_chunk_saturation(self, bt_row, dec, nvalid, baseline=None):
        """Saturation telemetry of dynamic int8 with chunks: later chunks
        quantize with the first chunk's scales, so values above its amax
        clip at +/-127 with no other trace. Adds the top-bin count of rows
        [dec, dec + nvalid) to ``stats()["cachekv_clip_rate"]`` and warns
        once when the share exceeds max(1%, 3 x ``baseline``, the first
        chunk's own share: a peaked distribution is not saturation)."""
        counts = self._topbin_counts(bt_row, dec, nvalid)
        if counts is None:
            return
        clipped, total = counts
        self._tele.on_cachekv(clipped, total)
        rate = clipped / max(total, 1)
        threshold = max(0.01, 3.0 * (baseline or 0.0))
        if rate > threshold and not self._tele.warned_cachekv_clip:
            self._tele.warned_cachekv_clip = True
            warnings.warn(
                f"cachekv-int8 chunked prefill: {rate:.1%} of a later "
                f"chunk's K/V entries sit in the top quantization bin "
                f"(baseline {0.0 if baseline is None else baseline:.1%}) "
                f"— values likely exceed the first-chunk scales "
                f"(documented first-window semantics); long-prompt "
                f"accuracy may degrade. stats()['cachekv_clip_rate'] "
                f"tracks the sampled rate.",
                RuntimeWarning, stacklevel=2)

    def _store_slot_scales(self, slot, seq_scales):
        """Copy a one-sequence prefill's per-layer scale dicts into the
        slot's host rows (the decode step reads their device copy)."""
        self._scales_host[:, :, slot] = torch.stack([
            torch.stack([sc[k][0] for k in _SCALE_KEYS])
            for sc in seq_scales]).cpu().numpy()
        self._scales_dirty = True

    def _sync_tables(self):
        """Copy the host's block table and timelines into the state's own
        device tensors (the captured step's donated leaves)."""
        self._state["block_tables"].copy_(torch.from_numpy(self._bt))
        self._state["dec_lens"].copy_(torch.from_numpy(self._dec))
        if self.cache_quant and self._scales_dirty:
            # scales change only at admission and release
            self._scales_dev.copy_(torch.from_numpy(self._scales_host))
            self._scales_dirty = False

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
        back it with a page, cancelling an in-flight promotion, then
        preempting (other slots, then an in-flight fused admission) if the
        pool is dry."""
        for slot in list(self._admit_order):
            if slot not in self._slot_req:
                continue
            while not self._alloc_pages(slot, int(self._dec[slot]) + 1):
                if self._promo is not None:
                    # an in-flight promotion loses the race to a live
                    # decode: reclaim its reserved pages before touching
                    # any live request (its admission prefills in full)
                    self._cancel_promotion(deny=True)
                    continue
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
