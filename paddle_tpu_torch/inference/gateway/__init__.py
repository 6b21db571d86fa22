"""Serving control plane: multi-replica gateway over the batchers
(counterpart of ``paddle_tpu/inference/gateway``).

The single-process batchers (``paddle_tpu_torch.inference.serving``) stop
at one engine; this package is the layer above — a deterministic,
single-threaded control plane that:

  * pools N batcher replicas (``ReplicaPool``/``Replica``) with health
    integration, drain/remove lifecycle, and a retry-then-declare-dead
    step policy compatible with ``resilience.chaos`` injection;
  * routes requests through pluggable policies (least-loaded,
    session/prefix-bucket affinity, smooth weighted round-robin) behind
    per-tenant token-bucket quotas and a two-level priority queue with
    SLO-aware admission (deadline feasibility, typed
    ``Overloaded``/``DeadlineExceeded`` rejections);
  * streams tokens to callers (``StreamingSession``) with intake
    backpressure;
  * requeues in-flight requests off dead replicas token-exactly
    (``gateway.requeued``), instrumented through
    ``paddle_tpu_torch.observability`` (``gateway.*`` series, the same
    names as the JAX package's);
  * scales the pool on queue depth and TTFT (``Autoscaler``).

The replicas carry the device: each batcher steps its own model (on the
card, its decode step a CUDA graph with ``compile=True``); the gateway
itself is host code.

Entry point::

    gw = Gateway(policy="affinity", max_queue_depth=64)
    gw.add_replica("r0", ContinuousBatcher(model))
    gw.add_replica("r1", ContinuousBatcher(model))
    gid = gw.submit(prompt_ids, max_new_tokens=32, tenant="alice")
    out = gw.run_until_done()[gid]
"""
from .autoscaler import Autoscaler
from .gateway import Gateway, GatewayRequest
from .quota import TenantQuotas, TokenBucket
from .replica import Replica, ReplicaPool
from .router import (DispatchQueue, LeastLoadedPolicy, PRIORITY_HIGH,
                     PRIORITY_LOW, RoutePolicy, SessionAffinityPolicy,
                     WeightedRoundRobinPolicy, resolve_policy)
from .streaming import StreamingSession

__all__ = [
    "Gateway", "GatewayRequest", "Autoscaler",
    "TokenBucket", "TenantQuotas",
    "Replica", "ReplicaPool",
    "RoutePolicy", "LeastLoadedPolicy", "SessionAffinityPolicy",
    "WeightedRoundRobinPolicy", "resolve_policy", "DispatchQueue",
    "PRIORITY_HIGH", "PRIORITY_LOW",
    "StreamingSession",
]
