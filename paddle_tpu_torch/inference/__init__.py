"""Serving (counterpart of ``paddle_tpu/inference``). Ported: the dense
``ContinuousBatcher``, the ``PagedContinuousBatcher``, the device tier of
the radix prefix cache, and the ``gateway`` control plane over batcher
replicas."""
from .prefix_cache import RadixPrefixCache, chain_hashes
from .serving import ContinuousBatcher, PagedContinuousBatcher, Request
from .gateway import (Autoscaler, DispatchQueue, Gateway, GatewayRequest,
                      LeastLoadedPolicy, Replica, ReplicaPool,
                      SessionAffinityPolicy, StreamingSession, TenantQuotas,
                      TokenBucket, WeightedRoundRobinPolicy)

__all__ = ["ContinuousBatcher", "PagedContinuousBatcher", "RadixPrefixCache",
           "Request", "chain_hashes",
           "Gateway", "GatewayRequest", "Replica", "ReplicaPool",
           "LeastLoadedPolicy", "SessionAffinityPolicy",
           "WeightedRoundRobinPolicy", "DispatchQueue", "TokenBucket",
           "TenantQuotas", "StreamingSession", "Autoscaler"]
