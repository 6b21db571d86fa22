"""Serving (counterpart of ``paddle_tpu/inference``). Ported: the dense
``ContinuousBatcher``, the ``PagedContinuousBatcher``, the radix prefix
cache with its host and disk tiers, the durable sessions' manifest store,
and the ``gateway`` control plane over batcher replicas."""
from .prefix_cache import DiskTier, HostTier, RadixPrefixCache, chain_hashes
from .session_store import (SessionFinding, SessionManifest, SessionStore,
                            model_identity)
from .serving import ContinuousBatcher, PagedContinuousBatcher, Request
from .gateway import (Autoscaler, DispatchQueue, Gateway, GatewayRequest,
                      LeastLoadedPolicy, Replica, ReplicaPool,
                      SessionAffinityPolicy, StreamingSession, TenantQuotas,
                      TokenBucket, WeightedRoundRobinPolicy)

__all__ = ["ContinuousBatcher", "PagedContinuousBatcher", "RadixPrefixCache",
           "HostTier", "DiskTier", "Request", "chain_hashes",
           "SessionStore", "SessionManifest", "SessionFinding",
           "model_identity",
           "Gateway", "GatewayRequest", "Replica", "ReplicaPool",
           "LeastLoadedPolicy", "SessionAffinityPolicy",
           "WeightedRoundRobinPolicy", "DispatchQueue", "TokenBucket",
           "TenantQuotas", "StreamingSession", "Autoscaler"]
