"""Performance policy shared by the port's entry points (counterpart of
``paddle_tpu/perf``). Ported: the shape-bucket ladder and the asynchronous
host-to-device stager of the KV cache's promotions."""
from .buckets import BucketLadder, pad_amount, resolve_ladder
from .prefetch import AsyncLoader, TransferCancelled, TransferFuture

__all__ = ["BucketLadder", "pad_amount", "resolve_ladder", "AsyncLoader",
           "TransferCancelled", "TransferFuture"]
