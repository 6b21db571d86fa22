"""Performance policy shared by the port's entry points (counterpart of
``paddle_tpu/perf``). Ported: the shape-bucket ladder."""
from .buckets import BucketLadder, pad_amount, resolve_ladder

__all__ = ["BucketLadder", "pad_amount", "resolve_ladder"]
