"""Serving (counterpart of ``paddle_tpu/inference``). Ported: the dense
``ContinuousBatcher``."""
from .serving import ContinuousBatcher, Request

__all__ = ["ContinuousBatcher", "Request"]
