"""Utilities (counterpart of ``paddle_tpu/utils``). Ported: ``locks``, cut
to the ``TracedLock`` and ``TracedRLock`` factories."""
from .locks import TracedLock, TracedRLock

__all__ = ["TracedLock", "TracedRLock"]
