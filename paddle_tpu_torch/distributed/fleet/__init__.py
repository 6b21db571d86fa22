"""Fleet utilities (counterpart of ``paddle_tpu/distributed/fleet``)."""
from .recompute import recompute

__all__ = ["recompute"]
