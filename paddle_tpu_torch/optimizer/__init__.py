"""Optimizers and gradient clipping (counterpart of
``paddle_tpu/optimizer``). Ported: ``Adam``, ``AdamW`` and the three clips;
a float learning rate only (``LRScheduler`` is not ported yet)."""
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .optimizer import Optimizer
from .optimizers import Adam, AdamW

__all__ = ["Adam", "AdamW", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "Optimizer"]
