"""Layers and functional ops (counterpart of ``paddle_tpu/nn``)."""
from . import functional
from .layers import Embedding, Linear, RMSNorm

__all__ = ["functional", "Embedding", "Linear", "RMSNorm"]
