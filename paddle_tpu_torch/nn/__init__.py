"""Layers and functional ops (counterpart of ``paddle_tpu/nn``)."""
from . import functional
from .layers import Dropout, Embedding, LayerNorm, Linear, RMSNorm

__all__ = ["functional", "Dropout", "Embedding", "LayerNorm", "Linear",
           "RMSNorm"]
