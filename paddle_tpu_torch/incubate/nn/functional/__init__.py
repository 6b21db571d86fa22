"""Counterpart of ``paddle_tpu/incubate/nn/functional``. Ported: the paged
GQA attention of the serving path."""
from .decode_attention import block_gqa_attention

__all__ = ["block_gqa_attention"]
