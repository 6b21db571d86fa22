"""Counterpart of ``paddle_tpu/incubate/nn/functional``. Ported: the paged
GQA attention of the serving path, and GPT-2's dense and paged decode
attention."""
from .decode_attention import (block_gqa_attention, block_multihead_attention,
                               masked_multihead_attention)

__all__ = ["block_gqa_attention", "block_multihead_attention",
           "masked_multihead_attention"]
