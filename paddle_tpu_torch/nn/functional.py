"""Functional ops of the serving path (counterpart of
``paddle_tpu/nn/functional.py``).

CUDA tensors go to the Hopper kernels; CPU tensors take the plain paths the
JAX package takes off the TPU. Nothing here falls back from a kernel to a
plain path on the card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as _tF

from ..ops.hopper import flash_attention, rms_norm as _rms_norm_kernel


def linear(x, weight, bias=None):
    """y = x W^T (+ b); weight ``[out, in]``, PyTorch's layout (the JAX
    package keeps ``[in, out]``; ``models/convert.py`` transposes)."""
    return _tF.linear(x, weight, bias)


def embedding(ids, weight):
    return _tF.embedding(ids, weight)


def silu(x):
    return _tF.silu(x)


def rms_norm(x, weight, epsilon=1e-6):
    """RMSNorm over the last dimension, through the fused kernel on the card
    and its plain version on the CPU (both round once, as the TPU kernel
    does)."""
    return _rms_norm_kernel(x, weight, epsilon)[0]


def _sdpa_dense(query, key, value, is_causal=False):
    """The JAX package's dense path (``_sdpa_op``), layout [B, S, H, D]:
    scores in the query's type, probabilities in float32 cast back to the
    query's type before P . V. Heads must already match (GQA expanded)."""
    d = query.shape[-1]
    scale = 1.0 / math.sqrt(d)
    q, k, v = (t.transpose(1, 2) for t in (query, key, value))
    scores = (q @ k.transpose(-1, -2)) * scale
    if is_causal:
        sq, sk = q.shape[2], k.shape[2]
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=query.device).tril(sk - sq)
        scores = scores.masked_fill(~keep, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1).to(query.dtype)
    return (probs @ v).transpose(1, 2)


def scaled_dot_product_attention(query, key, value, is_causal=False):
    """Attention over [B, S, H, D]. On the card it is the flash kernel (GQA
    native, equal q/k lengths; anything else raises); on the CPU it is the
    dense path with heads already expanded, as in the JAX package."""
    if query.device.type == "cuda":
        return flash_attention(query, key, value, causal=is_causal)[0]
    return _sdpa_dense(query, key, value, is_causal)
