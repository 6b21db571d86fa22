"""Functional ops of the serving and training paths (counterpart of
``paddle_tpu/nn/functional.py``).

``rms_norm`` and ``scaled_dot_product_attention`` run through autograd
Functions whose forward and backward are the Hopper kernels for CUDA
tensors and their plain versions for CPU tensors. With grad mode off (the
serving path) they call the forward directly: the Function would record
nothing, and its dispatch costs host time on every decode step. Nothing
here falls back from a kernel to a plain path on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as _tF

from ..ops.hopper import (FlashAttentionFunction, RMSNormFunction,
                          flash_attention)
from ..ops.hopper import rms_norm as _rms_norm_fwd


def linear(x, weight, bias=None):
    """y = x W^T (+ b); weight ``[out, in]``, PyTorch's layout (the JAX
    package keeps ``[in, out]``; ``models/convert.py`` transposes)."""
    return _tF.linear(x, weight, bias)


def embedding(ids, weight):
    return _tF.embedding(ids, weight)


def silu(x):
    return _tF.silu(x)


def rms_norm(x, weight, epsilon=1e-6):
    """RMSNorm over the last dimension (both versions round once, as the TPU
    kernel does), differentiable through the backward kernel."""
    if not torch.is_grad_enabled():
        return _rms_norm_fwd(x, weight, epsilon)[0]
    return RMSNormFunction.apply(x, weight, epsilon)


def scaled_dot_product_attention(query, key, value, is_causal=False):
    """Attention over [B, S, H, D] with the flash semantics: GQA native
    (key/value may carry fewer heads), equal q/k lengths, no mask.
    Differentiable through the flash backward kernels on the card and their
    plain versions on the CPU."""
    if not torch.is_grad_enabled():
        return flash_attention(query, key, value, is_causal)[0]
    return FlashAttentionFunction.apply(query, key, value, is_causal)[0]


def cross_entropy(input, label, ignore_index=-100, reduction="mean"):
    """Softmax cross entropy of logits ``[N, C]`` against int labels
    ``[N]``; labels equal to ``ignore_index`` contribute nothing and, with
    ``reduction="mean"``, the sum is divided by the count of the others
    (at least 1), as the JAX package does."""
    label = label.long()
    loss = _tF.cross_entropy(input, label, ignore_index=ignore_index,
                             reduction="none")
    if reduction == "none":
        return loss
    total = loss.sum()
    if reduction == "sum":
        return total
    if reduction != "mean":
        raise ValueError(f"unknown reduction {reduction!r}")
    valid = (label != ignore_index).sum().clamp_min(1)
    return total / valid.to(total.dtype)
