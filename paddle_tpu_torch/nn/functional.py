"""Functional ops of the serving and training paths (counterpart of
``paddle_tpu/nn/functional.py``).

``rms_norm`` and ``scaled_dot_product_attention`` run through autograd
Functions whose forward and backward are the Hopper kernels for CUDA
tensors and their plain versions for CPU tensors. With grad mode off (the
serving path) they call the forward directly: the Function would record
nothing, and its dispatch costs host time on every decode step. Nothing
here falls back from a kernel to a plain path on the card:
``scaled_dot_product_attention`` chooses the flash kernel or the dense path
from the call's shapes and mask alone, by the JAX package's routing.
"""
from __future__ import annotations

import math
import warnings

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


_DENSE_ROUTE_SEEN: set = set()


def _note_dense_route(reason: str) -> None:
    """Warn once per reason that attention takes the dense path."""
    if reason not in _DENSE_ROUTE_SEEN:
        _DENSE_ROUTE_SEEN.add(reason)
        warnings.warn("scaled_dot_product_attention: dense attention instead "
                      f"of the flash kernel ({reason})", stacklevel=3)


def flash_eligible(query, key, attn_mask) -> bool:
    """Whether the flash kernel takes this call (the JAX package's
    ``_pallas_attention_eligible``): GQA-divisible heads, equal q and k
    lengths, and no mask or an additive one of exactly ``[b, 1 | hq, s,
    s]``. Warns once per reason when it does not."""
    b, sq, hq = query.shape[:3]
    hkv = key.shape[2]
    if hq % hkv:
        reason = f"head counts {hq}/{hkv} not GQA-divisible"
    elif sq != key.shape[1]:
        reason = "cross-attention / kv-cache shapes"
    elif attn_mask is not None and (
            attn_mask.dim() != 4
            or tuple(attn_mask.shape) != (b, attn_mask.shape[1], sq, sq)
            or attn_mask.shape[1] not in (1, hq)
            or not attn_mask.is_floating_point()):
        # exact [b, 1|h, sq, sk] only: the kernels index the mask by tile
        reason = "attn_mask must be additive [b,1|h,sq,sk] for the kernel"
    else:
        return True
    _note_dense_route(reason)
    return False


def _dense_attention(query, key, value, attn_mask, is_causal):
    """The JAX package's ``_sdpa_op``: scores in the input type, a causal
    or bool mask filled with the type's minimum, an additive mask added,
    softmax in float32 cast back, [B, S, H, D] in and out."""
    q, k, v = (t.transpose(1, 2) for t in (query, key, value))
    scores = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    if is_causal:
        sq, sk = scores.shape[-2:]
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=scores.device).tril(sk - sq)
        scores = scores.masked_fill(~keep, torch.finfo(scores.dtype).min)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = scores.masked_fill(~attn_mask,
                                        torch.finfo(scores.dtype).min)
        else:
            scores = scores + attn_mask
    probs = torch.softmax(scores.float(), dim=-1).to(query.dtype)
    return (probs @ v).transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """Attention over [B, S, H, D] with the JAX package's signature and
    routing. The flash kernel takes GQA natively, equal q/k lengths and no
    mask or an additive ``[b, 1 | hq, s, s]`` one (float32 or q's type;
    another float type is cast to float32), applied with ``is_causal``
    when both are given; it is differentiable through the flash backward
    kernels on the card and their plain versions on the CPU. A bool mask,
    a broadcast mask shape or ``sq != sk`` takes the dense path, with a
    one-time warning. Dropout is not ported: ``dropout_p > 0`` with
    ``training`` raises."""
    if training and dropout_p > 0.0:
        raise NotImplementedError("scaled_dot_product_attention: dropout is "
                                  "not ported yet")
    if not flash_eligible(query, key, attn_mask):
        return _dense_attention(query, key, value, attn_mask, is_causal)
    if attn_mask is not None:
        if attn_mask.dtype not in (torch.float32, query.dtype):
            attn_mask = attn_mask.float()
        attn_mask = attn_mask.contiguous()
    if not torch.is_grad_enabled():
        return flash_attention(query, key, value, is_causal, attn_mask)[0]
    return FlashAttentionFunction.apply(query, key, value, is_causal,
                                        attn_mask)[0]


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
