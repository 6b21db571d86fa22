"""Functional ops of the serving and training paths (counterpart of
``paddle_tpu/nn/functional.py``).

``rms_norm`` and ``scaled_dot_product_attention`` run through autograd
Functions whose forward and backward are the Hopper kernels for CUDA
tensors and their plain versions for CPU tensors. With grad mode off (the
serving path) they call the forward directly: the Function would record
nothing, and its dispatch costs host time on every decode step. Nothing
here falls back from a kernel to a plain path on the card:
``scaled_dot_product_attention`` chooses the flash kernel or the dense path
from the call's shapes, types and mask alone, by the JAX package's routing
and what the kernel takes.

Randomness comes from explicit generators: ``dropout`` draws its mask from
a generator on the tensor's device, and attention dropout draws one int32
seed per call from a CPU generator (no device sync) for the kernels' hash
mask, which the CPU plain versions and the card's kernels compute alike.
"""
from __future__ import annotations

import math
import warnings

import torch
import torch.nn.functional as _tF

from ..ops.hopper import (FlashAttentionFunction, RMSNormFunction,
                          flash_attention, keep_mask)
from ..ops.hopper import rms_norm as _rms_norm_fwd
from ..ops.hopper.flash_attention import HEAD_DIMS, dropout_scale

# the input types the flash kernels take on the card
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def linear(x, weight, bias=None):
    """y = x W^T (+ b); weight ``[out, in]``, PyTorch's layout (the JAX
    package keeps ``[in, out]``; ``models/convert.py`` transposes)."""
    return _tF.linear(x, weight, bias)


def embedding(ids, weight):
    return _tF.embedding(ids, weight)


def silu(x):
    return _tF.silu(x)


def gelu(x, approximate=False):
    """GELU; ``approximate=True`` is the tanh form (GPT-2's)."""
    return _tF.gelu(x, approximate="tanh" if approximate else "none")


def dropout(x, p=0.5, training=True, generator=None):
    """Upscale-in-train dropout, the JAX package's ``dropout`` default mode:
    ``x * mask / (1 - p)`` with a Bernoulli(1 - p) mask drawn from
    ``generator`` (one on x's device; default: that device's default
    generator)."""
    if not training or p == 0.0:
        return x
    if not 0.0 < p < 1.0:
        raise ValueError(f"dropout p must lie in [0, 1), got {p}")
    keep = 1.0 - p
    mask = torch.empty_like(x).bernoulli_(keep, generator=generator)
    return x * mask / keep


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the trailing ``normalized_shape`` dimensions, as the
    JAX package's ``layer_norm``: mean and variance in float32 for
    half-precision x, the normalised x rounded to x's type, then times the
    weight and plus the bias in that type."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    dims = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    xf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    mean = xf.mean(dims, keepdim=True)
    var = (xf - mean).square().mean(dims, keepdim=True)
    out = ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


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
    """Whether the flash route takes this call (the JAX package's
    ``_pallas_attention_eligible``): GQA-divisible heads, equal q and k
    lengths, and no mask or an additive one of exactly ``[b, 1 | hq, s,
    s]``; off the CPU also what the kernels take: a head dim in
    ``HEAD_DIMS`` and float32 or bfloat16 q and k of one type (the CPU's
    plain versions take any). Strided inputs are eligible: the caller
    copies them. Decided from shapes, types and the device type alone, so
    a call on the ``meta`` device shows the card's decision. Warns once per
    reason when it does not take the call."""
    b, sq, hq, d = query.shape
    hkv = key.shape[2]
    on_kernel = query.device.type != "cpu"
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
    elif on_kernel and d not in HEAD_DIMS:
        reason = f"head_dim {d} not in the kernel's {HEAD_DIMS}"
    elif on_kernel and (query.dtype not in _KERNEL_DTYPES
                        or key.dtype != query.dtype):
        reason = (f"{query.dtype}/{key.dtype} inputs (the kernel takes "
                  "float32 or bfloat16 of one type)")
    else:
        return True
    _note_dense_route(reason)
    return False


def _dense_attention(query, key, value, attn_mask, is_causal,
                     dropout_p=0.0, seed=0):
    """The JAX package's ``_sdpa_op``: scores in the input type, a causal
    or bool mask filled with the type's minimum, an additive mask added,
    softmax in float32 cast back, [B, S, H, D] in and out. Dropout keeps
    the flash route's hash mask (:func:`keep_mask`), so both routes drop
    the same entries."""
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
    if dropout_p > 0.0:
        b, h, sq, sk = probs.shape
        keep = keep_mask(b, h, sq, seed, dropout_p, probs.device, sk)
        probs = torch.where(keep, probs * dropout_scale(dropout_p), 0.0)
    return (probs @ v).transpose(1, 2)


def draw_seed(generator=None) -> int:
    """One int32 seed for the attention kernels' dropout mask, drawn from a
    CPU generator (default: ``torch.default_generator``) without touching
    the card."""
    gen = torch.default_generator if generator is None else generator
    return int(torch.randint(-2 ** 31, 2 ** 31, (), generator=gen))


def _kernel_layout(t):
    """t when it is contiguous with 16-byte aligned data, as the kernels
    take it, else a contiguous copy (the JAX entry copies into its head-major
    layout too, ``to_bh``)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """Attention over [B, S, H, D] with the JAX package's signature and
    routing. The flash kernel takes GQA natively, equal q/k lengths and no
    mask or an additive ``[b, 1 | hq, s, s]`` one (float32 or q's type;
    another float type is cast to float32), applied with ``is_causal``
    when both are given; it is differentiable through the flash backward
    kernels on the card and their plain versions on the CPU. Strided q, k
    and v are copied to the kernels' layout. A bool mask, a broadcast mask
    shape, ``sq != sk``, or on the card a head dim or type the kernel does
    not take goes to the dense path, with a one-time warning.

    With ``training`` and ``dropout_p`` in (0, 1) one int32 seed is drawn
    per call from ``generator`` (a CPU generator; default
    ``torch.default_generator``), and both routes drop P's entries by the
    kernels' hash mask of that seed."""
    drop = float(dropout_p) if training else 0.0
    seed = 0
    if drop > 0.0:
        if drop >= 1.0:
            raise ValueError(f"dropout_p must lie in [0, 1), got {drop}")
        seed = draw_seed(generator)
    if not flash_eligible(query, key, attn_mask):
        return _dense_attention(query, key, value, attn_mask, is_causal,
                                drop, seed)
    query, key, value = (_kernel_layout(t) for t in (query, key, value))
    if attn_mask is not None:
        if attn_mask.dtype not in (torch.float32, query.dtype):
            attn_mask = attn_mask.float()
        attn_mask = attn_mask.contiguous()
    if not torch.is_grad_enabled():
        return flash_attention(query, key, value, is_causal, attn_mask, drop,
                               seed)[0]
    return FlashAttentionFunction.apply(query, key, value, is_causal,
                                        attn_mask, drop, seed)[0]


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
