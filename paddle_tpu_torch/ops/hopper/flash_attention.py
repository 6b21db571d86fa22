"""Flash attention forward and backward: the hand-written Hopper kernels and
their plain versions.

Counterpart: ``paddle_tpu/ops/pallas/flash_attention.py`` (``_fwd_kernel``
through ``_fwd_call``; ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` through
``_bwd_call``; the ``_flash`` custom vjp). The kernels are
``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``; forward
and backward, bfloat16 takes the tensor-core (wgmma, TMA) builds and
float32 the float32 FMA builds. The public
layout stays ``[b, s, h, d]``, GQA is native (k/v carry ``hkv`` heads with
``hq % hkv == 0``), and the forward's outputs are O and the float32
log-sum-exp ``[b, hq, s]``. An optional additive mask ``[b, 1 | hq, s, s]``
(float32 or q's type) is added to the scaled scores before the causal
mask, as ``_tile_scores`` does, and gets no gradient. ``kv_seqlens`` and
dropout are not ported yet.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ...device import on_hopper
from . import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
_BLOCK_Q = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the mask's type code (csrc/flash_common.cuh MaskCode)
_MASK_CODES = {torch.float32: 1, torch.bfloat16: 2}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {"flash_attention_fwd": [
    _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P]}
_BWD_SIGNATURES = {
    "flash_attention_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _I, _F, _I, _I, _P],
    "flash_attention_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                _I, _I, _I, _I, _I, _F, _I, _I, _P],
}


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError("flash_attention: q [b, s, hq, d] and k, v "
                         "[b, s, hkv, d] expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, hq, d = q.shape
    bk, sk, hkv, dk = k.shape
    if (bk, dk) != (b, d):
        raise ValueError("flash_attention: q and k/v disagree in batch or "
                         f"head dim: {tuple(q.shape)} vs {tuple(k.shape)}")
    if sk != s:
        raise ValueError("flash_attention: q and k sequence lengths differ "
                         f"({s} vs {sk}); cross-attention is not supported")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"GQA needs hq % hkv == 0, got {hq}/{hkv}")


def _check_mask(q, attn_mask):
    """Raise unless ``attn_mask`` is None or an additive float mask
    ``[b, 1 | hq, s, s]``."""
    if attn_mask is None:
        return
    b, s, hq, _ = q.shape
    if attn_mask.dim() != 4 or attn_mask.shape[1] not in (1, hq) or \
            tuple(attn_mask.shape) != (b, attn_mask.shape[1], s, s):
        raise ValueError("flash_attention: attn_mask [b, 1 | hq, s, s] = "
                         f"[{b}, 1 | {hq}, {s}, {s}] expected, got "
                         f"{tuple(attn_mask.shape)}")
    if not attn_mask.is_floating_point():
        raise TypeError("flash_attention: the mask is additive; got "
                        f"{attn_mask.dtype}")


def _mask_args(q, attn_mask):
    """(pointer, heads, type code) of the mask for the C entry points."""
    if attn_mask is None:
        return None, 1, 0
    if attn_mask.dtype not in (torch.float32, q.dtype):
        raise TypeError("flash_attention: the kernels take a float32 mask or "
                        f"one of q's type ({q.dtype}), got {attn_mask.dtype}")
    return (attn_mask.data_ptr(), attn_mask.shape[1],
            _MASK_CODES[attn_mask.dtype])


def _check_card(what, q, k, v, *more):
    """Raise unless the kernels can take these tensors (``more`` may hold
    None for an absent mask); returns nothing."""
    b, s, hq, d = q.shape
    more = tuple(t for t in more if t is not None)
    tensors = (q, k, v) + more
    if q.device.type != "cuda" or any(t.device != q.device
                                      for t in tensors):
        raise ValueError(f"{what}: tensors must be on one CUDA device (got "
                         f"{[str(t.device) for t in tensors]})")
    if q.dtype not in _DTYPE_CODES or not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"{what}: kernel takes float32 or bfloat16 of one "
                        f"type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {d} not in {HEAD_DIMS}")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: inputs must be contiguous with "
                             "16-byte aligned data")
    if -(-s // _BLOCK_Q) > 65535:
        raise ValueError(f"{what}: sequence length {s} too long")
    if not on_hopper(q.device):
        raise RuntimeError(f"{what}: the kernel is built for Hopper "
                           "(sm_90a) only")


def _dense(q, k, v, causal, attn_mask=None):
    """The kernels' scores in float32, dense: ``(scores [b, hq, s, s],
    q * (1/sqrt(d)), k, v)``, the last three head-major ``[b, hq, s, d]``
    with k and v repeated over each GQA group, the additive mask added in
    float32, and the scores masked with -1e30 where ``causal`` hides a
    key."""
    s, hq, d = q.shape[1:]
    group = hq // k.shape[2]
    qf = q.float().transpose(1, 2) * (1.0 / math.sqrt(d))
    kf, vf = (t.float().transpose(1, 2).repeat_interleave(group, dim=1)
              for t in (k, v))
    scores = qf @ kf.transpose(-1, -2)
    if attn_mask is not None:
        scores = scores + attn_mask.float()
    if causal:
        hidden = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
        scores = scores.masked_fill(hidden, NEG_INF)
    return scores, qf, kf, vf


def flash_attention_plain(q, k, v, causal: bool = True, attn_mask=None):
    """Dense attention in float32 with the kernel's semantics: scores from
    q * (1/sqrt(d)) plus the additive mask, masked with -1e30 where causal
    hides a key, O = softmax . V cast to q's type, LSE = m + log(max(l,
    1e-20)) as float32 ``[b, hq, s]``. A row that an additive mask hides
    entirely (-1e9 everywhere) comes out uniform, as the TPU kernel's
    does."""
    _check_shapes(q, k, v)
    _check_mask(q, attn_mask)
    scores, _, _, vf = _dense(q, k, v, causal, attn_mask)
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-20)
    out = (p @ vf) / l
    lse = (m + torch.log(l)).squeeze(-1)
    return out.transpose(1, 2).to(q.dtype).contiguous(), lse


def flash_attention(q, k, v, causal: bool = True, attn_mask=None):
    """Blockwise flash attention forward: ``(out [b, s, hq, d],
    lse [b, hq, s] float32)``, with no autograd history
    (``nn.functional.scaled_dot_product_attention`` wraps this in
    :class:`FlashAttentionFunction`). ``attn_mask`` is None or an additive
    ``[b, 1 | hq, s, s]``, applied with ``causal`` when both are given.

    A CPU tensor takes :func:`flash_attention_plain`. A CUDA tensor
    launches the kernel on the current stream or raises: float32 or
    bfloat16, head dim 64 or 128, contiguous inputs with 16-byte aligned
    data, equal q and k lengths, a float32 mask or one of q's type.
    """
    _check_shapes(q, k, v)
    _check_mask(q, attn_mask)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, attn_mask)
    _check_card("flash_attention", q, k, v, attn_mask)
    b, s, hq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, hq, s, dtype=torch.float32, device=q.device)
    if b == 0 or s == 0:
        return out, lse
    mask_ptr, mask_heads, mask_code = _mask_args(q, attn_mask)
    lib = _build.load("flash_attention", _SIGNATURES)
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
        lse.data_ptr(), b, s, hq, k.shape[2], mask_heads, d, int(causal),
        1.0 / math.sqrt(d), _DTYPE_CODES[q.dtype], mask_code,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attention_fwd")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0


def _delta(out, dout):
    """delta = rowsum(dO * O) in float32, ``[b, hq, s]`` (the JAX package
    computes it in XLA outside the kernels, ``_bwd_call``)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, out, dout, lse, causal: bool = True,
                              attn_mask=None):
    """The backward kernels' math, dense in float32: P = exp(S - lse) from
    the forward's LSE (S with the forward's additive mask), dS = P (dO V^T
    - rowsum(dO O)), dQ = dS K scale, dK = dS^T Q scale and dV = P^T dO
    summed over each GQA group. Returns ``(dq, dk, dv)`` in q's and k's
    types."""
    _check_shapes(q, k, v)
    _check_mask(q, attn_mask)
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    scores, qf, kf, vf = _dense(q, k, v, causal, attn_mask)
    # masked scores are -1e30, so their probabilities come out exactly 0
    p = torch.exp(scores - lse.unsqueeze(-1))
    dof = dout.float().transpose(1, 2)
    dp = dof @ vf.transpose(-1, -2)
    ds = p * (dp - _delta(out, dout).unsqueeze(-1))
    scale = 1.0 / math.sqrt(d)
    dq = (ds @ kf) * scale
    dk = ds.transpose(-1, -2) @ qf           # qf carries the scale
    dv = p.transpose(-1, -2) @ dof

    def per_kv_head(x):                      # [b, hq, s, d] -> [b, s, hkv, d]
        return x.reshape(b, hkv, group, s, d).sum(2).transpose(1, 2)

    return (dq.transpose(1, 2).to(q.dtype).contiguous(),
            per_kv_head(dk).to(k.dtype).contiguous(),
            per_kv_head(dv).to(v.dtype).contiguous())


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal: bool = True,
                           attn_mask=None):
    """Launch the dQ kernel (CUDA tensors only; see
    :func:`flash_attention_bwd`). Returns dq in q's type."""
    _check_card("flash_attention_bwd_dq", q, k, v, dout, lse, delta,
                attn_mask)
    b, s, hq, d = q.shape
    dq = torch.empty_like(q)
    mask_ptr, mask_heads, mask_code = _mask_args(q, attn_mask)
    lib = _build.load("flash_attention_bwd", _BWD_SIGNATURES)
    err = lib.flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), mask_ptr, dq.data_ptr(), b, s, hq,
        k.shape[2], mask_heads, d, int(causal), 1.0 / math.sqrt(d),
        _DTYPE_CODES[q.dtype], mask_code,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal: bool = True,
                            attn_mask=None):
    """Launch the dK/dV kernel (CUDA tensors only; see
    :func:`flash_attention_bwd`). Returns ``(dk, dv)`` in k's type, already
    summed over each GQA group."""
    _check_card("flash_attention_bwd_dkv", q, k, v, dout, lse, delta,
                attn_mask)
    b, s, hq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    mask_ptr, mask_heads, mask_code = _mask_args(q, attn_mask)
    lib = _build.load("flash_attention_bwd", _BWD_SIGNATURES)
    err = lib.flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), mask_ptr, dk.data_ptr(),
        dv.data_ptr(), b, s, hq, k.shape[2], mask_heads, d, int(causal),
        1.0 / math.sqrt(d), _DTYPE_CODES[q.dtype], mask_code,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, out, dout, lse, causal: bool = True,
                        attn_mask=None):
    """Flash attention backward: ``(dq, dk, dv)`` from the forward's inputs
    (the mask included), its output and LSE, and the output gradient
    ``dout`` (q's type and shape, contiguous on the card).

    A CPU tensor takes :func:`flash_attention_bwd_plain`. A CUDA tensor
    computes delta = rowsum(dO * O) with PyTorch ops, then launches the dQ
    and the dK/dV kernels on the current stream, or raises.
    """
    _check_shapes(q, k, v)
    _check_mask(q, attn_mask)
    if out.shape != q.shape or dout.shape != q.shape or \
            lse.shape != (q.shape[0], q.shape[2], q.shape[1]):
        raise ValueError("flash_attention_bwd: out and dout [b, s, hq, d] "
                         "and lse [b, hq, s] expected, got "
                         f"{tuple(out.shape)}, {tuple(dout.shape)}, "
                         f"{tuple(lse.shape)}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, dout, lse, causal,
                                         attn_mask)
    if dout.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError("flash_attention_bwd: dout of q's type and float32 "
                        f"lse expected, got {dout.dtype}, {lse.dtype}")
    if q.shape[0] == 0 or q.shape[1] == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    delta = _delta(out, dout)
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal, attn_mask)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal,
                                     attn_mask)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with its backward kernels: saves ``(q, k, v, out,
    lse)`` and the mask, the residuals of the JAX package's ``_flash_fwd``.
    Returns ``(out, lse)``; lse is not differentiable, and the mask's
    gradient is zeros, as the JAX package's ``_flash_bwd`` gives it."""

    @staticmethod
    def forward(ctx, q, k, v, causal, attn_mask=None):
        out, lse = flash_attention(q, k, v, causal, attn_mask)
        masks = () if attn_mask is None else (attn_mask,)
        ctx.save_for_backward(q, k, v, out, lse, *masks)
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse, *masks = ctx.saved_tensors
        attn_mask = masks[0] if masks else None
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(),
                                         lse, ctx.causal, attn_mask)
        dmask = None
        if attn_mask is not None and ctx.needs_input_grad[4]:
            dmask = torch.zeros_like(attn_mask)
        return dq, dk, dv, None, dmask
