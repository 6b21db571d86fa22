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
mask, as ``_tile_scores`` does, and gets no gradient.

Dropout on the attention probabilities (``dropout_p``, ``seed``) keeps an
entry where a murmur3-finalizer hash of its absolute (row, column), its
``batch * hq + q_head`` index and the seed is at least ``p * 2^32``: the
JAX package's ``_keep_mask`` on its interpret path, bit for bit
(:func:`keep_mask`). Kept entries of P are scaled by ``1 / (1 - p)`` (a
float32 constant) before P V; the row sum and LSE stay those of the
undropped P, and the backward kernels draw the same mask from the same
seed. ``kv_seqlens`` is not ported yet.
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
_U = ctypes.c_uint
_F = ctypes.c_float
# every entry ends with the dropout arguments (flag, threshold, scale, seed)
# and the stream
_DROP = [_I, _U, _F, _U, _P]
_SIGNATURES = {"flash_attention_fwd": [
    _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I] + _DROP}
_BWD_SIGNATURES = {
    "flash_attention_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _I, _F, _I, _I] + _DROP,
    "flash_attention_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                _I, _I, _I, _I, _I, _F, _I, _I] + _DROP,
}

# the keep mask's hash (paddle_tpu/ops/pallas/flash_attention.py
# _keep_mask, interpret path): multipliers of the row, column, batch * hq +
# q_head and seed, then murmur3's finalizer
_ROW_MUL, _COL_MUL, _BH_MUL, _SEED_MUL = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35,
                                          0x27D4EB2F)
_M32 = 0xFFFFFFFF


def dropout_threshold(dropout_p: float) -> int:
    """The keep mask's threshold: an entry is kept where its hash is at
    least ``min(int(p * 2^32), 2^32 - 1)``, computed as Python computes it
    (the JAX package's ``_keep_mask``)."""
    return min(int(dropout_p * (2 ** 32)), 2 ** 32 - 1)


def dropout_scale(dropout_p: float) -> float:
    """``1 / (1 - p)`` rounded to float32, the factor of a kept entry (the
    JAX kernels multiply float32 P by the Python float)."""
    return torch.tensor(1.0 / (1.0 - dropout_p), dtype=torch.float32).item()


def _check_dropout(dropout_p, seed):
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must lie in [0, 1), got {dropout_p}")
    if not isinstance(seed, int):
        raise TypeError(f"seed must be a Python int, got {type(seed)}")


def _mul32(x, c: int):
    """``(x * c) mod 2^32`` for int64 ``x`` in [0, 2^32) and a 32-bit
    constant, in two halves so no product exceeds 2^49 (torch has no
    uint32 multiply on the CPU, and int64 products of two 32-bit values
    can overflow)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def keep_mask(b: int, hq: int, s: int, seed: int, dropout_p: float,
              device="cpu", sk=None):
    """The dropout keep mask ``[b, hq, s, sk]`` (bool; sk defaults to s):
    for row r, column c, bh = batch * hq + q_head and the int32 seed
    wrapped to uint32, x = r C1 ^ c C2 ^ bh C3 ^ seed C4 in uint32, then
    murmur3's finalizer (>> 16, * 0x85EBCA6B, >> 13, * 0xC2B2AE35, >> 16),
    kept where x >= :func:`dropout_threshold`. The same bits as the JAX
    package's ``_keep_mask`` on its interpret path and as the kernels'
    hash, computed in int64 masked to 32 bits."""
    sk = s if sk is None else sk
    i64 = dict(dtype=torch.int64, device=device)
    rows = _mul32(torch.arange(s, **i64), _ROW_MUL)
    cols = _mul32(torch.arange(sk, **i64), _COL_MUL)
    seed_mix = ((seed & _M32) * _SEED_MUL) & _M32
    bh = _mul32(torch.arange(b * hq, **i64), _BH_MUL) ^ seed_mix
    x = bh[:, None, None] ^ rows[None, :, None] ^ cols[None, None, :]
    x ^= x >> 16
    x = _mul32(x, 0x85EBCA6B)
    x ^= x >> 13
    x = _mul32(x, 0xC2B2AE35)
    x ^= x >> 16
    return (x >= dropout_threshold(dropout_p)).reshape(b, hq, s, sk)


def _dropout_args(dropout_p, seed):
    """(flag, threshold, scale, seed as uint32) for the C entry points."""
    if dropout_p == 0.0:
        return 0, 0, 1.0, 0
    return (1, dropout_threshold(dropout_p), dropout_scale(dropout_p),
            seed & _M32)


def _count(fn, dropout_p):
    """Add one to the wrapper's counter of this launch's build."""
    if dropout_p > 0.0:
        fn.dropout_launches += 1
    else:
        fn.launches += 1


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


def _dropped(x, keep, dropout_p):
    """x where kept, times the float32 ``1 / (1 - p)``; 0 where dropped."""
    return torch.where(keep, x * dropout_scale(dropout_p), 0.0)


def flash_attention_plain(q, k, v, causal: bool = True, attn_mask=None,
                          dropout_p: float = 0.0, seed: int = 0):
    """Dense attention in float32 with the kernel's semantics: scores from
    q * (1/sqrt(d)) plus the additive mask, masked with -1e30 where causal
    hides a key, O = softmax . V cast to q's type, LSE = m + log(max(l,
    1e-20)) as float32 ``[b, hq, s]``. A row that an additive mask hides
    entirely (-1e9 everywhere) comes out uniform, as the TPU kernel's
    does. With ``dropout_p`` the P that multiplies V keeps the entries of
    :func:`keep_mask` scaled by ``1 / (1 - p)``; l and LSE are the
    undropped P's."""
    _check_shapes(q, k, v)
    _check_mask(q, attn_mask)
    _check_dropout(dropout_p, seed)
    scores, _, _, vf = _dense(q, k, v, causal, attn_mask)
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-20)
    if dropout_p > 0.0:
        b, s, hq = q.shape[:3]
        p = _dropped(p, keep_mask(b, hq, s, seed, dropout_p, q.device),
                     dropout_p)
    out = (p @ vf) / l
    lse = (m + torch.log(l)).squeeze(-1)
    return out.transpose(1, 2).to(q.dtype).contiguous(), lse


def flash_attention(q, k, v, causal: bool = True, attn_mask=None,
                    dropout_p: float = 0.0, seed: int = 0):
    """Blockwise flash attention forward: ``(out [b, s, hq, d],
    lse [b, hq, s] float32)``, with no autograd history
    (``nn.functional.scaled_dot_product_attention`` wraps this in
    :class:`FlashAttentionFunction`). ``attn_mask`` is None or an additive
    ``[b, 1 | hq, s, s]``, applied with ``causal`` when both are given;
    ``dropout_p`` in [0, 1) with an int ``seed`` drops P's entries by
    :func:`keep_mask`.

    A CPU tensor takes :func:`flash_attention_plain`. A CUDA tensor
    launches the kernel on the current stream or raises: float32 or
    bfloat16, head dim 64 or 128, contiguous inputs with 16-byte aligned
    data, equal q and k lengths, a float32 mask or one of q's type. With
    ``dropout_p > 0`` it launches the dropout build and counts it in
    ``flash_attention.dropout_launches`` (else ``launches``).
    """
    _check_shapes(q, k, v)
    _check_mask(q, attn_mask)
    _check_dropout(dropout_p, seed)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, attn_mask, dropout_p,
                                     seed)
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
        *_dropout_args(dropout_p, seed),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attention_fwd")
    _count(flash_attention, dropout_p)
    return out, lse


flash_attention.launches = 0
flash_attention.dropout_launches = 0


def _delta(out, dout):
    """delta = rowsum(dO * O) in float32, ``[b, hq, s]`` (the JAX package
    computes it in XLA outside the kernels, ``_bwd_call``). With dropout O
    is the dropped output, as there."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, out, dout, lse, causal: bool = True,
                              attn_mask=None, dropout_p: float = 0.0,
                              seed: int = 0):
    """The backward kernels' math, dense in float32: P = exp(S - lse) from
    the forward's LSE (S with the forward's additive mask), dS = P (dO V^T
    - rowsum(dO O)), dQ = dS K scale, dK = dS^T Q scale and dV = P^T dO
    summed over each GQA group. With ``dropout_p`` the forward's keep mask
    drops and scales dO V^T before dS and the P of dV, as ``_bwd_dq_kernel``
    and ``_bwd_dkv_kernel`` do. Returns ``(dq, dk, dv)`` in q's and k's
    types."""
    _check_shapes(q, k, v)
    _check_mask(q, attn_mask)
    _check_dropout(dropout_p, seed)
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    scores, qf, kf, vf = _dense(q, k, v, causal, attn_mask)
    # masked scores are -1e30, so their probabilities come out exactly 0
    p = torch.exp(scores - lse.unsqueeze(-1))
    dof = dout.float().transpose(1, 2)
    dp = dof @ vf.transpose(-1, -2)
    p_v = p
    if dropout_p > 0.0:
        keep = keep_mask(b, hq, s, seed, dropout_p, q.device)
        dp = _dropped(dp, keep, dropout_p)
        p_v = _dropped(p, keep, dropout_p)
    ds = p * (dp - _delta(out, dout).unsqueeze(-1))
    scale = 1.0 / math.sqrt(d)
    dq = (ds @ kf) * scale
    dk = ds.transpose(-1, -2) @ qf           # qf carries the scale
    dv = p_v.transpose(-1, -2) @ dof

    def per_kv_head(x):                      # [b, hq, s, d] -> [b, s, hkv, d]
        return x.reshape(b, hkv, group, s, d).sum(2).transpose(1, 2)

    return (dq.transpose(1, 2).to(q.dtype).contiguous(),
            per_kv_head(dk).to(k.dtype).contiguous(),
            per_kv_head(dv).to(v.dtype).contiguous())


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal: bool = True,
                           attn_mask=None, dropout_p: float = 0.0,
                           seed: int = 0):
    """Launch the dQ kernel (CUDA tensors only; see
    :func:`flash_attention_bwd`). Returns dq in q's type."""
    _check_dropout(dropout_p, seed)
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
        _DTYPE_CODES[q.dtype], mask_code, *_dropout_args(dropout_p, seed),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attention_bwd_dq")
    _count(flash_attention_bwd_dq, dropout_p)
    return dq


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.dropout_launches = 0


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal: bool = True,
                            attn_mask=None, dropout_p: float = 0.0,
                            seed: int = 0):
    """Launch the dK/dV kernel (CUDA tensors only; see
    :func:`flash_attention_bwd`). Returns ``(dk, dv)`` in k's type, already
    summed over each GQA group."""
    _check_dropout(dropout_p, seed)
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
        *_dropout_args(dropout_p, seed),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attention_bwd_dkv")
    _count(flash_attention_bwd_dkv, dropout_p)
    return dk, dv


flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.dropout_launches = 0


def flash_attention_bwd(q, k, v, out, dout, lse, causal: bool = True,
                        attn_mask=None, dropout_p: float = 0.0,
                        seed: int = 0):
    """Flash attention backward: ``(dq, dk, dv)`` from the forward's inputs
    (the mask, dropout rate and seed included), its output and LSE, and the
    output gradient ``dout`` (q's type and shape, contiguous on the card).

    A CPU tensor takes :func:`flash_attention_bwd_plain`. A CUDA tensor
    computes delta = rowsum(dO * O) with PyTorch ops, then launches the dQ
    and the dK/dV kernels on the current stream, or raises.
    """
    _check_shapes(q, k, v)
    _check_mask(q, attn_mask)
    _check_dropout(dropout_p, seed)
    if out.shape != q.shape or dout.shape != q.shape or \
            lse.shape != (q.shape[0], q.shape[2], q.shape[1]):
        raise ValueError("flash_attention_bwd: out and dout [b, s, hq, d] "
                         "and lse [b, hq, s] expected, got "
                         f"{tuple(out.shape)}, {tuple(dout.shape)}, "
                         f"{tuple(lse.shape)}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, dout, lse, causal,
                                         attn_mask, dropout_p, seed)
    if dout.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError("flash_attention_bwd: dout of q's type and float32 "
                        f"lse expected, got {dout.dtype}, {lse.dtype}")
    if q.shape[0] == 0 or q.shape[1] == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    delta = _delta(out, dout)
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal, attn_mask,
                                dropout_p, seed)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal,
                                     attn_mask, dropout_p, seed)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with its backward kernels: saves ``(q, k, v, out,
    lse)`` and the mask, the residuals of the JAX package's ``_flash_fwd``,
    and hands the forward's dropout rate and seed to the backward (the
    seed residual of ``_flash_drop_fwd``), so both draw one mask.
    Returns ``(out, lse)``; lse is not differentiable, and the mask's
    gradient is zeros, as the JAX package's ``_flash_bwd`` gives it."""

    @staticmethod
    def forward(ctx, q, k, v, causal, attn_mask=None, dropout_p=0.0,
                seed=0):
        out, lse = flash_attention(q, k, v, causal, attn_mask, dropout_p,
                                   seed)
        masks = () if attn_mask is None else (attn_mask,)
        ctx.save_for_backward(q, k, v, out, lse, *masks)
        ctx.causal = causal
        ctx.dropout = (dropout_p, seed)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse, *masks = ctx.saved_tensors
        attn_mask = masks[0] if masks else None
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(),
                                         lse, ctx.causal, attn_mask,
                                         *ctx.dropout)
        dmask = None
        if attn_mask is not None and ctx.needs_input_grad[4]:
            dmask = torch.zeros_like(attn_mask)
        return dq, dk, dv, None, dmask, None, None
