"""Flash attention forward: the hand-written Hopper kernel and its plain
version.

Counterpart: ``paddle_tpu/ops/pallas/flash_attention.py`` (``_fwd_kernel``
through ``_fwd_call`` and ``flash_attention_pallas``). The kernel is
``csrc/flash_attention.cu``. The public layout stays ``[b, s, h, d]``, GQA
is native (k/v carry ``hkv`` heads with ``hq % hkv == 0``), and the outputs
are O and the float32 log-sum-exp ``[b, hq, s]``. The additive mask,
``kv_seqlens``, dropout and the two backward kernels are not ported yet.
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
_SIGNATURES = {"flash_attention_fwd": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ctypes.c_void_p]}


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


def flash_attention_plain(q, k, v, causal: bool = True):
    """Dense attention in float32 with the kernel's semantics: scores from
    q * (1/sqrt(d)), masked with -1e30, O = softmax . V cast to q's type,
    LSE = m + log(max(l, 1e-20)) as float32 ``[b, hq, s]``."""
    _check_shapes(q, k, v)
    b, s, hq, d = q.shape
    group = hq // k.shape[2]
    scale = 1.0 / math.sqrt(d)
    qf = q.float().transpose(1, 2) * scale                # [b, hq, s, d]
    kf = k.float().transpose(1, 2).repeat_interleave(group, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(group, dim=1)
    scores = qf @ kf.transpose(-1, -2)
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, NEG_INF)
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-20)
    out = (p @ vf) / l
    lse = (m + torch.log(l)).squeeze(-1)
    return out.transpose(1, 2).to(q.dtype).contiguous(), lse


def flash_attention(q, k, v, causal: bool = True):
    """Blockwise flash attention forward: ``(out [b, s, hq, d],
    lse [b, hq, s] float32)``.

    A CPU tensor takes :func:`flash_attention_plain`. A CUDA tensor
    launches the kernel on the current stream or raises: float32 or
    bfloat16, head dim 64 or 128, contiguous inputs with 16-byte aligned
    data, equal q and k lengths.
    """
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if q.device.type != "cuda" or not (k.device == v.device == q.device):
        raise ValueError("flash_attention: q, k, v must be on one CUDA "
                         f"device (got {q.device}, {k.device}, {v.device})")
    if q.dtype not in _DTYPE_CODES or not (k.dtype == v.dtype == q.dtype):
        raise TypeError("flash_attention: kernel takes float32 or bfloat16 "
                        f"of one type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             "with 16-byte aligned data")
    if -(-s // _BLOCK_Q) > 65535:
        raise ValueError(f"flash_attention: sequence length {s} too long")
    if not on_hopper(q.device):
        raise RuntimeError("flash_attention: the kernel is built for Hopper "
                           "(sm_90a) only")
    out = torch.empty_like(q)
    lse = torch.empty(b, hq, s, dtype=torch.float32, device=q.device)
    if b == 0 or s == 0:
        return out, lse
    lib = _build.load("flash_attention", _SIGNATURES)
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, s, hq, hkv, d, int(causal),
        1.0 / math.sqrt(d), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attention_fwd")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0
