"""Block-sparse attention: the hand-written Hopper forward kernel, its plain
version, and the dense masked recompute that is its backward.

Counterpart: ``paddle_tpu/ops/pallas/block_sparse_attention.py``
(``_bs_fwd_kernel`` through ``_bs_fwd``; ``compress_block_mask``; the
``_bs`` custom vjp, whose backward is the dense masked path ``_dense_masked``
in XLA, not a Pallas kernel). The kernel is ``csrc/block_sparse_attention.cu``
(bfloat16: the tensor-core build; float32: the float32 FMA build).
The layout is ``[b, s, h, d]``; the pattern is a static ``[s / block_q,
s / block_k]`` tile mask, and a row with no active tile outputs exactly 0.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ...device import on_hopper
from . import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 128
_TILE = 64                   # the kernel's Q and K/V tile rows
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {"block_sparse_attention_fwd": [
    _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, *[_L] * 9,
    ctypes.c_float, _I, _P]}


def compress_block_mask(block_mask):
    """``[nq, nk]`` bool -> ``(kmap [nq, T] int32, counts [nq] int32)``:
    each row's active tile indices in ascending order, padded by repeating
    the last one (0 for an empty row), ``T`` the largest count (at least
    1)."""
    bm = np.asarray(block_mask) != 0
    nq = bm.shape[0]
    counts = bm.sum(axis=1).astype(np.int32)
    kmap = np.zeros((nq, max(int(counts.max(initial=0)), 1)), np.int32)
    for r in range(nq):
        idx = np.nonzero(bm[r])[0]
        if idx.size:
            kmap[r, :idx.size] = idx
            kmap[r, idx.size:] = idx[-1]
    return kmap, counts


def _check(q, k, v, block_mask, block_q, block_k):
    """Validate shapes as the JAX function does; returns the pattern as a
    bool numpy array."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("block_sparse_attention: q, k, v [b, s, h, d] of "
                         f"one shape expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    s = q.shape[1]
    if s % block_q or s % block_k:
        raise ValueError(f"seq {s} must divide blocks ({block_q},{block_k})")
    bm = np.asarray(block_mask.cpu() if isinstance(block_mask, torch.Tensor)
                    else block_mask) != 0
    if bm.shape != (s // block_q, s // block_k):
        raise ValueError(f"block_mask shape {bm.shape} != "
                         f"{(s // block_q, s // block_k)}")
    return bm


def _element_mask(bm, block_q, block_k, device):
    """The tile pattern expanded to ``[s, s]`` bool on ``device``."""
    t = torch.from_numpy(bm).to(device)
    return t.repeat_interleave(block_q, 0).repeat_interleave(block_k, 1)


def block_sparse_attention_plain(q, k, v, block_mask, block_q=128,
                                 block_k=128):
    """Dense attention in float32 under the expanded tile mask, with the
    kernel's math: scores from q * (1/sqrt(d)), masked scores contribute
    nothing, O = acc / max(l, 1e-20) rounded once to q's type, so a row
    with no active tile is exactly 0."""
    bm = _check(q, k, v, block_mask, block_q, block_k)
    d = q.shape[-1]
    elem = _element_mask(bm, block_q, block_k, q.device)
    qf = q.float().transpose(1, 2) * (1.0 / math.sqrt(d))
    kf, vf = (t.float().transpose(1, 2) for t in (k, v))
    scores = (qf @ kf.transpose(-1, -2)).masked_fill(~elem, NEG_INF)
    m = scores.amax(-1, keepdim=True)
    p = torch.where(elem, torch.exp(scores - m), 0.0)
    out = (p @ vf) / p.sum(-1, keepdim=True).clamp_min(1e-20)
    return out.transpose(1, 2).to(q.dtype)


def _check_card(q, k, v, block_q, block_k):
    d = q.shape[-1]
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("block_sparse_attention: q, k, v must lie on one "
                         "CUDA device")
    if q.dtype not in _DTYPE_CODES or not (k.dtype == v.dtype == q.dtype):
        raise TypeError("block_sparse_attention: kernel takes float32 or "
                        f"bfloat16 of one type, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"block_sparse_attention: head dim {d} must be a "
                         f"multiple of 8 up to {MAX_HEAD_DIM}")
    if block_q % _TILE or block_k % _TILE:
        raise ValueError("block_sparse_attention: the kernel takes blocks "
                         f"that are multiples of {_TILE}, got "
                         f"({block_q}, {block_k})")
    vec = 16 // q.element_size()
    for t in (q, k, v):
        if t.stride(3) != 1 or any(st % vec for st in t.stride()[:3]) or \
                t.data_ptr() % 16:
            raise ValueError("block_sparse_attention: the last dimension "
                             "must be contiguous, with 16-byte aligned data "
                             "and strides")
    if k.stride() != v.stride():
        raise ValueError("block_sparse_attention: k and v must share strides")
    if not on_hopper(q.device):
        raise RuntimeError("block_sparse_attention: the kernel is built for "
                           "Hopper (sm_90a) only")


def _pattern_on(device, bm):
    """The kernel's view of a tile pattern on ``device``:
    ``compress_block_mask``'s kmap ``[nq, T]`` and counts ``[nq]``, and
    the pattern rows by falling count ``[nq]`` (the order the kernel's
    blocks take them), all int32. Patterns are static, so each is copied
    to the card once (the last 16 kept)."""
    return _pattern_cached(torch.device(device), bm.shape,
                           np.packbits(bm).tobytes())


@functools.lru_cache(maxsize=16)
def _pattern_cached(device, shape, packed):
    bm = np.unpackbits(np.frombuffer(packed, np.uint8),
                       count=shape[0] * shape[1]).reshape(shape)
    kmap, counts = compress_block_mask(bm)
    order = np.argsort(-counts, kind="stable").astype(np.int32)
    flat = torch.from_numpy(np.concatenate(
        [kmap.ravel(), counts, order])).to(device)
    if device.type == "cuda":        # the copy is done before any stream
        torch.cuda.current_stream(device).synchronize()  # reads it
    nq, t = kmap.shape
    return flat[:nq * t].view(nq, t), flat[nq * t:nq * (t + 1)], \
        flat[nq * (t + 1):]


def block_sparse_attention_fwd(q, k, v, block_mask, block_q=128,
                               block_k=128):
    """The forward with no autograd history: ``[b, s, h, d]`` in q's type
    and layout.

    A CPU tensor takes :func:`block_sparse_attention_plain`. A CUDA tensor
    launches the kernel on the current stream or raises: float32 or
    bfloat16, head dim a multiple of 8 up to 128, blocks multiples of 64,
    q/k/v ``[b, s, h, d]`` views whose last dimension is contiguous (a
    transposed ``[b, h, s, d]`` tensor needs no copy).
    """
    bm = _check(q, k, v, block_mask, block_q, block_k)
    if q.device.type == "cpu":
        return block_sparse_attention_plain(q, k, v, bm, block_q, block_k)
    _check_card(q, k, v, block_q, block_k)
    b, s, h, d = q.shape
    # q's layout where q is dense, else contiguous: strides of d-multiples
    out = torch.empty_like(q)
    if b == 0 or s == 0 or h == 0:
        return out
    kmap, counts, order = _pattern_on(q.device, bm)
    lib = _build.load("block_sparse_attention", _SIGNATURES)
    err = lib.block_sparse_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        kmap.data_ptr(), counts.data_ptr(), order.data_ptr(), b, s, h, d,
        kmap.shape[1], block_q, block_k, *q.stride()[:3], *out.stride()[:3],
        *k.stride()[:3], 1.0 / math.sqrt(d),
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "block_sparse_attention_fwd")
    block_sparse_attention_fwd.launches += 1
    return out


block_sparse_attention_fwd.launches = 0


def _dense_masked(q, k, v, bm, block_q, block_k):
    """The JAX package's ``_dense_masked``: float32 softmax attention under
    the expanded tile mask, rows with no active tile zero, cast to q's
    type. Plain PyTorch on either device; the backward differentiates it."""
    d = q.shape[-1]
    elem = _element_mask(bm, block_q, block_k, q.device)
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    scores = (qf @ kf.transpose(-1, -2)) / math.sqrt(d)
    p = torch.softmax(scores.masked_fill(~elem, NEG_INF), dim=-1)
    p = torch.where(elem.any(-1, keepdim=True), p, 0.0)
    return (p @ vf).to(q.dtype).transpose(1, 2)


class BlockSparseAttentionFunction(torch.autograd.Function):
    """The forward kernel with the JAX custom vjp's backward: saves (q, k,
    v) and differentiates the dense masked recompute."""

    @staticmethod
    def forward(ctx, q, k, v, bm, block_q, block_k):
        ctx.save_for_backward(q, k, v)
        ctx.pattern = (bm, block_q, block_k)
        return block_sparse_attention_fwd(q, k, v, bm, block_q, block_k)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = _dense_masked(*leaves, *ctx.pattern)
        grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None, None)


def block_sparse_attention(q, k, v, block_mask, block_q=128, block_k=128):
    """q/k/v: ``[b, s, h, d]``; block_mask: ``[s // block_q, s // block_k]``
    (0 = the whole tile is masked out; a static pattern, numpy or a CPU
    tensor). Returns ``[b, s, h, d]``; rows with no active tile are 0.
    Differentiable: the backward recomputes the dense masked attention."""
    bm = _check(q, k, v, block_mask, block_q, block_k)
    return BlockSparseAttentionFunction.apply(q, k, v, bm, block_q, block_k)


__all__ = ["BlockSparseAttentionFunction", "block_sparse_attention",
           "block_sparse_attention_fwd", "block_sparse_attention_plain",
           "compress_block_mask"]
