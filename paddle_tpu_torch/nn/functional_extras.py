"""Block-sparse attention over a CSR pattern (counterpart of
``paddle_tpu/nn/functional_extras.py``: ``_csr_masks`` and
``sparse_attention``).

When the pattern is tile-aligned (every active 128 x 128 tile fully dense,
one pattern for every batch row and head) and ``s % 128 == 0`` and
``d % 8 == 0``, ``sparse_attention`` runs the block-sparse kernel over the
active tiles only; otherwise it applies the pattern densely, as the JAX
package does. That dense route is the JAX package's own routing, not a
fallback from a kernel that failed. Off the CPU the kernel route also needs
what the kernel takes (``kernel_route``): a head dim up to 128 and float32
or bfloat16 inputs.
"""
from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from ..ops.hopper import block_sparse_attention
from ..ops.hopper.block_sparse_attention import MAX_HEAD_DIM

BLOCK = 128
_CACHE_SIZE = 8
# pattern digest -> [dense mask or None until the dense route asks, block
# mask or None]
_CSR_MASK_CACHE: dict = {}


def _csr_entries(off, col, seq):
    """(rows, columns) of every entry of one (batch, head) CSR pattern: row
    r holds ``col[off[r]:off[r + 1]]``."""
    counts = np.maximum(np.diff(off[:seq + 1]), 0)
    rows = np.repeat(np.arange(seq), counts)
    first = np.cumsum(counts) - counts            # row r's first entry
    pos = np.repeat(off[:seq] - first, counts) + np.arange(counts.sum())
    return rows, col[pos]


def _expand(offs, cols, seq, bi, hi):
    """The dense ``[seq, seq]`` bool mask of pattern (bi, hi)."""
    mask = np.zeros((seq, seq), bool)
    rows, c = _csr_entries(offs[bi, hi], cols[bi, hi], seq)
    mask[rows, c] = True
    return mask


def _tile_pattern(offs, cols, seq, block):
    """The alignment probe: the ``[seq / block, seq / block]`` tile mask
    when every active tile is fully dense and the pattern is one across
    batch rows and heads, else None. Expands one (batch, head) at a time,
    so the dense ``[b, h, s, s]`` mask is never built here."""
    if seq % block:
        return None
    nb = seq // block
    first = None
    for bi in range(offs.shape[0]):
        for hi in range(offs.shape[1]):
            tiles = _expand(offs, cols, seq, bi, hi).reshape(nb, block, nb,
                                                             block)
            any_ = tiles.any(axis=(1, 3))
            if not np.array_equal(any_, tiles.all(axis=(1, 3))):
                return None
            if first is None:
                first = any_
            elif not np.array_equal(any_, first):
                return None
    return first


def _csr_masks(offs, cols, seq, block, dense=True):
    """CSR pattern -> ``(dense [b, h, s, s] bool mask, tile-aligned block
    mask or None)``, cached by content digest (the pattern is static across
    steps), 8 entries. With ``dense=False`` the dense mask is not built
    unless an earlier call built it, and the first item may be None."""
    key = (hashlib.sha1(offs.tobytes()).hexdigest(),
           hashlib.sha1(cols.tobytes()).hexdigest(), seq, block)
    hit = _CSR_MASK_CACHE.get(key)
    if hit is None:
        hit = [None, _tile_pattern(offs, cols, seq, block)]
        if len(_CSR_MASK_CACHE) >= _CACHE_SIZE:
            _CSR_MASK_CACHE.pop(next(iter(_CSR_MASK_CACHE)))
        _CSR_MASK_CACHE[key] = hit
    if dense and hit[0] is None:
        b, h = offs.shape[0], offs.shape[1]
        hit[0] = np.stack([np.stack([_expand(offs, cols, seq, bi, hi)
                                     for hi in range(h)]) for bi in range(b)])
    return hit[0], hit[1]


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def kernel_route(query, block_mask) -> bool:
    """Whether ``sparse_attention`` takes the block-sparse kernel route: a
    tile-aligned pattern and ``d % 8 == 0`` (the JAX package's routing);
    off the CPU also a head dim up to ``MAX_HEAD_DIM`` and float32 or
    bfloat16 q (the CPU's plain version takes any). Decided from the
    pattern, shapes, type and device type alone."""
    d = query.shape[-1]
    if block_mask is None or d % 8:
        return False
    return query.device.type == "cpu" or (
        d <= MAX_HEAD_DIM and query.dtype in (torch.float32, torch.bfloat16))


def sparse_attention(query, key, value, sparse_csr_offset, sparse_csr_columns,
                     key_padding_mask=None, attn_mask=None):
    """Attention over ``[b, h, s, d]`` restricted to a CSR pattern per
    (batch, head): ``sparse_csr_offset [b, h, s + 1]`` and
    ``sparse_csr_columns [b, h, nnz]`` (numpy or tensors). Rows with no
    entry output 0. Differentiable on both routes.

    ``key_padding_mask`` and ``attn_mask`` raise NotImplementedError: the
    JAX package accepts both and applies neither (they only turn its
    kernel route off).
    """
    if key_padding_mask is not None or attn_mask is not None:
        raise NotImplementedError(
            "sparse_attention: key_padding_mask and attn_mask are not "
            "applied (the JAX package accepts and ignores them); pass "
            "neither")
    offs, cols = _host(sparse_csr_offset), _host(sparse_csr_columns)
    b, h, seq, d = query.shape
    _, block_mask = _csr_masks(offs, cols, seq, BLOCK, dense=False)
    if kernel_route(query, block_mask):
        out = block_sparse_attention(query.transpose(1, 2),
                                     key.transpose(1, 2),
                                     value.transpose(1, 2), block_mask)
        return out.transpose(1, 2)
    mask, _ = _csr_masks(offs, cols, seq, BLOCK)
    mask = torch.from_numpy(mask).to(query.device)
    scores = (query @ key.transpose(-1, -2)) / math.sqrt(d)
    probs = torch.softmax(scores.masked_fill(~mask, -1e9), dim=-1)
    # empty CSR rows output zero (the kernel's l = 0 semantics)
    probs = torch.where(mask.any(-1, keepdim=True), probs, 0.0)
    return probs @ value


__all__ = ["kernel_route", "sparse_attention"]
