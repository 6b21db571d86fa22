"""The port's F.sparse_attention (paddle_tpu_torch.nn.functional_extras)
against the JAX package's, on the CPU.

``_csr_masks`` must give the JAX package's dense mask and tile pattern
exactly (bool arrays). ``sparse_attention`` is compared on both routes: a
tile-aligned pattern takes the port's block-sparse route (the kernel's
plain version here) against the JAX package's dense route (its CPU route),
and a pattern that is not aligned takes the dense route on both.
Tolerance: atol 1e-5 in float32 on outputs and gradients of magnitude up
to about 4 (unit-normal inputs, head dim 16), for summation order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional_extras import _csr_masks as jax_csr_masks
from paddle_tpu.nn.functional_extras import \
    sparse_attention as jax_sparse_attention
from paddle_tpu_torch.nn import functional_extras as FE
from paddle_tpu_torch.ops.hopper import (BlockSparseAttentionFunction,
                                         block_sparse_attention_fwd)

ATOL = 1e-5


def _csr(rows):
    """int32 CSR [1, h, s + 1], [1, h, nnz] from per-head lists of per-row
    column arrays (heads padded to one nnz)."""
    offs = [np.concatenate([[0], np.cumsum([len(c) for c in head])])
            for head in rows]
    nnz = max(int(o[-1]) for o in offs)
    cols = [np.concatenate([np.concatenate(head),
                            np.zeros(nnz - int(o[-1]), np.int64)])
            for head, o in zip(rows, offs)]
    return (np.stack(offs)[None].astype(np.int32),
            np.stack(cols)[None].astype(np.int32))


def _tiles(bm, s, block=128):
    """Per-row columns of a tile pattern."""
    return [np.concatenate([np.arange(c * block, (c + 1) * block)
                            for c in np.flatnonzero(bm[r // block])]
                           or [np.zeros(0, np.int64)])
            for r in range(s)]


def _aligned(h=2, s=256):
    bm = np.array([[True, False], [True, True]])
    return _csr([_tiles(bm, s)] * h), bm


def _window(h=2, s=256, width=40):
    return _csr([[np.arange(max(r - width // 2, 0),
                            min(r + width // 2, s)) for r in range(s)]] * h)


def _per_head(s=256):
    a = np.array([[True, False], [True, True]])
    b = np.array([[True, True], [False, True]])
    return _csr([_tiles(a, s), _tiles(b, s)])


@pytest.mark.parametrize("name", ["aligned", "window", "per_head"])
def test_csr_masks_match_jax(name):
    offs, cols = {"aligned": _aligned()[0], "window": _window(),
                  "per_head": _per_head()}[name]
    mask, bm = FE._csr_masks(offs, cols, 256, 128)
    ref_mask, ref_bm = jax_csr_masks(offs, cols, 256, 128)
    np.testing.assert_array_equal(mask, ref_mask)
    if ref_bm is None:
        assert bm is None
    else:
        np.testing.assert_array_equal(bm, ref_bm)
    assert (bm is None) == (name != "aligned")


def _inputs(seed, h=2, s=256, d=16):
    rng = np.random.RandomState(seed)
    return [rng.randn(1, h, s, d).astype(np.float32) for _ in range(4)]


def _jax_vjp(q, k, v, g, offs, cols):
    out, vjp = jax.vjp(lambda q_, k_, v_: jax_sparse_attention(
        q_, k_, v_, offs, cols)._data,
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    # its dense route divides by a numpy float64, so with x64 on (the
    # suite's setting) the reference computes in float64
    return np.asarray(out), [np.asarray(x)
                             for x in vjp(jnp.asarray(g, out.dtype))]


@pytest.mark.parametrize("route", ["kernel", "dense"])
def test_sparse_attention_and_grads_match_jax(route):
    (offs, cols), bm = _aligned()
    if route == "dense":
        offs, cols = _window()
    q, k, v, g = _inputs(11)
    g[:, :, :5] = 0.0
    ref, ref_grads = _jax_vjp(q, k, v, g, offs, cols)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    before = block_sparse_attention_fwd.launches
    out = FE.sparse_attention(*leaves, offs, torch.from_numpy(cols))
    kernel_route = isinstance(out.grad_fn.next_functions[0][0],
                              BlockSparseAttentionFunction._backward_cls)
    assert kernel_route == (route == "kernel")
    assert block_sparse_attention_fwd.launches == before   # CPU: plain
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL, rtol=0)
    for name, a, r in zip(("dq", "dk", "dv"), leaves, ref_grads):
        np.testing.assert_allclose(a.grad.numpy(), r, atol=ATOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("route", ["kernel", "dense"])
def test_rows_without_entries_are_zero_on_both_routes(route):
    s = 256
    bm = np.array([[False, False], [True, True]])
    rows = _tiles(bm, s)
    if route == "dense":
        rows = [r[:3] for r in rows]          # not tile-aligned
    offs, cols = _csr([rows])
    q, k, v, _ = _inputs(5, h=1)
    out = FE.sparse_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              offs, cols)
    ref = np.asarray(jax_sparse_attention(q, k, v, offs, cols)._data)
    assert not out[:, :, :128].any()
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_masks_raise_where_the_jax_package_ignores_them():
    (offs, cols), _ = _aligned()
    q = torch.zeros(1, 2, 256, 16)
    for kw in ({"key_padding_mask": torch.ones(1, 256)},
               {"attn_mask": torch.zeros(256, 256)}):
        with pytest.raises(NotImplementedError, match="not applied"):
            FE.sparse_attention(q, q, q, offs, cols, **kw)


def test_cache_returns_the_same_objects_and_builds_the_dense_mask_once():
    (offs, cols), bm = _aligned(h=3)          # a pattern of its own
    m0, bm0 = FE._csr_masks(offs, cols, 256, 128, dense=False)
    assert m0 is None and bm0 is not None
    mask, bm1 = FE._csr_masks(offs, cols, 256, 128)
    assert bm1 is bm0 and mask.shape == (1, 3, 256, 256)
    mask2, bm2 = FE._csr_masks(offs, cols, 256, 128)
    assert mask2 is mask and bm2 is bm0
    m3, _ = FE._csr_masks(offs, cols, 256, 128, dense=False)
    assert m3 is mask
    # eight patterns later the first one has been evicted
    for i in range(8):
        other = cols.copy()
        other[..., 0] = i + 1
        FE._csr_masks(offs, other, 256, 128, dense=False)
    assert FE._csr_masks(offs, cols, 256, 128)[0] is not mask
    assert len(FE._CSR_MASK_CACHE) <= 8
