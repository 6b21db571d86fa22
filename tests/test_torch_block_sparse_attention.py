"""The port's block-sparse attention (paddle_tpu_torch.ops.hopper) against
the JAX package's Pallas kernel run in interpret mode and its custom vjp.

On the CPU the wrapper takes its plain version, so these tests hold the
plain forward (the kernel's reference on the card) and the autograd
Function around it (the dense masked recompute, which is the backward on
the card too) to the TPU kernel's semantics. Tolerance: atol 1e-5 in
float32 on outputs and gradients of magnitude up to about 4 (unit-normal
inputs, head dim 32): the dense form sums in another order than the
kernel's tiles. Rows with no active tile are compared exactly: both give 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.block_sparse_attention import (
    block_sparse_attention_pallas)
from paddle_tpu.ops.pallas.block_sparse_attention import \
    compress_block_mask as jax_compress_block_mask
from paddle_tpu_torch.ops.hopper import (BlockSparseAttentionFunction,
                                         block_sparse_attention,
                                         block_sparse_attention_fwd,
                                         block_sparse_attention_plain,
                                         compress_block_mask)

ATOL = 1e-5


def _inputs(seed, b, s, h, d):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, h, d).astype(np.float32) for _ in range(4)]


def _jax_vjp(q, k, v, g, bm):
    out, vjp = jax.vjp(lambda q_, k_, v_: block_sparse_attention_pallas(
        q_, k_, v_, bm, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _port_vjp(q, k, v, g, bm):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = block_sparse_attention(*leaves, bm)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def test_plain_and_grads_match_pallas_kernel():
    b, s, h, d = 1, 512, 2, 32
    q, k, v, g = _inputs(40, b, s, h, d)
    rng = np.random.RandomState(43)
    bm = rng.rand(4, 4) < 0.5
    bm[:, 0] = True
    ref, ref_grads = _jax_vjp(q, k, v, g, bm)
    out, grads = _port_vjp(q, k, v, g, bm)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    plain = block_sparse_attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), bm)
    np.testing.assert_array_equal(plain.numpy(), out)
    for name, a, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        np.testing.assert_allclose(a, r, atol=ATOL, rtol=0, err_msg=name)


def test_empty_tile_row_gives_zero_output_and_zero_dv_rows():
    b, s, h, d = 1, 256, 1, 16
    q, k, v, g = _inputs(50, b, s, h, d)
    bm = np.array([[True, False], [False, False]])  # row 1 fully masked
    ref, ref_grads = _jax_vjp(q, k, v, g, bm)
    out, grads = _port_vjp(q, k, v, g, bm)
    assert not out[:, 128:].any() and not ref[:, 128:].any()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    assert not grads[2][:, 128:].any()          # no row attends there
    assert not grads[0][:, 128:].any()
    for a, r in zip(grads, ref_grads):
        np.testing.assert_allclose(a, r, atol=ATOL, rtol=0)


@pytest.mark.parametrize("pattern", ["random", "empty_rows", "all_empty",
                                     "all_full"])
def test_compress_block_mask_matches_jax(pattern):
    rng = np.random.RandomState(7)
    bm = {"random": rng.rand(6, 5) < 0.4,
          "empty_rows": np.array([[0, 1, 1], [0, 0, 0], [1, 0, 0]]),
          "all_empty": np.zeros((3, 3), bool),
          "all_full": np.ones((4, 4), bool)}[pattern]
    kmap, counts = compress_block_mask(bm)
    ref_kmap, ref_counts = jax_compress_block_mask(bm)
    assert kmap.dtype == ref_kmap.dtype and counts.dtype == ref_counts.dtype
    np.testing.assert_array_equal(kmap, ref_kmap)
    np.testing.assert_array_equal(counts, ref_counts)


def test_shape_errors_match_jax():
    q = torch.zeros(1, 200, 2, 16)
    for fn in (block_sparse_attention, block_sparse_attention_fwd,
               block_sparse_attention_plain):
        with pytest.raises(ValueError, match="must divide blocks"):
            fn(q, q, q, np.ones((2, 2), bool))
    with pytest.raises(ValueError, match="must divide blocks"):
        block_sparse_attention_pallas(jnp.asarray(q.numpy()),
                                      jnp.asarray(q.numpy()),
                                      jnp.asarray(q.numpy()),
                                      np.ones((2, 2), bool), interpret=True)
    q = torch.zeros(1, 256, 2, 16)
    with pytest.raises(ValueError, match="block_mask shape"):
        block_sparse_attention(q, q, q, np.ones((2, 3), bool))
    with pytest.raises(ValueError, match="block_mask shape"):
        block_sparse_attention_pallas(jnp.asarray(q.numpy()),
                                      jnp.asarray(q.numpy()),
                                      jnp.asarray(q.numpy()),
                                      np.ones((2, 3), bool), interpret=True)


def test_cpu_takes_plain_version_in_any_layout_without_launching():
    q, k, v, _ = _inputs(3, 2, 256, 3, 16)
    bm = np.array([[True, False], [True, True]])
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    # [b, h, s, d] tensors read as [b, s, h, d] views, as sparse_attention
    # passes them
    heads_first = [t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in (qt, kt, vt)]
    before = block_sparse_attention_fwd.launches
    out = block_sparse_attention_fwd(*heads_first, bm)
    assert torch.equal(out, block_sparse_attention_plain(qt, kt, vt, bm))
    assert block_sparse_attention_fwd.launches == before
    leaves = [t.requires_grad_() for t in heads_first]
    y = block_sparse_attention(*leaves, bm)
    assert isinstance(y.grad_fn, BlockSparseAttentionFunction._backward_cls)
