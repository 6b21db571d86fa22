"""The rounding of the bf16 flash attention forward and block-sparse
kernels, on the CPU.

On the card, bf16 inputs go through tensor-core kernels
(``csrc/flash_attention.cu`` ``flash_fwd_wgmma`` and
``csrc/block_sparse_attention.cu`` ``block_sparse_fwd_wgmma``) that keep
an online softmax over K/V tiles and round P to bf16 before O += P V, as
FlashAttention-2/3 do, where the plain versions keep P in float32 and
take one softmax over the whole row. ``_flash_arithmetic`` and
``_block_sparse_arithmetic`` below repeat the kernels' arithmetic in
float32 PyTorch, tile by tile: bf16 inputs; S = Q K^T not pre-scaled;
unmasked, P = exp2(S c - m c) with c = scale log2(e) and m the running
row max of S; with a mask, y = S scale + mask (added before the causal
fill) and P = exp2((y - m) log2(e)); dropped scores give P = 0; P rounded
to the inputs' type for P V while l sums the unrounded P; O = acc /
max(l, 1e-20), so a block-sparse row with no active tile is exactly 0; LSE
through log2 units back to natural log. Tiles are the kernels': 128 K/V
rows unmasked and 64 masked for the forward, 128 or 64 (as block_k
allows) for block-sparse.

The tests hold the helpers to ``flash_attention_plain`` and
``block_sparse_attention_plain`` within ``chip_smoke.py``'s tolerances
(copied below: bf16 one ulp at the largest magnitude, LSE 2e-5 relative),
the bounds the kernels are held to on the card, so the design's rounding
is shown to fit before any card runs it. With float32 inputs nothing is
rounded: the helpers then agree with the JAX package's ``_fwd_call`` and
``_bs_fwd`` in interpret mode at the tolerances of
``test_torch_flash_attention.py`` (2e-5) and
``test_torch_block_sparse_attention.py`` (1e-5).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.block_sparse_attention import _bs_fwd
from paddle_tpu.ops.pallas.block_sparse_attention import \
    compress_block_mask as jax_compress_block_mask
from paddle_tpu.ops.pallas.flash_attention import _fwd_call
from paddle_tpu_torch.ops.hopper import (block_sparse_attention_plain,
                                         compress_block_mask,
                                         flash_attention_plain)

LOG2E = 1.4426950408889634
NEG_INF = -1e30


def tolerance(ref, dtype):
    """chip_smoke.py's tolerance: bf16 one ulp at the largest magnitude
    (2^-7 relative), float32 2e-5."""
    scale = max(1.0, float(ref.float().abs().max()))
    return scale * (2.0 ** -7 if dtype == torch.bfloat16 else 2e-5)


def _online(qf, kf, vf, tiles, c, lean, dtype, keep_of=None, mask_of=None,
            scale=1.0):
    """The kernels' online softmax over `tiles` (first column, width) of
    one query block: (acc / max(l, 1e-20), m, l)."""
    rows = qf.shape[:-1] + (1,)
    m = torch.full(rows, NEG_INF)
    l = torch.zeros(rows)
    acc = torch.zeros(qf.shape[:-1] + (vf.shape[-1],))
    for k0, kn in tiles:
        y = qf @ kf[..., k0:k0 + kn, :].transpose(-1, -2)
        if not lean:
            y = y * scale + mask_of(k0, kn)
        keep = None if keep_of is None else keep_of(k0, kn)
        if keep is not None:
            y = torch.where(keep, y, NEG_INF)
        m_new = torch.maximum(m, y.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * c)
        p = torch.exp2(y * c - m_new * c) if lean else \
            torch.exp2((y - m_new) * LOG2E)
        if keep is not None:
            p = torch.where(keep, p, 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(dtype).float() @ vf[..., k0:k0 + kn, :]
        m = m_new
    return acc / l.clamp_min(1e-20), m, l


def _flash_arithmetic(q, k, v, causal, mask=None):
    """(out, lse) as flash_fwd_wgmma computes them."""
    b, s, hq, d = q.shape
    group = hq // k.shape[2]
    scale = 1.0 / math.sqrt(d)
    lean = mask is None
    kn = 128 if lean else 64
    qf = q.float().transpose(1, 2)
    kf, vf = (t.float().transpose(1, 2).repeat_interleave(group, dim=1)
              for t in (k, v))
    rows = torch.arange(s)[:, None]

    def keep_of(k0, width):
        cols = torch.arange(k0, k0 + width)[None, :]
        return cols <= rows if causal else torch.ones(s, width, dtype=bool)

    tiles = [(k0, min(kn, s - k0)) for k0 in range(0, s, kn)]
    out, m, l = _online(
        qf, kf, vf, tiles, scale * LOG2E if lean else LOG2E, lean, q.dtype,
        keep_of, lambda k0, w: mask[..., k0:k0 + w].float(), scale)
    lse = m * (scale if lean else 1.0) + torch.log(l.clamp_min(1e-20))
    return out.transpose(1, 2).to(q.dtype), lse.squeeze(-1)


def _block_sparse_arithmetic(q, k, v, bm, block_q, block_k):
    """The output as block_sparse_fwd_wgmma computes it."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    kn = 128 if block_k % 128 == 0 else 64
    kmap, counts = compress_block_mask(bm)
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    out = torch.zeros(b, h, s, d)
    for qi in range(s // block_q):
        tiles = [(int(kmap[qi, t // (block_k // kn)]) * block_k
                  + t % (block_k // kn) * kn, kn)
                 for t in range(int(counts[qi]) * (block_k // kn))]
        rows = slice(qi * block_q, (qi + 1) * block_q)
        out[:, :, rows], _, _ = _online(qf[:, :, rows], kf, vf, tiles,
                                        scale * LOG2E, True, q.dtype)
    return out.transpose(1, 2).to(q.dtype)


def _t(a, dtype):
    return torch.from_numpy(a).to(dtype)


def _flash_inputs(seed, s, hq, hkv, d, dtype, mask_dtype=None, b=1):
    rng = np.random.RandomState(seed)
    q = _t(rng.randn(b, s, hq, d).astype(np.float32), dtype)
    k, v = (_t(rng.randn(b, s, hkv, d).astype(np.float32), dtype)
            for _ in range(2))
    mask = None
    if mask_dtype is not None:
        m = np.where(rng.rand(b, 1, s, s) < 0.3, -1e9,
                     rng.randn(b, 1, s, s)).astype(np.float32)
        m[0, :, s // 3, :] = -1e9                 # a row hidden entirely
        mask = _t(m, mask_dtype)
    return q, k, v, mask


def _check_flash(q, k, v, causal, mask):
    out, lse = _flash_arithmetic(q, k, v, causal, mask)
    ref, ref_lse = flash_attention_plain(q, k, v, causal, mask)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert float((out.float() - ref.float()).abs().max()) <= \
        tolerance(ref, q.dtype)
    assert float((lse - ref_lse).abs().max()) <= \
        tolerance(ref_lse, torch.float32)


@pytest.mark.parametrize("s", [300, 1000])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_rounding_within_the_card_tolerance(causal, hq, hkv, d,
                                                       s):
    q, k, v, _ = _flash_inputs(s + d + hkv + causal, s, hq, hkv, d,
                               torch.bfloat16)
    _check_flash(q, k, v, causal, None)


@pytest.mark.parametrize("mask_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,s,d", [(False, 1000, 128), (True, 300, 64)])
def test_flash_bf16_rounding_under_a_mask_with_a_hidden_row(causal, s, d,
                                                            mask_dtype):
    q, k, v, mask = _flash_inputs(7 + s, s, 4, 2, d, torch.bfloat16,
                                  mask_dtype)
    _check_flash(q, k, v, causal, mask)


@pytest.mark.parametrize("d", [64, 40])
@pytest.mark.parametrize("blocks", [(128, 128), (64, 64), (64, 128)])
def test_block_sparse_bf16_rounding_within_the_card_tolerance(blocks, d):
    block_q, block_k = blocks
    b, s, h = 1, 512, 2
    rng = np.random.RandomState(d + block_q + block_k)
    q, k, v = (_t(rng.randn(b, s, h, d).astype(np.float32), torch.bfloat16)
               for _ in range(3))
    bm = rng.rand(s // block_q, s // block_k) < 0.4
    bm[1] = False                                 # an empty tile row
    bm[-1] = True
    out = _block_sparse_arithmetic(q, k, v, bm, block_q, block_k)
    ref = block_sparse_attention_plain(q, k, v, bm, block_q, block_k)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert float((out.float() - ref.float()).abs().max()) <= \
        tolerance(ref, torch.bfloat16)
    assert torch.equal(out[:, block_q:2 * block_q],
                       torch.zeros_like(out[:, block_q:2 * block_q]))


@pytest.mark.parametrize("masked", [False, True])
def test_flash_float32_arithmetic_matches_pallas_fwd_call(masked):
    b, s, hq, hkv, d, causal = 2, 160, 4, 2, 16, True
    q, k, v, mask = _flash_inputs(3 + masked, s, hq, hkv, d, torch.float32,
                                  torch.float32 if masked else None, b=b)

    def to_bh(x):
        return jnp.asarray(x.numpy().transpose(0, 2, 1, 3).reshape(-1, s, d))

    o_bh, lse_bh = _fwd_call(
        to_bh(q), to_bh(k), to_bh(v),
        None if mask is None else jnp.asarray(mask.numpy()), None,
        jnp.zeros((1,), jnp.int32), causal, 0.0, hq, hkv, 32, 32, True)
    out, lse = _flash_arithmetic(q, k, v, causal, mask)
    np.testing.assert_allclose(
        out.numpy(),
        np.asarray(o_bh).reshape(b, hq, s, d).transpose(0, 2, 1, 3),
        atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(lse_bh).reshape(b, hq, s),
                               atol=2e-5, rtol=0)


def test_block_sparse_float32_arithmetic_matches_pallas_bs_fwd():
    b, s, h, d, block_q, block_k = 1, 256, 2, 32, 64, 128
    rng = np.random.RandomState(11)
    q, k, v = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(3))
    bm = rng.rand(s // block_q, s // block_k) < 0.5
    bm[0] = False
    bm[-1] = True
    kmap, counts = jax_compress_block_mask(bm)

    def to_bh(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(-1, s, d))

    ref = np.asarray(_bs_fwd(to_bh(q), to_bh(k), to_bh(v), kmap, counts,
                             block_q, block_k, True))
    out = _block_sparse_arithmetic(*(torch.from_numpy(x) for x in (q, k, v)),
                                   bm, block_q, block_k)
    np.testing.assert_allclose(
        out.numpy(), ref.reshape(b, h, s, d).transpose(0, 2, 1, 3),
        atol=1e-5, rtol=0)
