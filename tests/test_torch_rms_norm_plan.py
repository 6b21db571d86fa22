"""The RMSNorm kernels' build choice (paddle_tpu_torch.ops.hopper.fused_ops
rms_fwd_plan / rms_bwd_plan), and the plain versions against the JAX
package's Pallas kernels in interpret mode at the widths whose builds
chip_smoke.py holds on the card.

The plans are pure functions of (rows, h, dtype, alignment, SM count): the
vector builds take rows of whole 16-byte vectors from 16-byte-aligned
pointers up to a register budget, the general builds everything else.
Tolerances of the parity cases as in test_torch_rms_norm.py (forward:
float32 within 1e-6, bf16 within one bf16 ulp) and test_torch_rms_norm_bwd.py
(float32 within 2e-6 of the largest magnitude, bf16 within one bf16 ulp).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.fused_ops import _rms_fwd_call, rms_norm_pallas
from paddle_tpu_torch.ops.hopper import rms_norm_bwd_plain, rms_norm_plain
from paddle_tpu_torch.ops.hopper.fused_ops import (H100_SMS, _aligned,
                                                   rms_bwd_plan, rms_fwd_plan)

EPS = 1e-5
BF16, F32 = torch.bfloat16, torch.float32


def _vectors(h, dtype):
    return h * dtype.itemsize // 16


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("h", [4096, 5120, 8192, 1000])
def test_llama_widths_take_the_vector_builds(h, dtype):
    # 1000 is 125 whole bf16 vectors (250 float32 ones), so it is a vector
    # width too, with a ragged last warp
    for rows in (1, 4, 37, 2048, 8192):
        assert rms_fwd_plan(rows, h, dtype, True).vpt in (1, 4, 8)
        assert rms_bwd_plan(rows, h, dtype, True).vpt in (1, 2, 4)


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_other_widths_offsets_and_wide_rows_take_the_general_builds(dtype):
    # not whole 16-byte vectors
    for h in (1001, 4100 if dtype == BF16 else 4098):
        assert rms_fwd_plan(64, h, dtype, True).vpt == 0
        assert rms_bwd_plan(64, h, dtype, True).vpt == 0
    # a view two bytes into its storage
    buf = torch.zeros(37 * 4096 + 1, dtype=dtype)
    x = buf[1:].view(37, 4096)
    w = torch.ones(4096, dtype=dtype)
    assert x.is_contiguous() and not _aligned(x, w)
    assert _aligned(buf[:-1].view(37, 4096), w)
    assert rms_fwd_plan(37, 4096, dtype, _aligned(x, w)).vpt == 0
    assert rms_bwd_plan(37, 4096, dtype, _aligned(x, w)).vpt == 0
    # past the register budgets: the forward's 4096 vectors a row, the
    # backward's 2048
    fwd_max, bwd_max = 4096 * 16 // dtype.itemsize, 2048 * 16 // dtype.itemsize
    assert rms_fwd_plan(8, fwd_max, dtype, True).vpt == 8
    assert rms_fwd_plan(8, 2 * fwd_max, dtype, True).vpt == 0
    assert rms_bwd_plan(8, bwd_max, dtype, True).vpt == 4
    assert rms_bwd_plan(8, 2 * bwd_max, dtype, True).vpt == 0
    assert fwd_max >= 16384


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_vector_blocks_cover_each_row_once(dtype):
    """Vector j of a row is thread j % threads, slot j // threads: every
    vector has a slot, no warp is wholly spare, and blocks stay within
    512 threads; the backward's ring fits its 192 KiB."""
    for h in list(range(64, 2048, 40)) + [4096, 5120, 8192, 11008, 16384]:
        nv = _vectors(h, dtype)
        for rows in (1, 100, 8192):
            fp = rms_fwd_plan(rows, h, dtype, h % (16 // dtype.itemsize) == 0)
            bp = rms_bwd_plan(rows, h, dtype, h % (16 // dtype.itemsize) == 0)
            for p in (fp, bp):
                if p.vpt == 0:
                    continue
                assert p.threads % 32 == 0 and 32 <= p.threads <= 512
                assert p.threads * p.vpt >= nv > (p.threads - 32) * p.vpt
            if bp.vpt:  # 3 stages of an x and a g row (kStages)
                assert 3 * 2 * h * dtype.itemsize <= 192 * 1024


def test_decode_rows_spread_over_threads_and_train_rows_over_blocks():
    # four rows (a decode step): one vector a thread, 512 threads a row
    assert rms_fwd_plan(4, 4096, BF16, True) == (1, 512)
    # prefill and training rows: four vectors a thread, 128 threads a row
    assert rms_fwd_plan(2048, 4096, BF16, True) == (4, 128)
    assert rms_fwd_plan(8192, 4096, BF16, True) == (4, 128)


@pytest.mark.parametrize("sms", [H100_SMS, 114])
def test_backward_grid_and_partials_within_bounds(sms):
    """Row-pass blocks (= dw partials): min(rows, sms) for the vector
    build, min(rows, 4 sms) for the general one; the column sum has at
    least min(sms, h / 8) blocks."""
    for rows in range(1, 8193):
        p = rms_bwd_plan(rows, 4096, BF16, True, sms)
        assert p.parts == min(rows, sms)
    for rows in (1, 2, 131, 132, 133, 1000, 8192):
        for h, dtype, aligned in ((4096, F32, True), (8192, BF16, True),
                                  (1001, BF16, True), (4096, BF16, False),
                                  (51200, F32, True)):
            p = rms_bwd_plan(rows, h, dtype, aligned, sms)
            cap = sms if p.vpt else 4 * sms
            assert 1 <= p.parts == min(rows, cap)
            assert p.sum_cols in (8, 16, 32)
            assert -(-h // p.sum_cols) >= min(sms, -(-h // 8))
    # the partials at Llama-7B width: 132 x 4096 float32, 2.1 MB
    assert rms_bwd_plan(8192, 4096, BF16, True).parts * 4096 * 4 <= 2.2e6


def _inputs(seed, rows, h):
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, h) * 2.0).astype(np.float32)
    w = (1.0 + 0.5 * rng.randn(h)).astype(np.float32)
    g = rng.randn(rows, h).astype(np.float32)
    return x, w, g


def _within_one_ulp(a, ref):
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    return bool(np.all(np.abs(a - ref) <= ulp))


@pytest.mark.parametrize("h", [4096, 1000])
def test_plain_versions_match_pallas_interpret(h):
    """Forward and backward, three rows (padded to eight by the Pallas
    call), float32 and bf16."""
    x, w, g = _inputs(h, 3, h)
    for jdt, tdt in ((jnp.float32, F32), (jnp.bfloat16, BF16)):
        xj, wj, gj = (jnp.asarray(a, jdt) for a in (x, w, g))
        y_ref, rstd_ref = _rms_fwd_call(xj, wj, EPS, True)
        _, vjp = jax.vjp(lambda a, b: rms_norm_pallas(a, b, EPS, True), xj,
                         wj)
        dx_ref, dw_ref = (np.asarray(t.astype(jnp.float32))
                          for t in vjp(gj))
        y_ref = np.asarray(y_ref.astype(jnp.float32))
        xt, wt, gt = (torch.from_numpy(a).to(tdt) for a in (x, w, g))
        y, rstd = rms_norm_plain(xt, wt, EPS)
        dx, dw = rms_norm_bwd_plain(xt, wt, gt, rstd)
        np.testing.assert_allclose(rstd.numpy(), np.asarray(rstd_ref),
                                   rtol=1e-6, atol=0)
        got = [t.float().numpy() for t in (y, dx, dw)]
        if tdt == F32:
            np.testing.assert_allclose(got[0], y_ref, rtol=1e-6, atol=1e-6)
            for a, r in zip(got[1:], (dx_ref, dw_ref)):
                tol = 2e-6 * max(1.0, float(np.abs(r).max()))
                np.testing.assert_allclose(a, r, atol=tol, rtol=0)
        else:
            for a, r in zip(got, (y_ref, dx_ref, dw_ref)):
                assert _within_one_ulp(a, r)
