"""The port's RMSNorm (paddle_tpu_torch.ops.hopper.fused_ops.rms_norm)
against the JAX package's Pallas kernel run in interpret mode.

On the CPU the wrapper takes its plain version. It must round once, as the
TPU kernel does (y = x * rstd * w in float32, then cast), which differs
from the XLA fallback's round-then-multiply in bf16. Tolerances: float32
within 1e-6 (one reduction order apart); bf16 within one bf16 ulp.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas.fused_ops import _rms_fwd_call, rms_norm_pallas
from paddle_tpu_torch.ops.hopper import rms_norm, rms_norm_plain

EPS = 1e-5


def _xw(seed, shape):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2.0).astype(np.float32)
    w = (1.0 + 0.5 * rng.randn(shape[-1])).astype(np.float32)
    return x, w


def _pallas(x, w, dtype):
    xj, wj = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    y = rms_norm_pallas(xj, wj, EPS, True)
    _, rstd = _rms_fwd_call(xj.reshape(-1, x.shape[-1]), wj, EPS, True)
    return (np.asarray(y.astype(jnp.float32)),
            np.asarray(rstd).reshape(*x.shape[:-1], 1))


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 128)])
def test_plain_matches_pallas_interpret_f32(shape):
    x, w = _xw(sum(shape), shape)
    y_ref, rstd_ref = _pallas(x, w, jnp.float32)
    y, rstd = rms_norm_plain(torch.from_numpy(x), torch.from_numpy(w), EPS)
    assert y.dtype == torch.float32 and tuple(y.shape) == shape
    assert rstd.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), rstd_ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 128)])
def test_plain_matches_pallas_interpret_bf16_within_one_ulp(shape):
    x, w = _xw(3 + sum(shape), shape)
    y_ref, rstd_ref = _pallas(x, w, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    y, rstd = rms_norm_plain(xt, wt, EPS)
    assert y.dtype == torch.bfloat16
    y = y.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(y_ref), 1e-30))) - 7)
    assert np.all(np.abs(y - y_ref) <= ulp)
    np.testing.assert_allclose(rstd.numpy(), rstd_ref, rtol=1e-6, atol=0)


def test_plain_rounds_once_not_like_the_xla_fallback():
    # the product x * rstd * w is rounded to bf16 once; rounding x * rstd
    # first (the XLA fallback) gives different bits for some elements
    x, w = _xw(11, (16, 128))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    y, rstd = rms_norm_plain(xt, wt, EPS)
    once = (xt.float() * rstd * wt.float()).to(torch.bfloat16)
    twice = (xt.float() * rstd).to(torch.bfloat16) * wt
    assert torch.equal(y, once)
    assert not torch.equal(y, twice)


def test_wrapper_on_cpu_takes_plain_version_without_launching():
    x, w = _xw(5, (2, 5, 64))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    y, rstd = rms_norm(xt, wt, EPS)
    ref_y, ref_rstd = rms_norm_plain(xt, wt, EPS)
    assert rms_norm.launches == 0
    assert torch.equal(y, ref_y) and torch.equal(rstd, ref_rstd)
    with pytest.raises(ValueError, match="hidden size"):
        rms_norm(xt, wt[:32], EPS)
