"""The port's RMSNorm backward (paddle_tpu_torch.ops.hopper.rms_norm_bwd
and the RMSNormFunction that carries it) against jax.vjp of the JAX
package's Pallas kernel run in interpret mode.

On the CPU the wrappers take their plain versions, which must compute what
the TPU kernel computes: dx = (g w - x c rstd^2) rstd with c = sum(g w x) / h,
and dw summed over rows in float32 and cast to w's type. Tolerances:
float32 within 2e-6 relative to the largest magnitude (one reduction order
apart; dw sums up to 64 rows; the worst seen is 2.1e-7); bf16 dx and dw
within one bf16 ulp of the reference (both round float32 math once, and
float32 sums that differ in their last bits may land on either side of a
rounding edge; the cases here come out bit-equal).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.fused_ops import rms_norm_pallas
from paddle_tpu_torch.nn import functional as port_F
from paddle_tpu_torch.ops.hopper import (RMSNormFunction, rms_norm,
                                         rms_norm_bwd, rms_norm_bwd_plain)

EPS = 1e-5


def _inputs(seed, rows, h=128):
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, h) * 2.0).astype(np.float32)
    w = (1.0 + 0.5 * rng.randn(h)).astype(np.float32)
    g = rng.randn(rows, h).astype(np.float32)
    return x, w, g


def _jax_vjp(x, w, g, dtype):
    _, vjp = jax.vjp(lambda x_, w_: rms_norm_pallas(x_, w_, EPS, True),
                     jnp.asarray(x, dtype), jnp.asarray(w, dtype))
    dx, dw = vjp(jnp.asarray(g, dtype))
    return (np.asarray(dx.astype(jnp.float32)),
            np.asarray(dw.astype(jnp.float32)))


def _port(x, w, g, dtype):
    """(dx, dw) through the plain backward and through autograd."""
    xt, wt, gt = (torch.from_numpy(a).to(dtype) for a in (x, w, g))
    _, rstd = rms_norm(xt, wt, EPS)
    plain = rms_norm_bwd_plain(xt, wt, gt, rstd)
    leaves = [xt.clone().requires_grad_(), wt.clone().requires_grad_()]
    port_F.rms_norm(*leaves, EPS).backward(gt)
    return plain, (leaves[0].grad, leaves[1].grad)


@pytest.mark.parametrize("rows", [37, 64])
def test_plain_and_autograd_match_pallas_vjp_f32(rows):
    x, w, g = _inputs(rows, rows)
    ref = _jax_vjp(x, w, g, jnp.float32)
    for got in _port(x, w, g, torch.float32):
        for a, r in zip(got, ref):
            assert a.dtype == torch.float32 and a.shape == r.shape
            tol = 2e-6 * max(1.0, float(np.abs(r).max()))
            np.testing.assert_allclose(a.numpy(), r, atol=tol, rtol=0)


@pytest.mark.parametrize("rows", [37, 64])
def test_plain_and_autograd_match_pallas_vjp_bf16(rows):
    x, w, g = _inputs(7 + rows, rows)
    ref = _jax_vjp(x, w, g, jnp.bfloat16)
    for got in _port(x, w, g, torch.bfloat16):
        for a, r in zip(got, ref):
            assert a.dtype == torch.bfloat16
            a = a.float().numpy()
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(r), 1e-30)))
                          - 7)
            assert np.all(np.abs(a - r) <= ulp)


def test_leading_dims_and_saved_residuals():
    x, w, g = _inputs(3, 12, h=64)
    xt = torch.from_numpy(x).reshape(3, 4, 64).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = port_F.rms_norm(xt, wt, EPS)
    assert type(y.grad_fn).__name__ == "RMSNormFunctionBackward"
    saved_x, saved_w, saved_rstd = y.grad_fn.saved_tensors
    assert saved_x is xt or torch.equal(saved_x, xt)
    assert tuple(saved_rstd.shape) == (3, 4, 1)
    y.backward(torch.from_numpy(g).reshape(3, 4, 64))
    ref = _jax_vjp(x, w, g, jnp.float32)
    np.testing.assert_allclose(xt.grad.reshape(12, 64).numpy(), ref[0],
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(wt.grad.numpy(), ref[1], atol=2e-5, rtol=0)


def test_wrapper_on_cpu_takes_plain_version_without_launching():
    x, w, g = (torch.from_numpy(a) for a in _inputs(5, 10, h=32))
    _, rstd = rms_norm(x, w, EPS)
    got = rms_norm_bwd(x, w, g, rstd)
    ref = rms_norm_bwd_plain(x, w, g, rstd)
    assert rms_norm_bwd.launches == 0
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    with pytest.raises(ValueError, match="rms_norm_bwd"):
        rms_norm_bwd(x, w, g[:5], rstd)
    assert RMSNormFunction.apply(x, w, EPS).grad_fn is None  # no grad wanted
