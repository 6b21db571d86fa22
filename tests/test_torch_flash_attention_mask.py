"""The port's flash attention with an additive mask, and the SDPA routing
around it, against the JAX package on the CPU.

The plain versions (the kernels' references on the card) and the autograd
Function that carries them are held to ``flash_attention_pallas(...,
attn_mask=, interpret=True)`` and its vjp. Each mask is 30% -1e9 and
otherwise unit normal, and hides one row entirely, which both packages
give as a uniform row. Tolerance: atol 2e-5 in float32 on outputs and
gradients of magnitude up to about 8: the dense form sums in another order
than the kernels' tiles, and a mask of unit-normal entries widens the
scores, so the softmax gradient (dP - delta) magnifies last-bit
differences more than without a mask (1e-5 there; 7.6e-6 seen here).
The dense routes are compared with the JAX package's ``_sdpa_op`` at
atol 1e-5.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as jax_F
from paddle_tpu.ops.pallas.flash_attention import flash_attention_pallas
from paddle_tpu_torch.nn import functional as port_F
from paddle_tpu_torch.ops.hopper import (FlashAttentionFunction,
                                         flash_attention,
                                         flash_attention_bwd,
                                         flash_attention_bwd_dkv,
                                         flash_attention_bwd_dq,
                                         flash_attention_bwd_plain,
                                         flash_attention_plain)

ATOL = 2e-5
D = 16


def _inputs(seed, s, hq, hkv, mask_heads, b=2):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, s, hq, D).astype(np.float32)
    k = rng.randn(b, s, hkv, D).astype(np.float32)
    v = rng.randn(b, s, hkv, D).astype(np.float32)
    do = rng.randn(b, s, hq, D).astype(np.float32)
    mask = np.where(rng.rand(b, mask_heads, s, s) < 0.3, -1e9,
                    rng.randn(b, mask_heads, s, s)).astype(np.float32)
    mask[0, :, s // 3, :] = -1e9
    return q, k, v, do, mask


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


# every pair of (mask heads, causal, MHA or GQA, s) values appears: half of
# the 16 combinations, to keep the interpret-mode runs short
@pytest.mark.parametrize("mask_heads,causal,hq,hkv,s", [
    (1, True, 4, 4, 64), (4, True, 4, 2, 64), (1, False, 4, 2, 64),
    (4, False, 4, 4, 64), (1, True, 4, 2, 37), (4, True, 4, 4, 37),
    (1, False, 4, 4, 37), (4, False, 4, 2, 37)])
def test_plain_and_autograd_match_pallas_with_mask(mask_heads, causal, hq,
                                                   hkv, s):
    q, k, v, do, mask = _inputs(s + hkv + mask_heads, s, hq, hkv, mask_heads)
    ref, vjp = jax.vjp(lambda q_, k_, v_: flash_attention_pallas(
        q_, k_, v_, causal=causal, attn_mask=jnp.asarray(mask),
        interpret=True), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_grads = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    qt, kt, vt, dot, mt = _t(q, k, v, do, mask)
    out, lse = flash_attention_plain(qt, kt, vt, causal, mt)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)
    # the hidden row is uniform over the keys causality leaves it
    row = out[0, s // 3]
    seen = s // 3 + 1 if causal else s
    uniform = vt[0, :seen].repeat_interleave(hq // hkv, dim=1).mean(0)
    torch.testing.assert_close(row, uniform, atol=1e-5, rtol=0)
    grads = flash_attention_bwd_plain(qt, kt, vt, out, dot, lse, causal, mt)
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), r, atol=ATOL, rtol=0,
                                   err_msg=name)

    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    out = port_F.scaled_dot_product_attention(*leaves, attn_mask=mt,
                                              is_causal=causal)
    assert isinstance(out.grad_fn, FlashAttentionFunction._backward_cls)
    out.backward(dot)
    for name, t, r in zip(("dq", "dk", "dv"), leaves, ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), r, atol=ATOL, rtol=0,
                                   err_msg=name)


def test_mask_gets_zero_grad_and_rides_the_saved_tensors():
    q, k, v, do, mask = _inputs(1, 20, 4, 2, 1)
    qt, kt, vt, dot, mt = _t(q, k, v, do, mask)
    mt.requires_grad_()
    out, _ = FlashAttentionFunction.apply(qt, kt, vt, False, mt)
    assert len(out.grad_fn.saved_tensors) == 6
    assert torch.equal(out.grad_fn.saved_tensors[5], mt)
    out.backward(dot)
    assert torch.equal(mt.grad, torch.zeros_like(mt))
    # a mask of another float type goes to the kernels as float32
    out16 = port_F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mt.detach().to(torch.float64))
    torch.testing.assert_close(out16, out.detach(), atol=0, rtol=0)


def test_wrappers_on_cpu_take_plain_versions_and_check_the_mask():
    q, k, v, do, mask = _inputs(2, 37, 4, 2, 4)
    qt, kt, vt, dot, mt = _t(q, k, v, do, mask)
    out, lse = flash_attention(qt, kt, vt, True, mt)
    ref, ref_lse = flash_attention_plain(qt, kt, vt, True, mt)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    got = flash_attention_bwd(qt, kt, vt, out, dot, lse, True, mt)
    ref_g = flash_attention_bwd_plain(qt, kt, vt, out, dot, lse, True, mt)
    assert all(torch.equal(a, b) for a, b in zip(got, ref_g))
    assert flash_attention.launches == 0
    assert flash_attention_bwd_dq.launches == 0
    assert flash_attention_bwd_dkv.launches == 0
    for bad in (mt[:, :, :5], mt[:, :2], mt[..., None]):
        with pytest.raises(ValueError, match="attn_mask"):
            flash_attention(qt, kt, vt, True, bad)
    with pytest.raises(TypeError, match="additive"):
        flash_attention(qt, kt, vt, True, mt > 0)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_dq(qt, kt, vt, dot, lse, torch.zeros(2, 4, 37),
                               True, mt)


def _jax_sdpa(q, k, v, mask, causal):
    return jax_F.scaled_dot_product_attention(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
        attn_mask=paddle.to_tensor(mask), is_causal=causal).numpy()


@pytest.mark.parametrize("kind", ["bool", "broadcast", "cross"])
@pytest.mark.parametrize("causal", [True, False])
def test_dense_route_warns_and_matches_jax(kind, causal):
    rng = np.random.RandomState(4)
    b, s, h = 2, 9, 4
    q, k, v = (rng.randn(b, s, h, D).astype(np.float32) for _ in range(3))
    if kind == "bool":
        mask = rng.rand(b, 1, s, s) < 0.7
        mask[..., 0] = True
    elif kind == "broadcast":
        mask = np.where(rng.rand(b, 1, 1, s) < 0.3, -1e9,
                        rng.randn(b, 1, 1, s)).astype(np.float32)
    else:                                     # sq != sk
        k, v = (rng.randn(b, s + 4, h, D).astype(np.float32)
                for _ in range(2))
        mask = rng.randn(b, h, s, s + 4).astype(np.float32)
    ref = _jax_sdpa(q, k, v, mask, causal)
    port_F._DENSE_ROUTE_SEEN.clear()
    with pytest.warns(UserWarning, match="dense attention"):
        out = port_F.scaled_dot_product_attention(
            *_t(q, k, v), attn_mask=torch.from_numpy(mask), is_causal=causal)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    with warnings.catch_warnings():            # once per reason
        warnings.simplefilter("error")
        port_F.scaled_dot_product_attention(
            *_t(q, k, v), attn_mask=torch.from_numpy(mask), is_causal=causal)


def test_dropout_raises_unless_not_training():
    # dropout is ported: a rate outside [0, 1) raises, a rate in it drops
    # by the kernels' hash mask of a seed drawn from the generator, and
    # training=False applies none
    q = torch.randn(1, 8, 2, D, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="dropout_p"):
        port_F.scaled_dot_product_attention(q, q, q, dropout_p=1.0)
    gen = torch.Generator().manual_seed(5)
    seed = port_F.draw_seed(torch.Generator().manual_seed(5))
    out = port_F.scaled_dot_product_attention(q, q, q, dropout_p=0.5,
                                              generator=gen)
    ref, _ = flash_attention_plain(q, q, q, False, None, 0.5, seed)
    assert torch.equal(out, ref)
    assert not torch.equal(out, port_F.scaled_dot_product_attention(q, q, q))
    out = port_F.scaled_dot_product_attention(q, q, q, dropout_p=0.1,
                                              training=False)
    assert torch.equal(out, port_F.scaled_dot_product_attention(q, q, q))
