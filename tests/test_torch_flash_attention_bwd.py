"""The port's flash attention backward (paddle_tpu_torch.ops.hopper) against
the JAX package's Pallas backward kernels run in interpret mode.

On the CPU the wrappers take their plain versions, so these tests hold the
plain backward (the kernels' reference on the card) and the autograd
Function that carries it (the code that launches the kernels on the card)
to the TPU kernels' semantics. Tolerance: atol 1e-5 in float32 on
gradients of magnitude up to about 6 (unit-normal inputs, head dim 16):
the dense form sums in another order than the kernels' tiles, and the
gradient of a softmax subtracts nearby numbers (dP - delta), which
magnifies the last-bit differences of the forward's O and LSE. The worst
difference seen against the Pallas kernels is 8.3e-7.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.flash_attention import (_bwd_call, _fwd_call,
                                                   flash_attention_pallas)
from paddle_tpu_torch.nn import functional as port_F
from paddle_tpu_torch.ops.hopper import (FlashAttentionFunction,
                                         flash_attention_bwd,
                                         flash_attention_bwd_dkv,
                                         flash_attention_bwd_dq,
                                         flash_attention_bwd_plain,
                                         flash_attention_plain)

ATOL = 1e-5
D = 16


def _inputs(seed, s, hq, hkv, b=2):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, s, hq, D).astype(np.float32)
    k = rng.randn(b, s, hkv, D).astype(np.float32)
    v = rng.randn(b, s, hkv, D).astype(np.float32)
    do = rng.randn(b, s, hq, D).astype(np.float32)
    return q, k, v, do


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _jax_vjp(q, k, v, do, causal):
    _, vjp = jax.vjp(lambda q_, k_, v_: flash_attention_pallas(
        q_, k_, v_, causal=causal, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _assert_grads(grads, ref):
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        assert tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.detach().numpy(), r, atol=ATOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("s", [64, 37])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_and_autograd_match_pallas_vjp(causal, hq, hkv, s):
    q, k, v, do = _inputs(s + 3 * hkv, s, hq, hkv)
    ref = _jax_vjp(q, k, v, do, causal)

    qt, kt, vt, dot = _t(q, k, v, do)
    out, lse = flash_attention_plain(qt, kt, vt, causal)
    _assert_grads(flash_attention_bwd_plain(qt, kt, vt, out, dot, lse,
                                            causal), ref)

    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    out = port_F.scaled_dot_product_attention(*leaves, is_causal=causal)
    out.backward(dot)
    _assert_grads([t.grad for t in leaves], ref)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_bwd_call(causal, hq, hkv):
    b, s = 2, 64
    q, k, v, do = _inputs(11 + hkv, s, hq, hkv, b=b)

    def to_bh(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(-1, s, D))

    def from_bh(x, h):
        return np.asarray(x).reshape(b, h, s, D).transpose(0, 2, 1, 3)

    seed = jnp.zeros((1,), jnp.int32)
    qb, kb, vb, dob = to_bh(q), to_bh(k), to_bh(v), to_bh(do)
    o_bh, lse_bh = _fwd_call(qb, kb, vb, None, None, seed, causal, 0.0, hq,
                             hkv, 64, 64, True)
    dq, dk, dv = _bwd_call(qb, kb, vb, o_bh, dob, lse_bh, None, None, seed,
                           causal, 0.0, hq, hkv, 64, 64, True)

    qt, kt, vt, dot = _t(q, k, v, do)
    out, lse = flash_attention_plain(qt, kt, vt, causal)
    grads = flash_attention_bwd_plain(qt, kt, vt, out, dot, lse, causal)
    _assert_grads(grads, [from_bh(dq, hq), from_bh(dk, hkv),
                          from_bh(dv, hkv)])


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_torch_autograd(causal, hq, hkv):
    # autograd through the plain forward is an independent derivation of
    # the same gradients (it differentiates the softmax, not P * (dP - delta))
    q, k, v, do = _inputs(5 + hkv, 37, hq, hkv)
    leaves = [t.requires_grad_() for t in _t(q, k, v)]
    out, lse = flash_attention_plain(*leaves, causal=causal)
    out.backward(torch.from_numpy(do))
    with torch.no_grad():
        grads = flash_attention_bwd_plain(*leaves, out, torch.from_numpy(do),
                                          lse, causal)
    _assert_grads(grads, [t.grad.numpy() for t in leaves])


def test_function_saves_forward_residuals_and_lse_is_not_differentiable():
    q, k, v, do = _t(*_inputs(9, 20, 4, 2))
    leaves = [t.requires_grad_() for t in (q, k, v)]
    out, lse = FlashAttentionFunction.apply(*leaves, True)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    assert not lse.requires_grad
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5 and saved[3].shape == out.shape
    assert torch.equal(saved[4], lse)


def test_wrappers_on_cpu_take_plain_version_without_launching():
    q, k, v, do = _t(*_inputs(3, 37, 4, 2))
    out, lse = flash_attention_plain(q, k, v, True)
    ref = flash_attention_bwd_plain(q, k, v, out, do, lse, True)
    got = flash_attention_bwd(q, k, v, out, do, lse, True)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert flash_attention_bwd_dq.launches == 0
    assert flash_attention_bwd_dkv.launches == 0
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, out, do, lse[:, :2], True)
    delta = torch.zeros(2, 4, 37)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_dq(q, k, v, do, lse, delta, True)
