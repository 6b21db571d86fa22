"""The port's attention dropout (paddle_tpu_torch.ops.hopper.keep_mask, the
plain flash forward and backward with ``dropout_p`` and ``seed``, and the
autograd Function that carries the seed to the backward) against the JAX
package's Pallas kernels in interpret mode, and the attention routing of
the functional layer.

The keep mask is the JAX interpret path's murmur3 hash of the absolute
(row, column), ``batch * hq + q_head`` and the seed, so the port's bits
must equal ``_keep_mask``'s exactly. The forward and its grads are held to
``flash_attention_pallas(..., dropout_p, seed, interpret=True)`` and its
vjp at atol 1e-5 in float32 (the tolerance of
``test_torch_flash_attention_bwd.py``: the dense form sums in another order
than the kernels' tiles; kept entries are scaled by the same float32
``1 / (1 - p)`` on both sides).

The routing cases are decided on ``meta`` tensors, which stand for the card
without one: the kernels take head dims 64 and 128 and float32 or
bfloat16, so other calls go to the dense route with a one-time warning, and
strided inputs are copied to the kernels' layout.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.flash_attention import (_keep_mask,
                                                   flash_attention_pallas)
from paddle_tpu_torch.nn import functional as port_F
from paddle_tpu_torch.nn import functional_extras as port_FE
from paddle_tpu_torch.ops.hopper import (FlashAttentionFunction,
                                         flash_attention,
                                         flash_attention_bwd,
                                         flash_attention_bwd_plain,
                                         flash_attention_plain, keep_mask)

ATOL = 1e-5
D = 16
SEEDS = (0, 7, -123456789, 2 ** 31 - 1)


def _jax_bits(seed, bh, s, p):
    """The JAX interpret path's keep mask of plane ``bh`` as one tile."""
    return np.asarray(_keep_mask(jnp.asarray([seed], jnp.int32),
                                 jnp.int32(bh), 0, 0, 1, 1, 0, 0, (s, s), p,
                                 False))


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_keep_mask_bits_equal_the_jax_interpret_path(p):
    b, hq, s = 2, 3, 40
    for seed in SEEDS:
        bits = keep_mask(b, hq, s, seed, p).reshape(b * hq, s, s).numpy()
        for bh in range(b * hq):
            np.testing.assert_array_equal(bits[bh], _jax_bits(seed, bh, s, p),
                                          err_msg=f"seed {seed}, bh {bh}")


def test_keep_mask_is_a_function_of_the_seed():
    a = keep_mask(2, 4, 64, 11, 0.3)
    assert torch.equal(a, keep_mask(2, 4, 64, 11, 0.3))
    assert not torch.equal(a, keep_mask(2, 4, 64, 12, 0.3))
    # the seed wraps to uint32, as the JAX package's astype does
    assert torch.equal(keep_mask(1, 2, 16, -1, 0.3),
                       keep_mask(1, 2, 16, 2 ** 32 - 1, 0.3))
    assert abs(float(a.float().mean()) - 0.7) < 0.02


def _inputs(seed, s, hq, hkv, mask, b=2):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, s, hq, D).astype(np.float32)
    k = rng.randn(b, s, hkv, D).astype(np.float32)
    v = rng.randn(b, s, hkv, D).astype(np.float32)
    do = rng.randn(b, s, hq, D).astype(np.float32)
    m = None
    if mask:
        m = np.where(rng.rand(b, 1, s, s) < 0.3, -1e9,
                     rng.randn(b, 1, s, s)).astype(np.float32)
    return q, k, v, do, m


# causal and not, MHA and GQA 4:2, a ragged length (the JAX entry pads 200
# to 256), an additive mask, rates and seeds (one negative) apart
@pytest.mark.parametrize("causal,hq,hkv,s,mask,p,seed", [
    (True, 4, 4, 64, False, 0.1, 3), (False, 4, 2, 200, False, 0.5, -77),
    (True, 4, 2, 64, True, 0.9, 2 ** 31 - 1)])
def test_forward_and_grads_match_pallas_with_dropout(causal, hq, hkv, s,
                                                     mask, p, seed):
    q, k, v, do, m = _inputs(s + hkv, s, hq, hkv, mask)
    jm = None if m is None else jnp.asarray(m)
    ref, vjp = jax.vjp(lambda q_, k_, v_: flash_attention_pallas(
        q_, k_, v_, causal=causal, attn_mask=jm, dropout_p=p, seed=seed,
        interpret=True), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_grads = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    mt = None if m is None else torch.from_numpy(m)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out, lse = FlashAttentionFunction.apply(*leaves, causal, mt, p, seed)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ATOL, rtol=0)
    out.backward(torch.from_numpy(do))
    for name, t, r in zip(("dq", "dk", "dv"), leaves, ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), r, atol=ATOL, rtol=0,
                                   err_msg=name)
    # the forward saved the seed for the backward, and the LSE is the
    # undropped one
    _, ref_lse = flash_attention_plain(*(t.detach() for t in leaves),
                                       causal, mt)
    assert torch.equal(lse, ref_lse)


def test_plain_dropout_backward_matches_torch_autograd():
    # autograd through the plain forward differentiates the dropped softmax
    # itself: an independent derivation of the plain backward's dS and dV
    q, k, v, do, _ = _inputs(4, 37, 4, 2, False)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out, lse = flash_attention_plain(*leaves, True, None, 0.4, 99)
    out.backward(torch.from_numpy(do))
    with torch.no_grad():
        grads = flash_attention_bwd_plain(*leaves, out, torch.from_numpy(do),
                                          lse, True, None, 0.4, 99)
    for name, g, t in zip(("dq", "dk", "dv"), grads, leaves):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), atol=ATOL,
                                   rtol=0, err_msg=name)


def test_wrappers_on_cpu_take_plain_versions_with_the_seed():
    q, k, v, do, _ = (torch.from_numpy(x) if x is not None else None
                      for x in _inputs(8, 33, 4, 2, False))
    out, lse = flash_attention(q, k, v, True, None, 0.25, 6)
    ref, ref_lse = flash_attention_plain(q, k, v, True, None, 0.25, 6)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    other, _ = flash_attention(q, k, v, True, None, 0.25, 7)
    assert not torch.equal(out, other)
    got = flash_attention_bwd(q, k, v, out, do, lse, True, None, 0.25, 6)
    ref_g = flash_attention_bwd_plain(q, k, v, out, do, lse, True, None,
                                      0.25, 6)
    assert all(torch.equal(a, b) for a, b in zip(got, ref_g))
    assert flash_attention.launches == flash_attention.dropout_launches == 0
    for bad in (-0.1, 1.0):
        with pytest.raises(ValueError, match="dropout_p"):
            flash_attention(q, k, v, True, None, bad, 6)


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_routes_agree_under_dropout(causal):
    # the flash route (plain on the CPU) and the dense route drop the same
    # entries: one seed per call from the generator, the same hash mask
    q, k, v, _, _ = _inputs(21, 24, 4, 4, False)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    flash = port_F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, dropout_p=0.3,
        generator=torch.Generator().manual_seed(1))
    seed = port_F.draw_seed(torch.Generator().manual_seed(1))
    dense = port_F._dense_attention(qt, kt, vt, None, causal, 0.3, seed)
    np.testing.assert_allclose(flash.numpy(), dense.numpy(), atol=ATOL,
                               rtol=0)
    again = port_F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, dropout_p=0.3,
        generator=torch.Generator().manual_seed(2))
    assert not torch.equal(flash, again)


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("d,dtype,eligible", [
    (16, torch.bfloat16, False), (96, torch.bfloat16, False),
    (64, torch.float16, False), (64, torch.bfloat16, True),
    (128, torch.float32, True)])
def test_flash_route_takes_what_the_kernel_takes(d, dtype, eligible):
    q = _meta((2, 32, 4, d), dtype)
    port_F._DENSE_ROUTE_SEEN.clear()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        assert port_F.flash_eligible(q, q, None) is eligible
    assert bool(seen) is not eligible
    if not eligible:
        assert "dense attention" in str(seen[0].message)
    # the CPU's plain versions take any head dim and type
    cpu = torch.zeros(2, 32, 4, d, dtype=dtype)
    assert port_F.flash_eligible(cpu, cpu, None)


def test_strided_inputs_take_the_flash_route_as_copies():
    # GPT-2 slices q, k and v out of one projection: strided views
    meta = _meta((2, 16, 3, 4, 64)).unbind(2)
    assert not meta[0].is_contiguous()
    assert port_F.flash_eligible(meta[0], meta[1], None)
    qkv = torch.randn(2, 16, 3, 4, D, generator=torch.Generator()
                      .manual_seed(3)).requires_grad_()
    out = port_F.scaled_dot_product_attention(*qkv.unbind(2), is_causal=True)
    assert isinstance(out.grad_fn, FlashAttentionFunction._backward_cls)
    out.sum().backward()
    ref = flash_attention_plain(*(t.contiguous()
                                  for t in qkv.detach().unbind(2)), True)[0]
    assert torch.equal(out.detach(), ref)
    assert qkv.grad is not None and bool(qkv.grad.abs().sum() > 0)
    assert port_F._kernel_layout(ref) is ref


def test_sparse_route_takes_what_the_kernel_takes():
    bm = np.ones((2, 2), bool)
    assert port_FE.kernel_route(_meta((1, 2, 256, 128)), bm)
    assert not port_FE.kernel_route(_meta((1, 2, 256, 160)), bm)
    assert not port_FE.kernel_route(_meta((1, 2, 256, 64), torch.float16),
                                    bm)
    assert not port_FE.kernel_route(_meta((1, 2, 256, 20)), bm)
    assert not port_FE.kernel_route(_meta((1, 2, 256, 64)), None)
    # the plain version takes d = 160 on the CPU, as the JAX package routes
    assert port_FE.kernel_route(torch.zeros(1, 2, 256, 160), bm)
