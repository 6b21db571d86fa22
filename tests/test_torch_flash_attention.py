"""The port's flash attention (paddle_tpu_torch.ops.hopper.flash_attention)
against the JAX package's Pallas kernel run in interpret mode.

On the CPU the wrapper takes its plain version, so these tests hold the
plain version (the kernel's reference on the card) to the TPU kernel's
semantics. Tolerance: atol 2e-5 in float32, since the dense form sums in
another order than the kernel's tiles.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas.flash_attention import (_fwd_call,
                                                   flash_attention_pallas)
from paddle_tpu_torch.ops.hopper import flash_attention, flash_attention_plain

ATOL = 2e-5
D = 16


def _qkv(seed, s, hq, hkv, b=2):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, s, hq, D).astype(np.float32)
    k = rng.randn(b, s, hkv, D).astype(np.float32)
    v = rng.randn(b, s, hkv, D).astype(np.float32)
    return q, k, v


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("s", [64, 37])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_interpret(causal, hq, hkv, s):
    q, k, v = _qkv(s + hkv, s, hq, hkv)
    ref = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True))
    out, lse = flash_attention_plain(*_t(q, k, v), causal=causal)
    assert out.dtype == torch.float32 and tuple(out.shape) == q.shape
    assert tuple(lse.shape) == (2, hq, s)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_lse_matches_pallas_fwd_call(causal, hq, hkv):
    b, s = 2, 64
    q, k, v = _qkv(7 + hkv, s, hq, hkv, b=b)

    def to_bh(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(-1, s, D))

    out_bh, lse_bh = _fwd_call(to_bh(q), to_bh(k), to_bh(v), None, None,
                               jnp.zeros((1,), jnp.int32), causal, 0.0, hq,
                               hkv, 64, 64, True)
    out, lse = flash_attention_plain(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(lse_bh).reshape(b, hq, s), atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        out.numpy(),
        np.asarray(out_bh).reshape(b, hq, s, D).transpose(0, 2, 1, 3),
        atol=ATOL, rtol=0)


def test_wrapper_on_cpu_takes_plain_version_without_launching():
    q, k, v = _t(*_qkv(3, 37, 4, 2))
    out, lse = flash_attention(q, k, v, causal=True)
    ref_out, ref_lse = flash_attention_plain(q, k, v, causal=True)
    assert flash_attention.launches == 0
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)


def test_wrapper_rejects_mismatched_shapes():
    q, k, v = _t(*_qkv(4, 32, 4, 2))
    with pytest.raises(ValueError, match="sequence lengths differ"):
        flash_attention(q, k[:, :16], v[:, :16])
    with pytest.raises(ValueError, match="GQA"):
        flash_attention(q[:, :, :3], k, v)
