"""The rounding of the bf16 flash attention backward kernels, on the CPU.

On the card, bf16 gradients go through tensor-core kernels
(``csrc/flash_attention_bwd.cu``, ``flash_bwd_dq_wgmma`` and
``flash_bwd_dkv_wgmma``) that round P and dS to bf16 before the three
second products (dV = P^T dO, dK = dS^T Q, dQ = dS K), as
FlashAttention-2/3 do, where the plain version keeps them in float32.
``_kernel_arithmetic`` below repeats the kernels' arithmetic in float32
PyTorch: bf16 inputs, S = (Q K^T) scale + mask, P = exp(S - LSE) with the
dropped scores exactly 0, P and dS rounded to the inputs' type, float32
sums, dK and dQ scaled at the end, the GQA group summed in float32 and
rounded once. The tests hold it to ``flash_attention_bwd_plain`` within
``chip_smoke.py``'s bf16 backward tolerance (one bf16 ulp at the largest
magnitude, copied below), the bound the kernels are held to on the card,
so the design's extra rounding is shown to fit before any card runs it.
With float32 inputs nothing is rounded: the helper and the plain version
then agree with the JAX package's ``_bwd_call`` (interpret mode) at
atol 1e-5, the tolerance of ``test_torch_flash_attention_bwd.py``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.flash_attention import _bwd_call, _fwd_call
from paddle_tpu_torch.ops.hopper import (flash_attention_bwd_plain,
                                         flash_attention_plain)


def bwd_tolerance(ref, dtype):
    """chip_smoke.py's tolerance of the backward kernels: bf16 one ulp at
    the largest magnitude (2^-7 relative), float32 1e-4."""
    scale = max(1.0, float(ref.float().abs().max()))
    return scale * (2.0 ** -7 if dtype == torch.bfloat16 else 1e-4)


def _kernel_arithmetic(q, k, v, out, dout, lse, causal, mask=None):
    """(dq, dk, dv) as the tensor-core kernels compute them."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qf = q.float().transpose(1, 2)               # not pre-scaled
    kf, vf = (t.float().transpose(1, 2).repeat_interleave(group, dim=1)
              for t in (k, v))
    dof = dout.float().transpose(1, 2)
    scores = (qf @ kf.transpose(-1, -2)) * scale
    if mask is not None:
        scores = scores + mask.float()
    keep = torch.ones(s, s, dtype=torch.bool)
    if causal:
        keep = keep.tril()
    p = torch.where(keep, torch.exp(scores - lse.unsqueeze(-1)), 0.0)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
    ds = p * (dof @ vf.transpose(-1, -2) - delta.unsqueeze(-1))
    p_r, ds_r = (t.to(q.dtype).float() for t in (p, ds))
    dq = (ds_r @ kf) * scale
    dk = (ds_r.transpose(-1, -2) @ qf) * scale
    dv = p_r.transpose(-1, -2) @ dof

    def per_kv_head(x):                # float32 group sum, then one rounding
        return x.reshape(b, hkv, group, s, d).sum(2).transpose(1, 2)

    return (dq.transpose(1, 2).to(q.dtype), per_kv_head(dk).to(k.dtype),
            per_kv_head(dv).to(v.dtype))


def _inputs(seed, s, hq, hkv, d, dtype, mask=False, b=1):
    rng = np.random.RandomState(seed)
    q, do = (torch.from_numpy(rng.randn(b, s, hq, d).astype(np.float32))
             .to(dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(b, s, hkv, d).astype(np.float32))
            .to(dtype) for _ in range(2))
    m = None
    if mask:
        m = np.where(rng.rand(b, 1, s, s) < 0.3, -1e9,
                     rng.randn(b, 1, s, s)).astype(np.float32)
        m[0, :, s // 3, :] = -1e9                # a row hidden entirely
        m = torch.from_numpy(m)
    return q, k, v, do, m


def _check_within_tolerance(q, k, v, do, causal, mask):
    out, lse = flash_attention_plain(q, k, v, causal, mask)
    got = _kernel_arithmetic(q, k, v, out, do, lse, causal, mask)
    ref = flash_attention_bwd_plain(q, k, v, out, do, lse, causal, mask)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        err = float((g.float() - r.float()).abs().max())
        assert err <= bwd_tolerance(r, q.dtype), (name, err)


@pytest.mark.parametrize("s", [300, 1000])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_rounding_within_the_card_tolerance(causal, hq, hkv, d, s):
    q, k, v, do, _ = _inputs(s + d + hkv + causal, s, hq, hkv, d,
                             torch.bfloat16)
    _check_within_tolerance(q, k, v, do, causal, None)


@pytest.mark.parametrize("causal,hq,hkv,d,s", [
    (False, 4, 1, 128, 1000), (True, 4, 4, 64, 300)])
def test_bf16_rounding_under_a_mask_with_a_hidden_row(causal, hq, hkv, d, s):
    q, k, v, do, mask = _inputs(7 + s, s, hq, hkv, d, torch.bfloat16,
                                mask=True)
    _check_within_tolerance(q, k, v, do, causal, mask)


def test_float32_arithmetic_matches_pallas_bwd_call():
    b, s, hq, hkv, d, causal = 2, 64, 4, 2, 16, True
    q, k, v, do, mask = _inputs(3, s, hq, hkv, d, torch.float32, mask=True,
                                b=b)

    def to_bh(x):
        return jnp.asarray(x.numpy().transpose(0, 2, 1, 3).reshape(-1, s, d))

    def from_bh(x, h):
        return np.asarray(x).reshape(b, h, s, d).transpose(0, 2, 1, 3)

    seed = jnp.zeros((1,), jnp.int32)
    qb, kb, vb, dob = to_bh(q), to_bh(k), to_bh(v), to_bh(do)
    jmask = jnp.asarray(mask.numpy())
    o_bh, lse_bh = _fwd_call(qb, kb, vb, jmask, None, seed, causal, 0.0, hq,
                             hkv, 64, 64, True)
    ref = _bwd_call(qb, kb, vb, o_bh, dob, lse_bh, jmask, None, seed, causal,
                    0.0, hq, hkv, 64, 64, True)
    ref = [from_bh(ref[0], hq), from_bh(ref[1], hkv), from_bh(ref[2], hkv)]

    out, lse = flash_attention_plain(q, k, v, causal, mask)
    for grads in (_kernel_arithmetic(q, k, v, out, do, lse, causal, mask),
                  flash_attention_bwd_plain(q, k, v, out, do, lse, causal,
                                            mask)):
        for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
            np.testing.assert_allclose(g.numpy(), r, atol=1e-5, rtol=0,
                                       err_msg=name)
