"""RMSNorm (forward and backward) and the single-pass AdamW update: the
hand-written Hopper kernels and their plain versions.

Counterpart: ``paddle_tpu/ops/pallas/fused_ops.py`` (``_rms_fwd_kernel``,
``_rms_bwd_kernel`` and the ``rms_norm_pallas`` custom vjp;
``_adamw_kernel`` through ``adamw_pallas``). The kernels are
``csrc/rms_norm.cu`` and ``csrc/adamw.cu``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...device import on_hopper
from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_RMS_SIGNATURES = {
    "rms_norm_fwd": [_P, _P, _P, _P, _I, _I, _F, _I, _P],
    "rms_norm_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}
_ADAMW_SIGNATURES = {
    "adamw_update": [_P, _P, _P, _P, _P, ctypes.c_longlong] + [_F] * 9 +
                    [_I, _I, _P],
}
# row-pass blocks of the RMSNorm backward (4 per SM of an H100), each with
# its own float32 dw partial of the row width in shared memory
_RMS_BWD_PARTS = 132 * 4
_RMS_BWD_MAX_WIDTH = 200 * 1024 // 4


def _check_card(what, *tensors):
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: tensors must be on one CUDA device (got "
                         f"{[str(t.device) for t in tensors]})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: inputs must be contiguous")
    if not on_hopper(dev):
        raise RuntimeError(f"{what}: the kernel is built for Hopper (sm_90a) "
                           "only")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


# -- RMSNorm ------------------------------------------------------------------

def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    """y = x * rsqrt(mean(x^2) + eps) * w in float32, rounded to x's type
    once (the TPU kernel's rounding); also returns rstd, float32
    ``[..., 1]``."""
    xf = x.float()
    rstd = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf * rstd * weight.float()).to(x.dtype), rstd


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    """Fused RMSNorm over the last dimension: ``(y, rstd)`` with y of x's
    type and shape and rstd float32 ``[..., 1]``. Any leading dimensions,
    any width. No autograd history: ``nn.functional.rms_norm`` wraps this in
    :class:`RMSNormFunction`.

    A CPU tensor takes :func:`rms_norm_plain`. A CUDA tensor launches the
    kernel on the current stream or raises; there is no fallback.
    """
    h = x.shape[-1]
    if weight.shape != (h,):
        raise ValueError(f"rms_norm: weight shape {tuple(weight.shape)} "
                         f"does not match hidden size {h}")
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps)
    _check_card("rms_norm", x, weight)
    if x.dtype not in _DTYPE_CODES or weight.dtype != x.dtype:
        raise TypeError(f"rms_norm: kernel takes float32 or bfloat16 with a "
                        f"weight of the same type, got {x.dtype}, "
                        f"{weight.dtype}")
    rows = x.numel() // h if h else 0
    y = torch.empty_like(x)
    rstd = torch.empty(*x.shape[:-1], 1, dtype=torch.float32,
                       device=x.device)
    if rows == 0 or h == 0:
        return y, rstd
    lib = _build.load("rms_norm", _RMS_SIGNATURES)
    err = lib.rms_norm_fwd(x.data_ptr(), weight.data_ptr(), y.data_ptr(),
                           rstd.data_ptr(), rows, h, float(eps),
                           _DTYPE_CODES[x.dtype], _stream(x))
    _build.check(lib, err, "rms_norm_fwd")
    rms_norm.launches += 1
    return y, rstd


rms_norm.launches = 0


def rms_norm_bwd_plain(x, w, g, rstd):
    """The TPU kernel's backward in float32: with c = sum(g w x) / h per
    row, dx = (g w - x c rstd^2) rstd in x's type and dw = sum over rows of
    g x rstd in w's type."""
    h = x.shape[-1]
    xf, gf = x.float().reshape(-1, h), g.float().reshape(-1, h)
    r = rstd.reshape(-1, 1)
    gw = gf * w.float()
    c = (gw * xf).sum(-1, keepdim=True) / h
    dx = (gw - xf * c * r * r) * r
    dw = (gf * xf * r).sum(0)
    return dx.reshape(x.shape).to(x.dtype), dw.to(w.dtype)


def rms_norm_bwd(x, w, g, rstd):
    """RMSNorm backward: ``(dx, dw)`` from the forward's input ``x``, weight
    ``w``, the output gradient ``g`` (x's type and shape) and ``rstd``.

    A CPU tensor takes :func:`rms_norm_bwd_plain`. A CUDA tensor launches
    the row pass and the column sum of dw's partials on the current stream
    (counted as one launch) or raises. Widths up to 51,200.
    """
    h = x.shape[-1]
    if g.shape != x.shape or w.shape != (h,) or \
            rstd.numel() * h != x.numel():
        raise ValueError("rms_norm_bwd: x and g [..., h], w [h] and rstd "
                         f"[..., 1] expected, got {tuple(x.shape)}, "
                         f"{tuple(g.shape)}, {tuple(w.shape)}, "
                         f"{tuple(rstd.shape)}")
    if x.device.type == "cpu":
        return rms_norm_bwd_plain(x, w, g, rstd)
    _check_card("rms_norm_bwd", x, w, g, rstd)
    if x.dtype not in _DTYPE_CODES or not (w.dtype == g.dtype == x.dtype) \
            or rstd.dtype != torch.float32:
        raise TypeError("rms_norm_bwd: x, w, g of one type (float32 or "
                        f"bfloat16) and float32 rstd expected, got {x.dtype}"
                        f", {w.dtype}, {g.dtype}, {rstd.dtype}")
    if h > _RMS_BWD_MAX_WIDTH:
        raise ValueError(f"rms_norm_bwd: width {h} exceeds "
                         f"{_RMS_BWD_MAX_WIDTH} (the dw partial lives in "
                         "shared memory)")
    rows = x.numel() // h if h else 0
    dx = torch.empty_like(x)
    if rows == 0 or h == 0:
        return dx, torch.zeros_like(w)
    dw = torch.empty_like(w)
    parts = min(rows, _RMS_BWD_PARTS)
    dw_part = torch.empty(parts, h, dtype=torch.float32, device=x.device)
    lib = _build.load("rms_norm", _RMS_SIGNATURES)
    err = lib.rms_norm_bwd(x.data_ptr(), w.data_ptr(), g.data_ptr(),
                           rstd.data_ptr(), dx.data_ptr(), dw.data_ptr(),
                           dw_part.data_ptr(), rows, h, parts,
                           _DTYPE_CODES[x.dtype], _stream(x))
    _build.check(lib, err, "rms_norm_bwd")
    rms_norm_bwd.launches += 1
    return dx, dw


rms_norm_bwd.launches = 0


class RMSNormFunction(torch.autograd.Function):
    """RMSNorm with its backward kernel: saves ``(x, w, rstd)``, the
    residuals of the JAX package's custom vjp (``_rms_vjp_fwd``)."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        y, rstd = rms_norm(x, weight, eps)
        ctx.save_for_backward(x, weight, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, rstd = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, weight, g.contiguous(), rstd)
        return dx, dw, None


# -- AdamW --------------------------------------------------------------------

def _scalars(lr, beta1, beta2, eps, weight_decay, bc1, bc2):
    """The kernel's nine float32 scalars, as Python floats (exact):
    lr, beta1, beta2, 1 - beta1, 1 - beta2, eps, 1 - lr * weight_decay,
    bc1, bc2. The differences are formed in double precision and rounded
    once, as the JAX package's XLA update forms them."""
    return [float(np.float32(a)) for a in (
        lr, beta1, beta2, 1.0 - beta1, 1.0 - beta2, eps,
        1.0 - lr * weight_decay, bc1, bc2)]


def adamw_plain(p, m, v, g, *, lr, beta1, beta2, eps, weight_decay, bc1,
                bc2):
    """The TPU kernel's update in float32: returns ``(p_new in p's type,
    m_new, v_new)``. ``bc1``/``bc2`` are ``1 - beta^t``."""
    lr, b1, b2, c1, c2, eps, keep, bc1, bc2 = _scalars(
        lr, beta1, beta2, eps, weight_decay, bc1, bc2)
    pf, gf = p.float(), g.float()
    m_new = m.float() * b1 + gf * c1
    v_new = v.float() * b2 + gf * c2 * gf
    m_hat = m_new / bc1
    v_hat = v_new / bc2
    p_new = pf * keep - m_hat * lr / (torch.sqrt(v_hat) + eps)
    return p_new.to(p.dtype), m_new, v_new


def adamw_(p, m, v, g, *, lr, beta1, beta2, eps, weight_decay, bc1, bc2,
           p_lowp=None):
    """AdamW in place: ``p``, ``m``, ``v`` are overwritten with the update
    of :func:`adamw_plain`, and ``p_lowp`` (a bf16 tensor of p's size),
    when given, receives p_new rounded to bf16 in the same pass.

    p: float32 (a master weight) or bf16; m, v: float32; g: float32 or bf16;
    all of one size. A CPU tensor takes :func:`adamw_plain`. A CUDA tensor
    launches the kernel on the current stream (one launch per tensor) or
    raises.
    """
    tensors = [p, m, v, g] + ([] if p_lowp is None else [p_lowp])
    if any(t.numel() != p.numel() for t in tensors):
        raise ValueError("adamw_: p, m, v, g (and p_lowp) must have one "
                         f"size, got {[tuple(t.shape) for t in tensors]}")
    hyper = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
                 weight_decay=weight_decay, bc1=bc1, bc2=bc2)
    if p.device.type == "cpu":
        p_new, m_new, v_new = adamw_plain(p, m, v, g, **hyper)
        p.copy_(p_new)
        m.copy_(m_new)
        v.copy_(v_new)
        if p_lowp is not None:
            p_lowp.copy_(p_new)
        return p
    _check_card("adamw_", *tensors)
    if p.dtype not in _DTYPE_CODES or g.dtype not in _DTYPE_CODES or \
            m.dtype != torch.float32 or v.dtype != torch.float32 or \
            (p_lowp is not None and p_lowp.dtype != torch.bfloat16):
        raise TypeError("adamw_: p and g float32 or bfloat16, m and v "
                        "float32, p_lowp bfloat16 expected, got "
                        f"{[t.dtype for t in tensors]}")
    if p.numel() == 0:
        return p
    lib = _build.load("adamw", _ADAMW_SIGNATURES)
    err = lib.adamw_update(
        p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(),
        None if p_lowp is None else p_lowp.data_ptr(), p.numel(),
        *_scalars(**hyper), _DTYPE_CODES[p.dtype],
        _DTYPE_CODES[g.dtype], _stream(p))
    _build.check(lib, err, "adamw_update")
    adamw_.launches += 1
    return p


adamw_.launches = 0
