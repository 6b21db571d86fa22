"""RMSNorm forward: the hand-written Hopper kernel and its plain version.

Counterpart: ``paddle_tpu/ops/pallas/fused_ops.py`` (``_rms_fwd_kernel``
through ``_rms_fwd_call`` and ``rms_norm_pallas``). The kernel is
``csrc/rms_norm.cu``. The backward kernel and the fused AdamW kernel of
that module are not ported yet.
"""
from __future__ import annotations

import ctypes

import torch

from ...device import on_hopper
from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {"rms_norm_fwd": [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                ctypes.c_int, ctypes.c_void_p]}


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
    any width.

    A CPU tensor takes :func:`rms_norm_plain`. A CUDA tensor launches the
    kernel on the current stream or raises; there is no fallback.
    """
    h = x.shape[-1]
    if weight.shape != (h,):
        raise ValueError(f"rms_norm: weight shape {tuple(weight.shape)} "
                         f"does not match hidden size {h}")
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps)
    if x.device.type != "cuda" or weight.device != x.device:
        raise ValueError("rms_norm: x and weight must be on one CUDA device "
                         f"(got {x.device}, {weight.device})")
    if x.dtype not in _DTYPE_CODES or weight.dtype != x.dtype:
        raise TypeError(f"rms_norm: kernel takes float32 or bfloat16 with a "
                        f"weight of the same type, got {x.dtype}, "
                        f"{weight.dtype}")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rms_norm: inputs must be contiguous")
    if not on_hopper(x.device):
        raise RuntimeError("rms_norm: the kernel is built for Hopper "
                           "(sm_90a) only")
    rows = x.numel() // h if h else 0
    y = torch.empty_like(x)
    rstd = torch.empty(*x.shape[:-1], 1, dtype=torch.float32,
                       device=x.device)
    if rows == 0 or h == 0:
        return y, rstd
    lib = _build.load("rms_norm", _SIGNATURES)
    err = lib.rms_norm_fwd(x.data_ptr(), weight.data_ptr(), y.data_ptr(),
                           rstd.data_ptr(), rows, h, float(eps),
                           _DTYPE_CODES[x.dtype],
                           torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "rms_norm_fwd")
    rms_norm.launches += 1
    return y, rstd


rms_norm.launches = 0
