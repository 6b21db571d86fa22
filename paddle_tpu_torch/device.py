"""Device and dtype helpers for the PyTorch port.

Counterparts in the JAX package: ``ops/pallas/__init__.py`` (``on_tpu``:
which backend the kernels may target) and ``core/dtype.py`` (the
Paddle-style dtype names). The port runs on a CUDA card unless a caller
asks for the CPU by name; it never falls back to the CPU on its own.
"""
from __future__ import annotations

import torch

_STR_TO_DTYPE = {
    "float16": torch.float16,
    "fp16": torch.float16,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float32": torch.float32,
    "fp32": torch.float32,
    "float64": torch.float64,
    "fp64": torch.float64,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "uint8": torch.uint8,
    "bool": torch.bool,
}


def to_torch_dtype(dtype) -> torch.dtype:
    """Map a Paddle-style dtype name (``"bfloat16"``, ``"fp32"``, ...) or a
    ``torch.dtype`` to a ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _STR_TO_DTYPE[str(dtype)]
    except KeyError:
        raise ValueError(f"unknown dtype {dtype!r}") from None


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    current CUDA card. Raises when no card is present and the caller did
    not ask for another device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain versions on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def on_hopper(device=None) -> bool:
    """True when ``device`` (default: the current card) is a Hopper GPU
    (compute capability 9.0), the only target the kernels are built for."""
    if not torch.cuda.is_available():
        return False
    return torch.cuda.get_device_capability(device) == (9, 0)
