"""Hand-written Hopper (sm_90a) kernels, each beside its plain PyTorch
version and with a launch counter on its wrapper.

Counterpart of ``paddle_tpu/ops/pallas/``. Sources live in ``csrc/`` and are
built with ``nvcc`` at first use (``_build.py``); importing this package
builds nothing.
"""
from .flash_attention import flash_attention, flash_attention_plain
from .fused_ops import rms_norm, rms_norm_plain

KERNELS = (flash_attention, rms_norm)


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in KERNELS:
        fn.launches = 0


__all__ = ["flash_attention", "flash_attention_plain", "rms_norm",
           "rms_norm_plain", "KERNELS", "reset_launch_counts"]
