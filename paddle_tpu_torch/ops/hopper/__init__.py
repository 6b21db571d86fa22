"""Hand-written Hopper (sm_90a) kernels, each beside its plain PyTorch
version and with a launch counter on its wrapper.

Counterpart of ``paddle_tpu/ops/pallas/``. Sources live in ``csrc/`` and are
built with ``nvcc`` at first use (``_build.py``); importing this package
builds nothing.
"""
from .block_sparse_attention import (BlockSparseAttentionFunction,
                                     block_sparse_attention,
                                     block_sparse_attention_fwd,
                                     block_sparse_attention_plain,
                                     compress_block_mask)
from .flash_attention import (FlashAttentionFunction, flash_attention,
                              flash_attention_bwd, flash_attention_bwd_dkv,
                              flash_attention_bwd_dq,
                              flash_attention_bwd_plain,
                              flash_attention_plain)
from .fused_ops import (RMSNormFunction, adamw_, adamw_plain, rms_norm,
                        rms_norm_bwd, rms_norm_bwd_plain, rms_norm_plain)

# kernel name -> the wrapper whose ``launches`` counts that kernel's launches
# (the forward wrappers count recompute launches too)
KERNELS = {
    "flash_attention": flash_attention,
    "flash_attention_bwd_dq": flash_attention_bwd_dq,
    "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
    "rms_norm": rms_norm,
    "rms_norm_bwd": rms_norm_bwd,
    "adamw": adamw_,
    "block_sparse_attention": block_sparse_attention_fwd,
}


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    """``{kernel name: launches}`` since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = ["BlockSparseAttentionFunction", "FlashAttentionFunction",
           "RMSNormFunction", "adamw_", "adamw_plain",
           "block_sparse_attention", "block_sparse_attention_fwd",
           "block_sparse_attention_plain", "compress_block_mask",
           "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
           "flash_attention_bwd_plain", "flash_attention_plain", "rms_norm",
           "rms_norm_bwd", "rms_norm_bwd_plain", "rms_norm_plain", "KERNELS",
           "launch_counts", "reset_launch_counts"]
