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
                              flash_attention_plain, keep_mask)
from .fused_ops import (RMSNormFunction, adamw_, adamw_plain, rms_norm,
                        rms_norm_bwd, rms_norm_bwd_plain, rms_norm_plain)

# kernel name -> (the wrapper, its attribute that counts that kernel's
# launches); the forward wrappers count recompute launches too, and the flash
# wrappers count their dropout builds apart
KERNELS = {
    "flash_attention": (flash_attention, "launches"),
    "flash_attention_bwd_dq": (flash_attention_bwd_dq, "launches"),
    "flash_attention_bwd_dkv": (flash_attention_bwd_dkv, "launches"),
    "flash_attention_dropout": (flash_attention, "dropout_launches"),
    "flash_attention_bwd_dq_dropout": (flash_attention_bwd_dq,
                                       "dropout_launches"),
    "flash_attention_bwd_dkv_dropout": (flash_attention_bwd_dkv,
                                        "dropout_launches"),
    "rms_norm": (rms_norm, "launches"),
    "rms_norm_bwd": (rms_norm_bwd, "launches"),
    "adamw": (adamw_, "launches"),
    "block_sparse_attention": (block_sparse_attention_fwd, "launches"),
}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for fn, attr in KERNELS.values():
        setattr(fn, attr, 0)


def launch_counts() -> dict:
    """``{kernel name: launches}`` since the last reset."""
    return {name: getattr(fn, attr) for name, (fn, attr) in KERNELS.items()}


__all__ = ["BlockSparseAttentionFunction", "FlashAttentionFunction",
           "RMSNormFunction", "adamw_", "adamw_plain",
           "block_sparse_attention", "block_sparse_attention_fwd",
           "block_sparse_attention_plain", "compress_block_mask",
           "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
           "flash_attention_bwd_plain", "flash_attention_plain", "keep_mask",
           "rms_norm", "rms_norm_bwd", "rms_norm_bwd_plain", "rms_norm_plain",
           "KERNELS", "launch_counts", "reset_launch_counts"]
