"""Weights from the JAX package's Llama into the port's.

Both use the same state-dict names (``model.layers.{i}.self_attn.q_proj.
weight`` and so on). The JAX ``Linear`` stores ``[in, out]`` (y = x @ W);
the port stores PyTorch's ``[out, in]``, so projection and LM-head weights
are transposed. Embeddings and norm weights carry over as they are.
"""
from __future__ import annotations

import numpy as np
import torch


def _is_linear(name: str) -> bool:
    return name.endswith("_proj.weight") or name == "lm_head.weight"


def llama_state_from_paddle_tpu(np_state: dict) -> dict:
    """Map ``{name: np.ndarray}`` from a ``paddle_tpu`` Llama state dict to
    ``{name: torch.Tensor}`` (CPU, same dtype) for
    ``LlamaForCausalLM.load_state_dict``."""
    out = {}
    for name, arr in np_state.items():
        arr = np.asarray(arr)
        if _is_linear(name):
            if arr.ndim != 2:
                raise ValueError(f"{name}: expected a 2-D weight, got "
                                 f"shape {arr.shape}")
            arr = arr.T
        out[name] = torch.tensor(arr)  # a copy: JAX arrays are read-only
    return out
