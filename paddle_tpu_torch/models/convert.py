"""Weights from the JAX package's Llama into the port's.

Both use the same state-dict names (``model.layers.{i}.self_attn.q_proj.
weight`` and so on). The JAX ``Linear`` stores ``[in, out]`` (y = x @ W);
the port stores PyTorch's ``[out, in]``, so projection and LM-head weights
are transposed. Embeddings and norm weights carry over as they are.

A JAX model built with ``scan_layers=True`` keeps its decoder stack as
stacked ``[L, ...]`` arrays (``model.layers_scanned.q_w`` ``[L, in, out]``,
``ln1_w`` ``[L, h]`` and so on); they are unstacked into the unrolled names.
"""
from __future__ import annotations

import numpy as np
import torch

_SCANNED_PREFIX = "model.layers_scanned."
# stacked name -> the unrolled layer's parameter
_SCANNED = {
    "q_w": "self_attn.q_proj.weight",
    "k_w": "self_attn.k_proj.weight",
    "v_w": "self_attn.v_proj.weight",
    "o_w": "self_attn.o_proj.weight",
    "gate_w": "mlp.gate_proj.weight",
    "up_w": "mlp.up_proj.weight",
    "down_w": "mlp.down_proj.weight",
    "ln1_w": "input_layernorm.weight",
    "ln2_w": "post_attention_layernorm.weight",
}


def _is_linear(name: str) -> bool:
    return name.endswith("_proj.weight") or name == "lm_head.weight"


def _unstack(np_state: dict) -> dict:
    """The scanned stack's arrays as per-layer unrolled entries."""
    out = {}
    for name, arr in np_state.items():
        if not name.startswith(_SCANNED_PREFIX):
            out[name] = arr
            continue
        key = name[len(_SCANNED_PREFIX):]
        if key not in _SCANNED:
            raise ValueError(f"{name}: no unrolled counterpart (MoE stacks "
                             "are not ported)")
        for i, layer in enumerate(np.asarray(arr)):
            out[f"model.layers.{i}.{_SCANNED[key]}"] = layer
    return out


def llama_state_from_paddle_tpu(np_state: dict) -> dict:
    """Map ``{name: np.ndarray}`` from a ``paddle_tpu`` Llama state dict
    (unrolled or scanned) to ``{name: torch.Tensor}`` (CPU, same dtype) for
    ``LlamaForCausalLM.load_state_dict``."""
    out = {}
    for name, arr in _unstack(np_state).items():
        arr = np.asarray(arr)
        if _is_linear(name):
            if arr.ndim != 2:
                raise ValueError(f"{name}: expected a 2-D weight, got "
                                 f"shape {arr.shape}")
            arr = arr.T
        out[name] = torch.tensor(arr)  # a copy: JAX arrays are read-only
    return out
