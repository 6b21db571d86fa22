"""Weights from the JAX package's Llama and GPT-2 into the port's.

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


# GPT-2's projections (``[in, out]`` in the JAX package)
_GPT2_LINEARS = ("c_attn.weight", "c_proj.weight", "c_fc.weight",
                 "lm_head.weight")


def gpt2_state_from_paddle_tpu(np_state: dict) -> dict:
    """Map ``{name: np.ndarray}`` from a ``paddle_tpu`` GPT-2 state dict to
    ``{name: torch.Tensor}`` for ``GPT2ForCausalLM.load_state_dict``: the
    ``c_attn``, ``c_proj`` and ``c_fc`` weights (and an untied LM head) are
    transposed; biases, embeddings and LayerNorm weights carry over as they
    are."""
    out = {}
    for name, arr in np_state.items():
        arr = np.asarray(arr)
        if name.endswith(_GPT2_LINEARS):
            if arr.ndim != 2:
                raise ValueError(f"{name}: expected a 2-D weight, got "
                                 f"shape {arr.shape}")
            arr = arr.T
        out[name] = torch.tensor(arr)  # a copy: JAX arrays are read-only
    return out


def _np(x):
    """A JAX-package tensor (``.numpy()``), array or number as numpy."""
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def quant_state_from_paddle_tpu(jax_model) -> dict:
    """The int8 state of a quantized JAX-package model, as numpy: its
    ``_ConvertedLinear`` layers (``serving_quantize``: ``w_int8`` and
    ``scale``) and ``WeightOnlyLinear`` layers (``quantize_linear_layers``:
    ``quant_weight`` and ``weight_scale``), their codes transposed to the
    port's ``[out, in]``; its calibrated int8 page scales
    (``_cachekv_scales``); and its ``_serving_quant_report``. The layers
    are found by their attributes, so nothing of the JAX package is
    imported. Their codes and scales are not in the JAX state dict:
    ``load_quant_state`` installs them, then the state dict (biases and
    the float layers) loads as usual."""
    layers = {}
    for path, sub in jax_model.named_sublayers():
        if hasattr(sub, "w_int8"):
            scale = sub.scale
            layers[path] = {
                "kind": "converted", "codes": _np(sub.w_int8).T,
                "scale": (float(scale) if isinstance(scale, float)
                          else _np(scale).astype(np.float32)),
                "qmax": float(sub._qmax), "act_scale": sub.act_scale}
        elif hasattr(sub, "quant_weight"):
            layers[path] = {
                "kind": "weight_only", "codes": _np(sub.quant_weight).T,
                "scale": _np(sub.weight_scale).astype(np.float32),
                "algo": sub.algo}
    cachekv = getattr(jax_model, "_cachekv_scales", None)
    if cachekv is not None:
        cachekv = [{k: _np(v).astype(np.float32) for k, v in layer.items()}
                   for layer in cachekv]
    return {"layers": layers, "cachekv_scales": cachekv,
            "report": getattr(jax_model, "_serving_quant_report", None)}


def load_quant_state(port_model, qstate: dict):
    """Give a port model (Llama or GPT-2, before ``load_state_dict``) the
    int8 state ``quant_state_from_paddle_tpu`` read: each quantized path's
    ``Linear`` becomes the port's ``_ConvertedLinear`` or
    ``WeightOnlyLinear`` around the same codes and scales (its bias kept,
    for the state dict to fill), and the int8 page scales and the report
    are installed. Returns the model."""
    from ..nn.quant import WeightOnlyLinear
    from ..quantization import _ConvertedLinear
    for path, spec in qstate["layers"].items():
        parent, _, name = path.rpartition(".")
        owner = port_model.get_submodule(parent)
        lin = getattr(owner, name)
        device = lin.weight.device
        codes = np.ascontiguousarray(spec["codes"])
        if tuple(codes.shape) != tuple(lin.weight.shape):
            raise ValueError(f"{path}: codes {codes.shape} do not fit the "
                             f"port's weight {tuple(lin.weight.shape)}")
        if spec["kind"] == "converted":
            layer = _ConvertedLinear.from_codes(
                codes, spec["scale"], spec["qmax"], lin.bias, device,
                spec["act_scale"])
        else:
            layer = WeightOnlyLinear.from_codes(
                torch.from_numpy(codes).to(device),
                torch.from_numpy(spec["scale"]).to(device), lin.bias,
                spec["algo"])
        setattr(owner, name, layer)
    if qstate["cachekv_scales"] is not None:
        device = next(port_model.parameters()).device
        port_model._cachekv_scales = [
            {k: torch.from_numpy(v).to(device) for k, v in layer.items()}
            for layer in qstate["cachekv_scales"]]
    if qstate["report"] is not None:
        port_model._serving_quant_report = qstate["report"]
    return port_model
