"""Weight-only quantized linears for serving (counterpart of
``paddle_tpu/nn/quant/__init__.py``).

``weight_quantize`` turns a weight into int8 (or int4) codes with one scale
per output channel; ``weight_only_linear`` dequantizes it on the fly and
multiplies in the activation's type; ``WeightOnlyLinear`` is a ``Linear``
stored that way, and ``quantize_linear_layers`` swaps a model's ``Linear``
layers for it in place.

The port's weights are ``[out, in]`` (the JAX package's are ``[in, out]``),
so the output channel is axis 0 here and the JAX package's codes are the
transpose of these. The codes are computed on the host with numpy, by the
JAX package's float32 formula ``round(w / (amax / qmax))`` (round half to
even), so they equal its codes bit for bit; a bfloat16 weight is widened to
float32 first. int4 codes are stored unpacked, one value in each int8 byte,
as the JAX package stores them. The dequantization and the product are
plain PyTorch, as they were XLA code in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...device import to_torch_dtype
from .. import functional as F
from ..layers import Linear

__all__ = ["Stub", "WeightOnlyLinear", "llm_int8_linear",
           "quantize_linear_layers", "weight_dequantize",
           "weight_only_linear", "weight_quantize"]


class Stub(nn.Module):
    """Identity that shows its input to ``observer`` (a placeholder the
    quantization framework observes or replaces)."""

    def __init__(self, observer=None):
        super().__init__()
        self._observer = observer

    def forward(self, x):
        if self._observer is not None:
            self._observer.observe(x)
        return x


def _host_f32(x):
    """A tensor (or array) as a float32 numpy array on the host."""
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def weight_quantize(x, algo="weight_only_int8", arch=None, group_size=-1):
    """Quantize an ``[out, in]`` weight per output channel to int8 codes
    (``algo`` with ``int4``: codes in [-7, 7]). Returns ``(codes [out, in]
    int8, scale [out] float32)`` on x's device, ``scale = amax / qmax``
    (1 where a channel is all zero)."""
    arr = _host_f32(x)
    bits = 4 if "int4" in algo else 8
    qmax = float(2 ** (bits - 1) - 1)
    scale = np.abs(arr).max(axis=1) / qmax
    scale = np.where(scale == 0, 1.0, scale)
    q = np.clip(np.round(arr / scale[:, None]), -qmax, qmax).astype(np.int8)
    device = x.device if torch.is_tensor(x) else None
    return (torch.from_numpy(q).to(device),
            torch.from_numpy(scale.astype(np.float32)).to(device))


def weight_dequantize(x, scale, algo="weight_only_int8", out_dtype="float16"):
    """``codes * scale`` in float32 (scale per output row), cast to
    ``out_dtype``."""
    return (x.float() * scale[:, None]).to(to_torch_dtype(out_dtype))


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", arch=None, group_size=-1):
    """``x @ dequant(weight)^T + bias``: the ``[out, in]`` codes times their
    per-row scale in float32, cast to x's type, then the product in x's
    type."""
    wf = weight.float() * weight_scale[:, None]
    return F.linear(x, wf.to(x.dtype), bias)


def llm_int8_linear(x, weight, bias=None, weight_scale=None, threshold=6.0):
    """LLM.int8()'s signature; as in the JAX package, the dequantized
    product is the whole computation (``threshold`` is not used)."""
    return weight_only_linear(x, weight, bias, weight_scale)


class WeightOnlyLinear(nn.Module):
    """A ``Linear`` stored as per-output-channel int8 (or unpacked int4)
    codes and scales, dequantized on every call (``weight_only_linear``).
    The codes and scales are buffers left out of the state dict, as the
    JAX layer's tensors are, so a model's state dict keeps its keys (the
    bias stays a parameter)."""

    def __init__(self, linear, algo: str = "weight_only_int8"):
        super().__init__()
        self.algo = algo
        qw, scale = weight_quantize(linear.weight, algo)
        self.register_buffer("quant_weight", qw, persistent=False)
        self.register_buffer("weight_scale", scale, persistent=False)
        self.bias = linear.bias
        self.out_features, self.in_features = linear.weight.shape

    @classmethod
    def from_codes(cls, codes, scale, bias, algo):
        """A layer around given ``[out, in]`` codes and ``[out]`` scales
        (``models/convert.py``: a JAX layer's, transposed)."""
        self = cls.__new__(cls)
        nn.Module.__init__(self)
        self.algo = algo
        self.register_buffer("quant_weight", codes, persistent=False)
        self.register_buffer("weight_scale", scale, persistent=False)
        self.bias = bias
        self.out_features, self.in_features = codes.shape
        return self

    def forward(self, x):
        return weight_only_linear(x, self.quant_weight, self.bias,
                                  self.weight_scale,
                                  weight_dtype="int4" if "int4" in self.algo
                                  else "int8")


def quantize_linear_layers(model, algo: str = "weight_only_int8",
                           min_features: int = 1):
    """Swap every ``Linear`` of ``model`` with at least ``min_features``
    inputs for a ``WeightOnlyLinear``, in place. Returns the count."""
    swapped = 0
    for layer in list(model.modules()):
        for name, sub in list(layer.named_children()):
            if isinstance(sub, Linear) \
                    and sub.weight.shape[1] >= min_features:
                setattr(layer, name, WeightOnlyLinear(sub, algo))
                swapped += 1
    return swapped
