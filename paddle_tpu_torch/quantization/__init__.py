"""Int8 serving weights (counterpart of ``paddle_tpu/quantization``, cut to
what ``serving_quantize`` runs): the observers ``AbsmaxObserver`` and
``ChannelAbsmaxObserver``, ``QuantedLinear`` with a weight observer, the
inference-form ``_ConvertedLinear`` and ``serving_quantize``.

``serving_quantize`` converts each ``Linear`` to int8 codes with absmax
scales unless the layer's output on a seeded probe moves by more than
``err_bound``; the decisions land in ``model._serving_quant_report`` and
the ``quant.*`` series. The port's module paths are the JAX package's
(``transformer.h.0.attn.c_attn``, ``model.layers.0.self_attn.q_proj``), so
each probe is seeded alike and the reports agree.

Differences from the JAX package:

- Weights are ``[out, in]``, so the output channel is axis 0
  (``ChannelAbsmaxObserver(axis=0)`` in ``serving_quantize``). Codes,
  scales and the probe are computed on the host with numpy in the JAX
  package's float32 order on its ``[in, out]`` layout (a bfloat16 weight
  widened to float32 first), so codes, scales and errors are its own bit
  for bit.
- ``_ConvertedLinear`` multiplies in the activation's type: the JAX layer
  computes ``x @ float32(codes) * dequant``, which promotes a bfloat16
  activation to float32 and carries float32 into the residual stream; here
  a bfloat16 model stays bfloat16 (int8 codes are exact in bfloat16) and
  its attention keeps the bfloat16 kernels. In float32 the two are the
  same.

Not ported (ROADMAP queue 1, item 8): ``QAT``, ``PTQ``, ``convert``, the
EMA and histogram observers, the fake quanters and ``QuantedConv2D``.
``serving_quantize(mesh=)`` waits for tensor-parallel serving.
"""
from __future__ import annotations

import copy
import zlib

import numpy as np
import torch
from torch import nn

from ..nn import functional as F
from ..nn.layers import Linear
from ..nn.quant import _host_f32
from ..observability.metrics import get_registry

__all__ = ["AbsmaxObserver", "BaseObserver", "ChannelAbsmaxObserver",
           "QuantedLinear", "serving_quantize"]


class BaseObserver:
    """Tracks a scale from the data it observes."""

    def __init__(self, quant_bits=8):
        self.quant_bits = quant_bits

    def _instance(self):
        return copy.deepcopy(self)

    def observe(self, x) -> None:
        raise NotImplementedError

    def scales(self) -> np.ndarray:
        raise NotImplementedError


class AbsmaxObserver(BaseObserver):
    """Running max of |x| (one scale, 1 while nothing nonzero was seen)."""

    def __init__(self, quant_bits=8):
        super().__init__(quant_bits)
        self._max = 0.0

    def observe(self, x):
        arr = _host_f32(x)
        self._max = max(self._max, float(np.max(np.abs(arr), initial=0.0)))

    def scales(self):
        return np.float32(self._max if self._max > 0 else 1.0)


class ChannelAbsmaxObserver(BaseObserver):
    """Running max of |x| per slice along ``axis`` (one scale a channel:
    per-tensor absmax lets one outlier channel starve the others of
    codes)."""

    def __init__(self, quant_bits=8, axis=-1):
        super().__init__(quant_bits)
        self.axis = axis
        self._max = None

    def observe(self, x):
        arr = np.abs(_host_f32(x))
        red = tuple(i for i in range(arr.ndim)
                    if i != (self.axis % arr.ndim))
        cur = arr.max(axis=red) if red else arr
        self._max = cur if self._max is None else np.maximum(self._max, cur)

    def scales(self):
        if self._max is None:
            return np.float32(1.0)
        return np.where(self._max > 0, self._max, 1.0).astype(np.float32)


class QuantedLinear(nn.Module):
    """A ``Linear`` with its activation and weight shown to observers (or
    fake-quantized by quanters that have ``quantize``) around the product.
    Only observers are ported."""

    def __init__(self, base, act_quanter, wt_quanter):
        super().__init__()
        self._base = base
        self.weight = base.weight
        self.bias = base.bias
        self.activation_quanter = (act_quanter._instance()
                                   if act_quanter else None)
        self.weight_quanter = (wt_quanter._instance() if wt_quanter else None)

    def forward(self, x):
        if self.activation_quanter is not None:
            if hasattr(self.activation_quanter, "quantize"):
                x = self.activation_quanter.quantize(x)
            else:
                self.activation_quanter.observe(x)
        w = self.weight
        if self.weight_quanter is not None:
            if hasattr(self.weight_quanter, "quantize"):
                w = self.weight_quanter.quantize(w)
            else:
                self.weight_quanter.observe(w)
        return F.linear(x, w, self.bias)


class _ConvertedLinear(nn.Module):
    """Inference form of a ``QuantedLinear``: int8 codes ``w_int8``
    ``[out, in]`` and absmax ``scale`` (a float, or ``[out]`` from a
    channel observer), computed as ``(x @ codes^T) * (scale / qmax) +
    bias`` in x's type (the dequantization after the product is exact for
    per-tensor and per-output-channel scales). The codes and scales are
    buffers left out of the state dict, as the JAX layer's are."""

    def __init__(self, qlayer: QuantedLinear):
        super().__init__()
        bits = (qlayer.weight_quanter.quant_bits
                if qlayer.weight_quanter else 8)
        qmax = float(2 ** (bits - 1) - 1)
        # the JAX layout, [in, out], so every float32 step is the JAX one
        w = np.ascontiguousarray(_host_f32(qlayer.weight).T)
        scale = np.asarray(
            qlayer.weight_quanter.scales() if qlayer.weight_quanter
            else (np.abs(w).max() or 1.0), np.float32)
        scale = np.maximum(scale, 1e-12)
        codes = np.clip(np.round(w / scale * qmax), -qmax,
                        qmax).astype(np.int8)
        self._set(codes.T, scale, qmax, qlayer.bias, qlayer.weight.device)
        self.act_scale = (float(qlayer.activation_quanter.scales())
                          if qlayer.activation_quanter else None)

    def _set(self, codes_out_in, scale, qmax, bias, device):
        """Codes, scale and dequant factor: a per-tensor scale stays a
        Python float (its factor a float64 quotient, as the JAX layer's),
        a channel scale a float32 ``[out]`` buffer."""
        self.register_buffer(
            "w_int8", torch.from_numpy(np.ascontiguousarray(
                codes_out_in)).to(device), persistent=False)
        if np.ndim(scale) == 0:
            self.scale = float(scale)
            self._dq = self.scale / qmax
        else:
            self.register_buffer("scale", torch.from_numpy(
                np.asarray(scale, np.float32)).to(device), persistent=False)
            self.register_buffer("_dq", torch.from_numpy(
                (scale / qmax).astype(np.float32)).to(device),
                persistent=False)
        self._qmax = qmax
        self.bias = bias

    @classmethod
    def from_codes(cls, codes, scale, qmax, bias, device, act_scale=None):
        """A layer around given ``[out, in]`` codes and the JAX layer's
        ``scale`` (``models/convert.py``)."""
        self = cls.__new__(cls)
        nn.Module.__init__(self)
        self._set(codes, np.asarray(scale, np.float32), qmax, bias, device)
        self.act_scale = act_scale
        return self

    def _codes_in_out(self):
        return np.ascontiguousarray(self.w_int8.cpu().numpy().T)

    def _scale_np(self):
        return (self.scale if isinstance(self.scale, float)
                else self.scale.cpu().numpy())

    def forward(self, x):
        dq = self._dq if isinstance(self._dq, float) \
            else self._dq.to(x.dtype)
        out = F.linear(x, self.w_int8.to(x.dtype)) * dq
        if self.bias is not None:
            out = out + self.bias
        return out


def _quant_metrics():
    reg = get_registry()
    return (reg.counter("quant.layers_quantized",
                        "Linear layers serving int8 weights"),
            reg.counter("quant.layers_fallback",
                        "Linear layers kept fp (calibration error over "
                        "the bound)"),
            reg.counter("quant.weight_bytes_saved",
                        "parameter bytes removed by int8 serving weights"),
            reg.histogram("quant.layer_rel_err",
                          "per-layer output rel-error of int8 vs fp "
                          "weights on the calibration probe"))


def _crc(path):
    return zlib.crc32(path.encode()) & 0xFFFFFFFF


def serving_quantize(model: nn.Module, err_bound: float = 0.02,
                     probe_batch: int = 8, seed: int = 0, mesh=None,
                     channelwise: bool = True,
                     inplace: bool = False) -> nn.Module:
    """Int8 serving weights with a per-layer float fallback.

    Every plain ``Linear`` (exact type) becomes a ``_ConvertedLinear``
    (absmax codes; ``channelwise=True``: one scale per output channel,
    ``False``: one per tensor) unless its output on a seeded probe ``x``
    ``[probe_batch, in]`` (``RandomState(seed + crc32(path))``) deviates
    from the float layer's by more than ``err_bound``. The error is the
    largest, over output units, of the relative L2 deviation, small units
    floored at 1% of the largest: a whole-tensor norm would let one huge
    outlier column hide the starvation of the others.

    Returns the model (a deep copy unless ``inplace``) with
    ``_serving_quant_report``: ``{"layers": {path: {"rel_err", "mae",
    "quantized"}}, "layers_quantized", "layers_fallback", "bytes_saved",
    "err_bound"}``. The ``quant.*`` series count the same.
    ``mesh`` (tensor-parallel placement) is not ported and raises."""
    if mesh is not None:
        raise NotImplementedError(
            "serving_quantize(mesh=...): tensor-parallel serving is not "
            "ported yet (ROADMAP.md, queue 1, item 7)")
    if not inplace:
        model = copy.deepcopy(model)
    quant_c, fallback_c, bytes_c, err_h = _quant_metrics()
    report = {"layers": {}, "layers_quantized": 0, "layers_fallback": 0,
              "bytes_saved": 0, "err_bound": float(err_bound)}

    def _walk(m, prefix):
        for name, child in list(m.named_children()):
            path = f"{prefix}.{name}" if prefix else name
            # exact type: a Linear subclass may carry forward semantics the
            # converted layer would drop
            if type(child) is not Linear:
                _walk(child, path)
                continue
            obs = (ChannelAbsmaxObserver(axis=0) if channelwise
                   else AbsmaxObserver())
            q = QuantedLinear(child, None, obs)
            q.weight_quanter.observe(child.weight)
            conv = _ConvertedLinear(q)
            in_features = child.weight.shape[1]
            rng = np.random.RandomState((seed + _crc(path)) % (2 ** 31))
            x = rng.randn(probe_batch, in_features).astype(np.float32)
            w = np.ascontiguousarray(_host_f32(child.weight).T)  # [in, out]
            wdq = (conv._codes_in_out().astype(np.float32)
                   * (conv._scale_np() / conv._qmax))
            ref, out = x @ w, x @ wdq
            coln = np.linalg.norm(ref, axis=0)
            floor = max(0.01 * float(coln.max(initial=0.0)), 1e-12)
            rel = float((np.linalg.norm(out - ref, axis=0)
                         / np.maximum(coln, floor)).max(initial=0.0))
            mae = float(np.abs(out - ref).mean())
            err_h.observe(rel)
            ok = rel <= err_bound
            report["layers"][path] = {"rel_err": rel, "mae": mae,
                                      "quantized": bool(ok)}
            if ok:
                saved = (child.weight.numel() * child.weight.element_size()
                         - conv.w_int8.numel())
                report["bytes_saved"] += int(saved)
                report["layers_quantized"] += 1
                quant_c.inc()
                bytes_c.inc(max(int(saved), 0))
                setattr(m, name, conv)
            else:
                report["layers_fallback"] += 1
                fallback_c.inc()

    _walk(model, "")
    model._serving_quant_report = report
    return model
