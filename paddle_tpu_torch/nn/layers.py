"""Layers of the serving and training paths (counterparts of
``paddle_tpu/nn/common.py`` ``Linear``/``Embedding``/``Dropout`` and
``paddle_tpu/nn/norm.py`` ``RMSNorm``/``LayerNorm``).

Parameters are created empty on an explicit device and type, and filled by
the model from an explicit ``torch.Generator`` (or by ``load_state_dict``);
norm weights start at one and biases at zero. They train: every parameter
requires grad, as the JAX package's parameters are trainable by default.
``Dropout`` holds the generator its masks are drawn from.
"""
from __future__ import annotations

import torch
from torch import nn

from . import functional as F


def _param(*shape, device, dtype):
    return nn.Parameter(torch.empty(*shape, device=device, dtype=dtype))


class Linear(nn.Module):
    """y = x W^T (+ b); weight ``[out_features, in_features]``, the bias
    (``bias=True``) zero to start."""

    def __init__(self, in_features, out_features, bias=False, *, device,
                 dtype):
        super().__init__()
        self.weight = _param(out_features, in_features, device=device,
                             dtype=dtype)
        self.bias = None
        if bias:
            self.bias = _param(out_features, device=device, dtype=dtype)
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, *, device, dtype):
        super().__init__()
        self.weight = _param(num_embeddings, embedding_dim, device=device,
                             dtype=dtype)

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-6, *, device, dtype):
        super().__init__()
        self.epsilon = epsilon
        self.weight = _param(hidden_size, device=device, dtype=dtype)
        with torch.no_grad():
            self.weight.fill_(1.0)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)


class LayerNorm(nn.Module):
    """LayerNorm over the last ``hidden_size`` features: weight ones and
    bias zeros to start."""

    def __init__(self, hidden_size, epsilon=1e-5, *, device, dtype):
        super().__init__()
        self.epsilon = epsilon
        self.weight = _param(hidden_size, device=device, dtype=dtype)
        self.bias = _param(hidden_size, device=device, dtype=dtype)
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1], self.weight, self.bias,
                            self.epsilon)


class Dropout(nn.Module):
    """Upscale-in-train dropout with rate ``p`` while the module trains,
    drawing its masks from ``generator`` (one on the inputs' device; None:
    the device's default generator)."""

    def __init__(self, p=0.5, generator=None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, self.training, self.generator)
