"""Layers of the serving and training paths (counterparts of
``paddle_tpu/nn/common.py`` ``Linear``/``Embedding`` and
``paddle_tpu/nn/norm.py`` ``RMSNorm``).

Parameters are created empty on an explicit device and type, and filled by
the model from an explicit ``torch.Generator`` (or by ``load_state_dict``).
They train: every parameter requires grad, as the JAX package's parameters
are trainable by default.
"""
from __future__ import annotations

import torch
from torch import nn

from . import functional as F


def _param(*shape, device, dtype):
    return nn.Parameter(torch.empty(*shape, device=device, dtype=dtype))


class Linear(nn.Module):
    """y = x W^T, no bias; weight ``[out_features, in_features]``."""

    def __init__(self, in_features, out_features, *, device, dtype):
        super().__init__()
        self.weight = _param(out_features, in_features, device=device,
                             dtype=dtype)

    def forward(self, x):
        return F.linear(x, self.weight)


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
