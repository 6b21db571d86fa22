"""Gradient clipping (counterpart of ``paddle_tpu/optimizer/clip.py``).

Each clip takes the parameters whose grads the optimizer is about to apply
and rewrites those grads in place. Norms are taken in float32; the grads
keep their type.
"""
from __future__ import annotations

import torch


def _grads(params):
    return [p.grad for p in params if p.grad is not None]


class ClipGradByValue:
    """Clamp every grad element to ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    @torch.no_grad()
    def __call__(self, params):
        for g in _grads(params):
            g.clamp_(self.min, self.max)


def _scale_(g, factor):
    g.copy_((g.float() * factor).to(g.dtype))


class ClipGradByNorm:
    """Scale each grad whose own float32 L2 norm exceeds ``clip_norm`` down
    to that norm."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    @torch.no_grad()
    def __call__(self, params):
        for g in _grads(params):
            norm = g.float().square().sum().sqrt()
            _scale_(g, (self.clip_norm / norm.clamp_min(1e-12))
                    .clamp_max(1.0))


class ClipGradByGlobalNorm:
    """Scale every grad by ``min(clip_norm / global_norm, 1)``, the global
    norm taken in float32 over all grads together. The factor stays on the
    device: no host sync."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = clip_norm

    @torch.no_grad()
    def __call__(self, params):
        grads = _grads(params)
        if not grads:
            return
        sq = sum(g.float().square().sum() for g in grads)
        factor = (self.clip_norm / sq.sqrt().clamp_min(1e-12)).clamp_max(1.0)
        for g in grads:
            _scale_(g, factor)
