"""Activation recompute (counterpart of
``paddle_tpu/distributed/fleet/recompute.py``).

The JAX package's ``recompute`` stows the inputs and the RNG state and
replays the function in the backward; ``torch.utils.checkpoint`` with
``use_reentrant=False`` is the same stow-and-replay node in PyTorch.
"""
from __future__ import annotations

from torch.utils.checkpoint import checkpoint


def recompute(function, *args, **kwargs):
    """Run ``function(*args, **kwargs)`` keeping none of its activations;
    the backward re-runs it (RNG state preserved) and differentiates the
    replay. Parameters the function closes over receive their grads."""
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=True, **kwargs)
