"""Mixed precision (counterpart of ``paddle_tpu/amp``). Ported:
``decorate``. ``auto_cast`` and ``GradScaler`` are not ported yet."""
from __future__ import annotations

import torch

from ..device import to_torch_dtype


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast every floating parameter of the models to ``dtype`` in place
    (the same ``nn.Parameter`` objects, so the optimizers still hold them)
    and turn on the optimizers' float32 master weights. O1 changes nothing
    here. Returns the models (and the optimizers, when given) as passed.
    ``save_dtype`` is not ported."""
    if save_dtype is not None:
        raise NotImplementedError("amp.decorate(save_dtype=) is not ported")
    if level not in ("O1", "O2"):
        raise ValueError(f"unknown amp level {level!r}")
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    target = to_torch_dtype(dtype)
    if level == "O2":
        with torch.no_grad():
            for m in model_list:
                for p in m.parameters():
                    if p.is_floating_point():
                        p.data = p.data.to(target)
        if optimizers is not None:
            opts = optimizers if isinstance(optimizers, (list, tuple)) \
                else [optimizers]
            for o in opts:
                o._multi_precision = (True if master_weight is None
                                      else master_weight)
    if optimizers is None:
        return models
    return models, optimizers


__all__ = ["decorate"]
