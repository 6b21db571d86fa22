"""Roofline attribution of serving dispatches (counterpart of
``observe_serving_step`` in ``paddle_tpu/observability/roofline_attr.py``).

A roofline model is a JSON file (``{"configs": [{"config": name,
"tokens_per_s_bound": ...}, ...]}``) that the caller registers by setting
``PADDLE_ROOFLINE`` to its path. ``observe_serving_step`` joins one decode
dispatch against the first config's token-rate bound and publishes
``roofline.serving.tokens_per_s`` and ``roofline.serving.bound_frac``.

With no model registered it does nothing. The JAX package falls back to
the repo's ``ROOFLINE.json``, which models the TPU; the port does not, so
no TPU bound is ever read as the card's. The training-step attribution
(``observe_train_step``) is not ported yet.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, Optional

__all__ = ["load_roofline", "observe_serving_step", "roofline_path"]

_LOCK = threading.Lock()
_CACHE: Dict[str, object] = {}


def roofline_path() -> Optional[str]:
    """The registered model's path (``PADDLE_ROOFLINE``), or None."""
    return os.environ.get("PADDLE_ROOFLINE") or None


def load_roofline(path: Optional[str] = None) -> Optional[dict]:
    """Parse (and cache) the roofline model; None when none is registered
    or it is unreadable."""
    p = path or roofline_path()
    if p is None:
        return None
    with _LOCK:
        if p in _CACHE:
            return _CACHE[p]  # type: ignore[return-value]
        try:
            with open(p) as f:
                data = json.load(f)
            if not isinstance(data.get("configs"), list) \
                    or not data["configs"]:
                data = None
        except (OSError, ValueError):
            data = None
        _CACHE[p] = data
        return data


def observe_serving_step(step_s: float, tokens: int) -> None:
    """Join one decode dispatch against the first config's token-rate
    bound (the JAX package's selection of a config by name has no caller
    in the port).

    ``roofline.serving.bound_frac`` is observed decode tokens/s over the
    model's ``tokens_per_s_bound``.
    """
    if step_s <= 0 or tokens <= 0:
        return
    roofline = load_roofline()
    if roofline is None:
        return
    cfg = roofline["configs"][0]
    bound = float(cfg.get("tokens_per_s_bound", 0.0))
    rate = tokens / step_s
    from .metrics import get_registry
    reg = get_registry()
    reg.gauge("roofline.serving.tokens_per_s",
              "decode tokens/sec of the latest serving dispatch"
              ).set(rate)
    if bound > 0:
        reg.gauge("roofline.serving.bound_frac",
                  "serving decode rate over the roofline token bound"
                  ).set(rate / bound)
