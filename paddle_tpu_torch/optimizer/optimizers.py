"""Adam and AdamW (counterpart of ``paddle_tpu/optimizer/optimizers.py``).

The update is ``ops.hopper.adamw_``: the hand-written kernel for a CUDA
parameter (one launch per tensor, master, moments and the bf16 parameter
written in one pass) and its plain version for a CPU parameter. The beta
powers are float32 host scalars per parameter, advanced without touching
the device.
"""
from __future__ import annotations

import numpy as np

from ..ops.hopper import adamw_
from .optimizer import Optimizer


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None):
        if lazy_mode:
            raise NotImplementedError("lazy_mode is not ported")
        if use_multi_tensor:
            raise NotImplementedError("use_multi_tensor is not ported")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators_for(self, param):
        self._add_accumulator("moment1", param)
        self._add_accumulator("moment2", param)
        for name in ("beta1_pow", "beta2_pow"):
            self._accumulators.setdefault(name, {}).setdefault(
                id(param), np.float32(1.0))

    def _decay(self, param):
        """Decoupled decay coefficient for this parameter (Adam: none)."""
        return 0.0

    def _update_(self, param, target, grad, lowp):
        b1p = self._accumulators["beta1_pow"][id(param)] * \
            np.float32(self._beta1)
        b2p = self._accumulators["beta2_pow"][id(param)] * \
            np.float32(self._beta2)
        self._accumulators["beta1_pow"][id(param)] = b1p
        self._accumulators["beta2_pow"][id(param)] = b2p
        if isinstance(self._weight_decay, float):
            # Adam's coupled L2 decay enters through the grad
            grad = grad.float() + self._weight_decay * target
        one = np.float32(1.0)
        adamw_(target, self._accumulators["moment1"][id(param)],
               self._accumulators["moment2"][id(param)], grad,
               lr=self._learning_rate, beta1=self._beta1, beta2=self._beta2,
               eps=self._epsilon, weight_decay=self._decay(param),
               bc1=one - b1p, bc2=one - b2p, p_lowp=lowp)


class AdamW(Adam):
    """Decoupled weight decay. ``apply_decay_param_fun`` sees the
    parameter's ``name`` attribute, or ``""`` (the JAX package's Llama
    parameters have no name either)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        if lr_ratio is not None:
            raise NotImplementedError("lr_ratio is not ported")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         name=name)
        self._coeff = weight_decay if isinstance(weight_decay, float) \
            else 0.01
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay(self, param):
        fun = self._apply_decay_param_fun
        if fun is not None and not fun(getattr(param, "name", None) or ""):
            return 0.0
        return self._coeff
