"""Optimizer base class (counterpart of
``paddle_tpu/optimizer/optimizer.py``).

Accumulators are kept per parameter (keyed by the parameter's identity),
as are float32 master weights under ``multi_precision``: a master is made
from the parameter at its first update, so after ``amp.decorate`` it holds
the bf16-rounded values, as in the JAX package. Each concrete optimizer
updates its target (the master, or the parameter itself) in place, and
writes the low-precision parameter in the same pass when there is a master.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch


def _param_name(p, i):
    return getattr(p, "name", None) or f"param_{i}"


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            raise ValueError("parameters must be provided")
        if isinstance(learning_rate, bool) or \
                not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "only a float learning rate is ported (LRScheduler is not)")
        self._parameter_list = list(parameters)
        self._learning_rate = float(learning_rate)
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._weight_decay = weight_decay
        # accumulator name -> {id(param): float32 tensor or np.float32}
        self._accumulators: dict = {}
        self._master_weights: dict = {}
        self._step_count = 0

    # -- lr ------------------------------------------------------------------
    def get_lr(self) -> float:
        return self._learning_rate

    def set_lr(self, value):
        self._learning_rate = float(value)

    # -- accumulators ----------------------------------------------------------
    def _add_accumulator(self, name, param):
        """A float32 zero accumulator of ``param``'s shape, made once."""
        store = self._accumulators.setdefault(name, {})
        if id(param) not in store:
            store[id(param)] = torch.zeros(param.shape, dtype=torch.float32,
                                           device=param.device)
        return store[id(param)]

    def _master_weight(self, param):
        if id(param) not in self._master_weights:
            self._master_weights[id(param)] = param.detach().to(
                torch.float32, copy=True)
        return self._master_weights[id(param)]

    # -- the update (overridden per optimizer) ---------------------------------
    def _create_accumulators_for(self, param):
        raise NotImplementedError

    def _update_(self, param, target, grad, lowp):
        """Update ``target`` (the master, or ``param`` itself) in place from
        ``grad``; with a master, also write ``lowp`` (``param``'s data)."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self):
        params = [p for p in self._parameter_list
                  if p.requires_grad and p.grad is not None]
        if self._grad_clip is not None:
            self._grad_clip(params)
        for p in params:
            self._create_accumulators_for(p)
            if self._multi_precision and p.dtype != torch.float32:
                self._update_(p, self._master_weight(p), p.grad, p.detach())
            else:
                self._update_(p, p.detach(), p.grad, None)
        self._step_count += 1

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list:
            p.grad = None

    clear_gradients = clear_grad

    # -- state dict ------------------------------------------------------------
    def state_dict(self):
        sd = OrderedDict()
        name_of = {id(p): _param_name(p, i)
                   for i, p in enumerate(self._parameter_list)}
        for acc_name, store in self._accumulators.items():
            for pid, val in store.items():
                sd[f"{name_of[pid]}.{acc_name}"] = (
                    val if isinstance(val, torch.Tensor)
                    else torch.tensor(val))
        for pid, master in self._master_weights.items():
            sd[f"{name_of[pid]}.master_weight"] = master
        sd["@step"] = self._step_count
        return sd

    def set_state_dict(self, state_dict):
        by_name = {_param_name(p, i): p
                   for i, p in enumerate(self._parameter_list)}
        self._step_count = int(state_dict.get("@step", 0))
        for key, value in state_dict.items():
            if key == "@step":
                continue
            pname, acc_name = key.rsplit(".", 1)
            p = by_name.get(pname)
            if p is None:
                continue
            value = torch.as_tensor(value)
            if acc_name == "master_weight":
                self._master_weights[id(p)] = value.to(
                    p.device, torch.float32, copy=True)
            elif value.dim() == 0:        # a beta power: a host scalar
                self._accumulators.setdefault(acc_name, {})[id(p)] = \
                    np.float32(value)
            else:
                self._accumulators.setdefault(acc_name, {})[id(p)] = \
                    value.to(p.device, torch.float32, copy=True)
