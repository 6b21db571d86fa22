"""Training step (counterpart of ``paddle_tpu/jit``). Ported:
``TrainStep``."""
from __future__ import annotations


class TrainStep:
    """One training step per call: ``train_fn(*batch)`` gives the loss, the
    backward fills the grads, the optimizer clips and updates, and the grads
    are cleared. Returns the loss tensor (detached) without a host sync.

    The JAX package compiles the whole step into one executable; this one
    runs eagerly. Only the defaults of ``amp``, ``donate`` and ``mesh_plan``
    are ported (the eager update is in place, as donation makes the
    compiled one).
    """

    def __init__(self, train_fn, optimizer, amp=None, donate=True,
                 mesh_plan=None, opprof_label=None):
        for name, value, default in (("amp", amp, None),
                                     ("donate", donate, True),
                                     ("mesh_plan", mesh_plan, None)):
            if value is not default:
                raise NotImplementedError(
                    f"TrainStep({name}={value!r}) is not ported")
        self._fn = train_fn
        self._opt = optimizer

    def __call__(self, *args):
        loss = self._fn(*args)
        loss.backward()
        self._opt.step()
        self._opt.clear_grad()
        return loss.detach()


__all__ = ["TrainStep"]
