"""Training step and static capture (counterpart of ``paddle_tpu/jit``).
Ported: ``TrainStep`` and the CUDA-graph counterpart of ``to_static``."""
from __future__ import annotations

from typing import NamedTuple

import torch


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


class _Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: dict          # argument index -> the graph's input buffer
    outputs: object       # what fn returned while it was captured


class StaticFunction:
    """``fn`` captured into a ``torch.cuda.CUDAGraph`` per signature and
    replayed on every call (see :func:`to_static`). ``captures`` counts the
    captures made and ``replays`` the replays."""

    def __init__(self, fn, donate_args=()):
        self._fn = fn
        self._donate = frozenset(donate_args)
        self._graphs: dict = {}
        self.captures = 0
        self.replays = 0

    def _signature(self, args):
        key = []
        for i, a in enumerate(args):
            if isinstance(a, torch.Tensor):
                if a.device.type != "cuda":
                    raise ValueError(
                        f"to_static: argument {i} lies on {a.device}; a "
                        "CUDA graph takes tensors on the card only")
                key.append((tuple(a.shape), a.stride(), a.dtype, a.device,
                            a.data_ptr() if i in self._donate else None))
            elif i in self._donate:
                raise TypeError(f"to_static: donated argument {i} is not a "
                                "tensor")
            else:
                key.append(a)
        return tuple(key)

    def _capture(self, args):
        inputs = {i: a.clone() for i, a in enumerate(args)
                  if isinstance(a, torch.Tensor) and i not in self._donate}
        call_args = [inputs.get(i, a) for i, a in enumerate(args)]
        device = next(a.device for a in args if isinstance(a, torch.Tensor))
        # one eager call on a side stream first, as torch.cuda.graphs asks:
        # it settles lazy state (kernel loading, cuBLAS workspaces) outside
        # the capture
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._fn(*call_args)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                outputs = self._fn(*call_args)
        except Exception as e:
            name = getattr(self._fn, "__qualname__", repr(self._fn))
            raise RuntimeError(f"to_static: capturing {name} as a CUDA graph "
                               "failed") from e
        self.captures += 1
        return _Captured(graph, inputs, outputs)

    def __call__(self, *args):
        key = self._signature(args)
        captured = self._graphs.get(key)
        if captured is None:
            captured = self._graphs[key] = self._capture(args)
        else:
            for i, buf in captured.inputs.items():
                buf.copy_(args[i])
        captured.graph.replay()
        self.replays += 1
        return captured.outputs


def to_static(fn, donate_args=()):
    """The counterpart of ``paddle_tpu.jit.to_static(fn, donate_args=)``:
    ``fn`` captured as a CUDA graph and replayed.

    The first call of each signature (shapes, strides, dtypes and devices
    of the tensor arguments, the values of the others, and the data
    pointers of the donated tensors) runs ``fn`` once eagerly on a side
    stream, captures it into a ``torch.cuda.CUDAGraph`` and replays the
    graph; every later call with that signature only replays it. So ``fn``
    must give the same result when it runs twice on the same inputs: a
    decode step that writes its cache rows at t and then reads them does.

    Tensors that are not donated are copied into the graph's own input
    buffers on each call. A donated argument (its index in
    ``donate_args``) is not copied: it must be the same tensor on each call
    (another one captures anew), and the graph reads and writes it in
    place, as XLA reuses a donated buffer.

    Returns what ``fn`` returned while it was captured: the graph's own
    output buffers (and any donated tensor ``fn`` returns), which the next
    call overwrites; copy what must outlive it.

    Every tensor argument must lie on the card: a CPU tensor raises
    ``ValueError``. Nothing runs eagerly in place of the graph: a failed
    capture raises ``RuntimeError``.
    """
    return StaticFunction(fn, donate_args)


__all__ = ["StaticFunction", "TrainStep", "to_static"]
