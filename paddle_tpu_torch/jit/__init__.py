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
    inputs: dict          # leaf index -> the graph's input buffer
    outputs: object       # what fn returned while it was captured


def _flatten(obj, leaves: list):
    """The structure of ``obj`` (dicts, lists and tuples, nested), its leaves
    appended to ``leaves`` in order."""
    if isinstance(obj, dict):
        return ("dict", tuple((k, _flatten(v, leaves))
                              for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return (type(obj), tuple(_flatten(v, leaves) for v in obj))
    leaves.append(obj)
    return None


def _unflatten(tree, leaves):
    """``_flatten``'s inverse over an iterator of leaves."""
    if tree is None:
        return next(leaves)
    kind, children = tree
    if kind == "dict":
        return {k: _unflatten(c, leaves) for k, c in children}
    return kind(_unflatten(c, leaves) for c in children)


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

    def _flat(self, args):
        """(signature, leaves, the leaves' donated flags, the structure)."""
        leaves, donated, trees, key = [], [], [], []
        for i, a in enumerate(args):
            start = len(leaves)
            trees.append(_flatten(a, leaves))
            mine = leaves[start:]
            if i in self._donate and not any(
                    isinstance(x, torch.Tensor) for x in mine):
                raise TypeError(f"to_static: donated argument {i} holds no "
                                "tensor")
            for x in mine:
                donated.append(i in self._donate)
                if not isinstance(x, torch.Tensor):
                    key.append(x)
                    continue
                if x.device.type != "cuda":
                    raise ValueError(
                        f"to_static: a tensor of argument {i} lies on "
                        f"{x.device}; a CUDA graph takes tensors on the card "
                        "only")
                key.append((tuple(x.shape), x.stride(), x.dtype, x.device,
                            x.data_ptr() if donated[-1] else None))
        return (tuple(trees), tuple(key)), leaves, donated, trees

    def _capture(self, leaves, donated, trees):
        inputs = {j: x.clone() for j, x in enumerate(leaves)
                  if isinstance(x, torch.Tensor) and not donated[j]}
        flat = iter([inputs.get(j, x) for j, x in enumerate(leaves)])
        call_args = [_unflatten(t, flat) for t in trees]
        device = next(x.device for x in leaves
                      if isinstance(x, torch.Tensor))
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
        key, leaves, donated, trees = self._flat(args)
        captured = self._graphs.get(key)
        if captured is None:
            captured = self._graphs[key] = self._capture(leaves, donated,
                                                         trees)
        else:
            for j, buf in captured.inputs.items():
                buf.copy_(leaves[j])
        captured.graph.replay()
        self.replays += 1
        return captured.outputs


def to_static(fn, donate_args=()):
    """The counterpart of ``paddle_tpu.jit.to_static(fn, donate_args=)``:
    ``fn`` captured as a CUDA graph and replayed.

    Arguments may be tensors, other values, or dicts, lists and tuples of
    them, nested (a paged decode state: lists of ``(kc, vc)`` pools, int32
    tensors and Python ints). They are flattened to their leaves. The first
    call of each signature (the structure; each tensor leaf's shape,
    strides, dtype and device, and its data pointer when it lies under a
    donated argument; every other leaf's value) runs ``fn`` once eagerly on
    a side stream, captures it into a ``torch.cuda.CUDAGraph`` and replays
    the graph; every later call with that signature only replays it. So
    ``fn`` must give the same result when it runs twice on the same inputs:
    a decode step that writes its cache rows at t and then reads them does.

    Tensor leaves that are not donated are copied into the graph's own
    input buffers on each call. The tensor leaves of a donated argument
    (its index in ``donate_args``; it must hold a tensor) are not copied:
    they must be the same tensors on each call (others capture anew), and
    the graph reads and writes them in place, as XLA reuses a donated
    buffer. Other leaves must be hashable.

    Returns what ``fn`` returned while it was captured: the graph's own
    output buffers (and any donated tensor ``fn`` returns), which the next
    call overwrites; copy what must outlive it.

    Every tensor leaf must lie on the card: a CPU tensor raises
    ``ValueError``. Nothing runs eagerly in place of the graph: a failed
    capture raises ``RuntimeError``.
    """
    return StaticFunction(fn, donate_args)


__all__ = ["StaticFunction", "TrainStep", "to_static"]
