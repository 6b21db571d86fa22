"""One JAX reference per test run, shared by the xdist workers.

The port's parity tests hold the port to the JAX package on seeded numpy
inputs. The JAX package runs op by op on the CPU and compiles every op at
every new shape (~40 ms each), so a JAX scenario costs seconds, most of it
compiles, and under ``pytest -n 6 --dist load`` every worker that got a
test of a file used to repeat them. Here each result is computed once a
run and read by the other workers:

- ``jax_ref(name, inputs, compute)`` (the ``jax_ref`` fixture) keys a
  result by ``name`` and a sha1 of its numpy ``inputs``. Under xdist
  (``PYTEST_XDIST_WORKER`` set) it lives as an ``.npz`` of its arrays
  beside a JSON file of the rest (token lists, stats dicts, nested lists
  and dicts), under ``tmp_path_factory.getbasetemp().parent``, the
  directory every worker of one run shares (pytest-xdist's pattern for a
  session fixture run once). A per-key ``fcntl.flock`` lock file, with a
  timeout, guards it: the first worker computes, the others read. Without
  xdist the result stays in memory.
- ``register(name, inputs, keys, setup, compute)``, at a test file's
  module level, declares a bundle of such results (a file's scenarios),
  and the ``jax_refs`` fixture reads them (``jax_refs(name)[key]``). The
  first worker that needs a key no file holds takes the bundle's lock,
  builds its ``setup()`` (the JAX models) once and computes every key of
  the bundle, publishing each as it lands, so the per-shape compiles that
  the file's scenarios share are paid once a run, in one process. A
  worker that needs a key waits for that key's file only. (One process
  for every file's bundles was tried: it serialised the run's JAX work
  behind one worker and took three times as long.)

A result may hold numpy arrays and numpy scalars, ints, floats, strings,
bools, None, and lists, tuples and dicts of them (tuples come back as
lists; numpy scalars as Python numbers). It holds the JAX model's
parameters as numpy arrays where the port model is built from them, so a
worker that reads a result builds its port model through
``models/convert.py`` without touching JAX. Every run still computes every
reference from the same seeded inputs; only the repeats go.

The tests below are the cache's own: a round trip, two processes racing on
one key, and a key that changes with its inputs.
"""
from __future__ import annotations

import fcntl
import hashlib
import json
import multiprocessing
import os
import time
from typing import Dict

import numpy as np
import pytest
import torch

# Under xdist each worker runs the port's many small torch ops on its own
# core: torch's intra-op pool (a thread a core in every worker) would only
# oversubscribe the cores the JAX package's compiles need. Every worker
# collects this file, so this holds in each of them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

LOCK_TIMEOUT_S = 900.0      # a holder that died frees its lock at once
POLL_S = 0.05

_MEMORY: dict = {}          # key -> result, this process


# -- keys and files ----------------------------------------------------------

def _digest(obj, h):
    """Feed a canonical encoding of ``obj`` (a tree of arrays, numbers,
    strings and containers) into the hash ``h``."""
    if isinstance(obj, np.ndarray) or isinstance(obj, np.generic):
        a = np.ascontiguousarray(obj)
        h.update(f"nd{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())
    elif isinstance(obj, dict):
        h.update(b"{")
        for k in sorted(obj, key=str):
            h.update(repr(k).encode())
            _digest(obj[k], h)
        h.update(b"}")
    elif isinstance(obj, (list, tuple)):
        h.update(b"[" if isinstance(obj, list) else b"(")
        for v in obj:
            _digest(v, h)
        h.update(b"]")
    else:
        h.update(repr(obj).encode())


def ref_key(name: str, inputs) -> str:
    h = hashlib.sha1()
    _digest(inputs, h)
    safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in name)
    return f"{safe}-{h.hexdigest()[:16]}"


def _split(obj, arrays):
    """The JSON skeleton of a result; its arrays go to ``arrays``."""
    if isinstance(obj, np.ndarray):
        k = f"a{len(arrays)}"
        arrays[k] = obj
        return {"__nd__": k}
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, dict):
        if not all(isinstance(k, str) for k in obj):
            return {"__items__": [[_split(k, arrays), _split(v, arrays)]
                                  for k, v in obj.items()]}
        return {k: _split(v, arrays) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_split(v, arrays) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"a JAX reference may not hold {type(obj).__name__}")


def _join(obj, arrays):
    if isinstance(obj, dict):
        if set(obj) == {"__nd__"}:
            return arrays[obj["__nd__"]]
        if set(obj) == {"__items__"}:
            return {_hashable(_join(k, arrays)): _join(v, arrays)
                    for k, v in obj["__items__"]}
        return {k: _join(v, arrays) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_join(v, arrays) for v in obj]
    return obj


def _hashable(k):
    return tuple(_hashable(v) for v in k) if isinstance(k, list) else k


def normalize(result):
    """``result`` as it comes back from the shared directory (tuples as
    lists, numpy scalars as Python numbers), so a result computed in this
    process and one read from a file compare alike; compare the port's
    side through it too."""
    arrays: dict = {}
    return _join(_split(result, arrays), arrays)


def _paths(root, key):
    base = os.path.join(root, key)
    return base + ".json", base + ".npz", base + ".lock"


def _write(root, key, result):
    """Publish ``result``: the arrays first, then the JSON file, each by an
    atomic rename, so a reader that sees the JSON file sees both."""
    js, nz, _ = _paths(root, key)
    arrays: dict = {}
    skeleton = _split(result, arrays)
    tmp = f"{nz}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, nz)
    tmp = f"{js}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(skeleton, f)
    os.replace(tmp, js)


def _read(root, key):
    js, nz, _ = _paths(root, key)
    if not os.path.exists(js):
        return None
    with open(js) as f:
        skeleton = json.load(f)
    with np.load(nz, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    return (_join(skeleton, arrays),)


class _Lock:
    """An exclusive ``flock`` on a lock file; ``acquire(wait=False)``
    returns False when another process holds it."""

    def __init__(self, path):
        self.path = path
        self.fd = None

    def acquire(self, wait=True, timeout=LOCK_TIMEOUT_S) -> bool:
        fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o644)
        deadline = time.monotonic() + timeout
        while True:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                self.fd = fd
                return True
            except BlockingIOError:
                if not wait or time.monotonic() > deadline:
                    os.close(fd)
                    return False
                time.sleep(POLL_S)

    def release(self):
        if self.fd is not None:
            fcntl.flock(self.fd, fcntl.LOCK_UN)
            os.close(self.fd)
            self.fd = None


# -- the cache ---------------------------------------------------------------

def shared_dir(tmp_path_factory):
    """The directory the workers of one xdist run share, or None when the
    tests run in one process."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return None
    root = tmp_path_factory.getbasetemp().parent / "jax_refs"
    root.mkdir(exist_ok=True)
    return str(root)


def cached(root, name, inputs, compute):
    """``compute()``'s result for (name, inputs): from this process's
    memory, else from the run's shared directory, else computed (under the
    key's lock, then published)."""
    key = ref_key(name, inputs)
    if key in _MEMORY:
        return _MEMORY[key]
    if root is None:
        _MEMORY[key] = result = normalize(compute())
        return result
    hit = _read(root, key)
    if hit is None:
        lock = _Lock(_paths(root, key)[2])
        held = lock.acquire()
        try:
            hit = _read(root, key)
            if hit is None:
                result = normalize(compute())
                if held:
                    _write(root, key, result)
                hit = (result,)
        finally:
            lock.release()
    _MEMORY[key] = hit[0]
    return hit[0]


class Bundle:
    """Lazy results of ``compute(ctx, key)`` for every key of ``keys``
    (string keys; ``ctx = setup()``, built once by the process that
    computes). Declared at import time with ``register`` (a test file's
    module level), so that every worker knows every bundle of the run."""

    def __init__(self, name, inputs, keys, setup, compute):
        self.name, self.keys = name, list(keys)
        self.setup, self.compute = setup, compute
        self.base = ref_key(name, inputs)
        self._ctx = None

    def key(self, k):
        return ref_key(f"{self.base}.{k}", None)

    def compute_here(self, k):
        if self._ctx is None:
            self._ctx = (self.setup(),)
        result = normalize(self.compute(self._ctx[0], k))
        _MEMORY[self.key(k)] = result
        return result


_BUNDLES: Dict[str, Bundle] = {}     # name -> bundle, in import order


def register(name, inputs, keys, setup, compute) -> str:
    """Declare a bundle (at a test file's module level); returns its name,
    for ``jax_refs(name)``."""
    _BUNDLES.setdefault(name, Bundle(name, inputs, keys, setup, compute))
    return name


def _compute_all(root, b: Bundle, k):
    """Compute ``b``'s first key and ``b[k]``, then every key of ``b`` that
    no file holds yet,
    publishing each as it lands: the per-shape compiles of the JAX package
    that a file's scenarios share are paid once a run, in one process. A
    key whose computation raises is left unpublished: the test that needs
    it computes it and fails on its own."""
    for first in dict.fromkeys([b.keys[0], k]):
        # the bundle's first key (by convention a cheap one, which most of
        # its tests need: its models' states), then the one asked for
        if _read(root, b.key(first)) is None:
            _write(root, b.key(first), b.compute_here(first))
    for other in b.keys:
        if _read(root, b.key(other)) is not None:
            continue
        try:
            result = b.compute_here(other)
        except Exception:                 # noqa: BLE001 — see above
            continue
        _write(root, b.key(other), result)
    b._ctx = None                        # the bundle's JAX models go


class Refs:
    """A registered bundle's results by key, in one test process: from this
    process's memory, from the run's shared directory, or computed. The
    first process to need a key that no file holds takes the bundle's lock
    and computes the whole bundle (``_compute_all``); the others wait for
    their key's file, or take the lock themselves once it is free."""

    def __init__(self, root, bundle: Bundle):
        self.root, self.bundle = root, bundle

    def __getitem__(self, k):
        b = self.bundle
        mk = b.key(k)
        if mk in _MEMORY:
            return _MEMORY[mk]
        if self.root is None:
            return b.compute_here(k)
        deadline = time.monotonic() + LOCK_TIMEOUT_S
        lock = _Lock(os.path.join(self.root, b.base + ".lock"))
        while True:
            hit = _read(self.root, mk)
            if hit is not None:
                _MEMORY[mk] = hit[0]
                return hit[0]
            if lock.acquire(wait=False):
                try:
                    _compute_all(self.root, b, k)
                finally:
                    lock.release()
                return _MEMORY[mk]
            if time.monotonic() > deadline:
                return b.compute_here(k)
            time.sleep(POLL_S)


@pytest.fixture(scope="session")
def jax_ref(tmp_path_factory):
    """``jax_ref(name, inputs, compute)``: ``compute()``'s result, once a
    run (see the module's docstring)."""
    root = shared_dir(tmp_path_factory)
    return lambda name, inputs, compute: cached(root, name, inputs, compute)


@pytest.fixture(scope="session")
def jax_refs(tmp_path_factory):
    """``jax_refs(name)``: the results of the bundle ``register`` declared
    under that name, by key."""
    root = shared_dir(tmp_path_factory)
    return lambda name: Refs(root, _BUNDLES[name])


# -- the cache's own tests ---------------------------------------------------

def _sample():
    rng = np.random.RandomState(0)
    return {"logits": rng.randn(2, 5).astype(np.float32),
            "tokens": [[1, 2, 3], [4]], "stats": {"rounds": 3, "rate": 0.5},
            "pairs": ((np.int64(7), None), "x"), "flag": True,
            "by_id": {3: [np.arange(4)], (1, 2): "t"}}


def test_round_trip_through_the_shared_directory(tmp_path):
    root = str(tmp_path)
    got = cached(root, "round-trip", {"seed": np.arange(3)}, _sample)
    _MEMORY.clear()
    calls = []
    again = cached(root, "round-trip", {"seed": np.arange(3)},
                   lambda: calls.append(1))
    assert calls == []                        # read, not recomputed
    for res in (got, again):
        np.testing.assert_array_equal(res["logits"], _sample()["logits"])
        assert res["logits"].dtype == np.float32
    assert again["tokens"] == [[1, 2, 3], [4]]
    assert again["stats"] == {"rounds": 3, "rate": 0.5}
    assert again["pairs"] == [[7, None], "x"] and again["flag"] is True
    assert normalize(_sample())["pairs"] == again["pairs"]
    np.testing.assert_array_equal(again["by_id"][3][0], np.arange(4))
    assert again["by_id"][(1, 2)] == "t"
    with pytest.raises(TypeError, match="may not hold"):
        cached(root, "bad", None, lambda: {"f": object()})
    _MEMORY.clear()


def _race(root, out, tag):
    def compute():
        with open(os.path.join(out, f"computed-{tag}"), "w"):
            pass
        time.sleep(0.5)                       # hold the lock a while
        return {"v": np.full(3, 7.0), "tag": tag}
    res = cached(root, "race", np.arange(2), compute)
    with open(os.path.join(out, f"result-{tag}.json"), "w") as f:
        json.dump({"v": res["v"].tolist(), "tag": res["tag"]}, f)


def _bundle_worker(root, out, tag, want):
    def setup():
        with open(os.path.join(out, f"setup-{tag}"), "w"):
            pass
        return 10

    def compute(ctx, k):
        time.sleep(0.2)
        return {"k": k, "v": ctx + k}
    _BUNDLES.clear()
    register("bundle", None, ["1", "2", "3"], setup,
             lambda ctx, k: compute(ctx, int(k)))
    register("other", None, ["x"], lambda: 0, lambda ctx, k: {"k": k})
    with open(os.path.join(out, f"bundle-{tag}.json"), "w") as f:
        json.dump(Refs(root, _BUNDLES["bundle"])[str(want)], f)


def test_two_processes_racing_on_one_key_compute_it_once(tmp_path):
    root, out = tmp_path / "refs", tmp_path / "out"
    root.mkdir()
    out.mkdir()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_race, args=(str(root), str(out), t))
             for t in ("a", "b")]
    procs += [ctx.Process(target=_bundle_worker,
                          args=(str(root), str(out), t, w))
              for t, w in (("c", 3), ("d", 2))]
    for p in procs:
        p.start()
    for p in procs:
        p.join(60)
        assert p.exitcode == 0
    names = sorted(os.listdir(out))
    assert sum(n.startswith("computed-") for n in names) == 1
    results = [json.load(open(out / f"result-{t}.json")) for t in "ab"]
    assert results[0] == results[1] and results[0]["v"] == [7.0] * 3
    # the bundle: one setup in one process, each key computed once, and
    # nothing of the bundle nobody asked for
    assert sum(n.startswith("setup-") for n in names) == 1
    assert json.load(open(out / "bundle-c.json")) == {"k": 3, "v": 13}
    assert json.load(open(out / "bundle-d.json")) == {"k": 2, "v": 12}
    files = os.listdir(root)
    assert sum(f.endswith(".json") for f in files) == 1 + 3


def test_the_key_changes_with_its_inputs():
    a = np.arange(6, dtype=np.int64)
    k = ref_key("scenario", {"prompt": a})
    assert k == ref_key("scenario", {"prompt": a.copy()})
    assert k != ref_key("scenario", {"prompt": a + 1})
    assert k != ref_key("scenario", {"prompt": a.astype(np.int32)})
    assert k != ref_key("scenario", {"prompt": a.reshape(2, 3)})
    assert k != ref_key("other", {"prompt": a})
    assert ref_key("s", [1, 2]) != ref_key("s", (1, 2))
