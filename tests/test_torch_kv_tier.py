"""The port's tiered KV cache against the JAX package's, on the CPU.

Both packages' host and disk tiers, radix trees and paged batchers run side
by side on the same inputs and must agree:

- The tiers alone: ``HostTier`` byte accounting (a float32 tensor blob
  counts the bytes of the same numpy blob), ``DiskTier``'s round trip
  (float32, float16 and bfloat16 tensors bit for bit, numpy leaves with
  their dtype) with the JAX package's byte count, and the async loader's
  futures and close.
- A scripted sequence on both packages' ``RadixPrefixCache`` (untiered, a
  host tier, a host tier over a disk tier): inserts, pins, evictions that
  demote, overflow to disk and to gone, matches split at the device,
  ``promote_node``, an upgrade by ``insert``, session pins that survive
  the last tier; ``stats()``, the summary's tiers, ``audit_tiers()`` and
  ``evictable_pages()`` equal after every step.
- ``tier_quant``'s codes and scales bit-equal to the JAX ``_quant_page``.
- The churn of tests/test_kv_tier.py (``_churn_prompts``, two seeds; a
  working set of 18 pages over a 15-page pool), plain and with
  ``tier_quant="int8"``, and the ``kv.host_promote`` and
  ``kv.host_demote`` chaos drills, through both packages' paged batchers:
  equal tokens, equal ``prefix_cache.stats()``, tier audit and
  ``serving.prefix_*``, ``serving.kv_host_bytes`` and
  ``quant.dequant_seconds`` series, and clean page audits. Which step a
  promotion lands at depends on when the loader's worker thread finishes,
  so the evictions, demotions and promotions after it depend on the
  worker's timing; these runs give both packages a loader whose
  ``submit`` completes the transfer at once (``SyncLoader``), which makes
  every counter a function of the schedule alone. The port's own
  ``AsyncLoader`` then serves the first churn: its tokens equal those of
  the run that completes at submit, and its counters are only required
  to show promotions.

The runs use tests/test_torch_gpt2_serving.py's tiny GPT-2 (the same
weights in both packages) and paged geometry (2 slots of 8 blocks of 4,
15 pages, 8-token chunks), so that the JAX package compiles those ops once
for these files in a process; every JAX run is in one test, and every
greedy pick the JAX side makes clears the top-1/top-2 margin.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import prefix_cache as j_prefix
from paddle_tpu.inference import serving as j_serving
from paddle_tpu.models import GPT2Config as JaxGPT2Config
from paddle_tpu.models import GPT2ForCausalLM as JaxGPT2
from paddle_tpu.observability import metrics as j_metrics
from paddle_tpu.perf import prefetch as j_prefetch
from paddle_tpu.resilience import chaos as j_chaos
from paddle_tpu_torch.inference import prefix_cache as p_prefix
from paddle_tpu_torch.inference import serving as p_serving
from paddle_tpu_torch.models import (GPT2Config, GPT2ForCausalLM,
                                     gpt2_state_from_paddle_tpu)
from paddle_tpu_torch.observability import metrics as p_metrics
from paddle_tpu_torch.perf import prefetch as p_prefetch
from paddle_tpu_torch.resilience import chaos as p_chaos

from test_torch_gpt2_serving import TINY, _gpt2_state, _margin_guard

TIERED = dict(max_batch=2, s_max=32, block_size=4, n_pages=15,
              prefill_chunk=8, compile=False, policy="ondemand",
              prefix_cache=True, host_kv_gib=0.25)
NEW = 4
COUNTERS = ("serving.prefix_hit_tokens", "serving.prefix_miss_tokens",
            "serving.prefix_evictions", "serving.prefix_tier_hit_tokens",
            "serving.prefix_promotions", "serving.prefix_promotion_failures",
            "serving.prefix_demoted_bytes", "serving.prefix_spill_raw_bytes",
            "serving.prefix_spill_blob_bytes")
HISTOGRAMS = ("serving.prefix_promotion_seconds", "quant.dequant_seconds")


class Side:
    def __init__(self, jax, prefix, serving, metrics, prefetch, chaos):
        self.jax = jax
        self.prefix = prefix
        self.serving = serving
        self.metrics = metrics
        self.prefetch = prefetch
        self.chaos = chaos


JAX = Side(True, j_prefix, j_serving, j_metrics, j_prefetch, j_chaos)
PORT = Side(False, p_prefix, p_serving, p_metrics, p_prefetch, p_chaos)


@pytest.fixture(autouse=True)
def _disarmed():
    for side in (JAX, PORT):
        side.chaos.disarm()
    yield
    for side in (JAX, PORT):
        side.chaos.disarm()


class SyncLoader:
    """A loader whose ``submit`` materializes the payload and completes the
    future at once, so a promotion lands at the next step's poll."""

    def __init__(self, prefetch):
        self.prefetch = prefetch

    def submit(self, payload):
        fut = self.prefetch.TransferFuture()
        try:
            fut._set(payload() if callable(payload) else payload)
        except Exception as e:            # noqa: BLE001 — like the worker
            fut._fail(e)
        return fut

    def close(self):
        pass


# -- the tiers alone ----------------------------------------------------------

def _blob(side, fill, shape=(2, 4)):
    if side.jax:
        return {"t": [(np.full(shape, fill, np.float32),
                       np.full(shape, fill + 1, np.float32))]}
    return {"t": [(torch.full(shape, fill, dtype=torch.float32),
                   torch.full(shape, fill + 1, dtype=torch.float32))]}


def test_host_tier_accounting_matches():
    seen = []
    for side in (PORT, JAX):
        t = side.prefix.HostTier(capacity_bytes=1 << 20)
        b = _blob(side, 1.0)
        nb = t.put(7, b)
        assert t.get(7) is b
        seen.append([nb, side.prefix.blob_nbytes(b), t.used_bytes,
                     7 in t, len(t), t.stored, t.nbytes_of(7),
                     t.discard(7), t.used_bytes, 7 in t])
    assert seen[0] == seen[1]
    with pytest.raises(ValueError, match="capacity"):
        p_prefix.HostTier(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16],
                         ids=lambda d: str(d).split(".")[1])
def test_disk_tier_round_trip_bit_for_bit(tmp_path, dtype):
    rng = np.random.RandomState(1)
    k = torch.from_numpy(rng.randn(3, 4, 8).astype(np.float32)).to(dtype)
    blob = {"t": k, "ts": [(k[0], np.arange(6, dtype=np.float16))],
            "d": (np.zeros((1, 2), np.float32),)}
    disk = p_prefix.DiskTier(str(tmp_path / "kv"), capacity_bytes=1 << 20)
    nb = disk.put(3, blob)
    back = disk.get(3)
    assert back["t"].dtype == dtype and isinstance(back["t"], torch.Tensor)
    assert torch.equal(back["t"].view(torch.int16 if dtype != torch.float32
                                      else torch.int32),
                       k.view(torch.int16 if dtype != torch.float32
                              else torch.int32))
    assert torch.equal(back["ts"][0][0], k[0])
    assert back["ts"][0][1].dtype == np.float16
    np.testing.assert_array_equal(back["ts"][0][1], np.arange(6))
    assert isinstance(back["d"], tuple)
    # the JAX package's count for the same blob in numpy (bfloat16 as the
    # int16 bits it is stored as)
    np_k = k.view(torch.int16).numpy() if dtype == torch.bfloat16 \
        else k.numpy()
    jax_disk = j_prefix.DiskTier(str(tmp_path / "jax"), 1 << 20)
    ref = jax_disk.put(3, {"t": np_k, "ts": [(np_k[0], back["ts"][0][1])],
                           "d": (np.zeros((1, 2), np.float32),)})
    assert nb == ref == disk.used_bytes == p_prefix.blob_nbytes(blob)
    assert len(os.listdir(str(tmp_path / "kv"))) == 1
    disk.discard(3)
    assert os.listdir(str(tmp_path / "kv")) == [] and disk.used_bytes == 0


def test_async_loader_future_close_and_queued_cancel():
    import threading
    ld = p_prefetch.AsyncLoader(depth=4, workers=1)
    payload = [torch.arange(6, dtype=torch.float32), np.ones((2, 2))]
    out = ld.submit(payload).result(timeout=10.0)
    assert torch.equal(out[0], payload[0])
    gate, started = threading.Event(), threading.Event()

    def slow():
        started.set()
        assert gate.wait(10.0)
        return [torch.arange(3)]

    f1 = ld.submit(slow)
    assert started.wait(10.0)                 # the worker is inside f1
    f2 = ld.submit(lambda: 1 / 0)
    f3 = ld.submit([torch.ones(4)])
    opener = threading.Timer(0.15, gate.set)
    opener.start()
    try:
        ld.close(timeout=10.0)
    finally:
        opener.join()
    for f in (f2, f3):
        with pytest.raises(p_prefetch.TransferCancelled):
            f.result(timeout=1.0)
    assert torch.equal(f1.result(timeout=1.0)[0], torch.arange(3))
    assert not any(t.is_alive() for t in ld._threads)
    ld.close()                                # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        ld.submit(payload)
    failing = p_prefetch.AsyncLoader()
    with pytest.raises(ZeroDivisionError):
        failing.submit(lambda: 1 / 0).result(timeout=10.0)
    failing.close()


# -- the radix tree's tiers, scripted ----------------------------------------

def _cache_script(side, tmp, tiers):
    """One package's tree through demotion, overflow, promotion, upgrade
    and session pins; returns what it saw after every step."""
    one = side.prefix.blob_nbytes(_blob(side, 0.0))
    host = None
    if tiers:
        disk = (side.prefix.DiskTier(os.path.join(tmp, "disk"), 3 * one)
                if tiers == "host+disk" else None)
        host = side.prefix.HostTier(2 * one, next_tier=disk)
    c = side.prefix.RadixPrefixCache(
        4, host_tier=host,
        spill=(lambda node: _blob(side, float(node.page)))
        if host is not None else None)
    seen = []

    def note(*what):
        s = c.summary()
        seen.append([list(what), c.stats(), sorted(c.pages()),
                     sorted(s["tiers"].items()), c.audit_tiers(),
                     c.evictable_pages(), len(c), c.cached_pages])

    a = c.insert(np.arange(12), [5, 6, 7], 0, 3)
    b = c.insert(np.arange(100, 108), [8, 9], 0, 2)
    note("insert", [n.page for n in a + b])
    c.unpin(a)
    c.unpin(b)
    note("evict", c.evict(2))                    # the LRU chain's deepest
    path = c.match(np.arange(12))
    dev, tail = side.prefix.RadixPrefixCache.split_device(path)
    note("split", [n.page for n in dev], [n.residency for n in tail])
    c.session_pin(c.match(np.arange(100, 108)))
    note("evict", c.evict(3))                    # overflow down the tiers
    path = c.match(np.arange(12))
    dev, tail = side.prefix.RadixPrefixCache.split_device(path)
    note("split", [n.page for n in dev], [n.residency for n in tail])
    if tail:
        c.promote_node(tail[0], page=11, nbytes=64)
        note("promote", tail[0].residency)
    dev, _ = side.prefix.RadixPrefixCache.split_device(
        c.match(np.arange(12)))
    up = c.insert(np.arange(12), [11, 12, 13], len(dev), 3)
    note("upgrade", [n.page for n in up], c.upgrades)
    c.unpin(up)
    note("evict", c.evict(10))
    pinned = c.match(np.arange(100, 108))
    note("session", [n.residency for n in pinned], c.session_pinned_nodes())
    if pinned:
        c.session_unpin(pinned)
    c.insert(np.arange(200, 208), [1, 2], 0, 2)
    note("end", c.evict(10))
    return seen


@pytest.mark.parametrize("tiers", [None, "host", "host+disk"])
def test_cache_tiers_match_the_jax_package(tmp_path, tiers):
    got = _cache_script(PORT, str(tmp_path / "port"), tiers)
    ref = _cache_script(JAX, str(tmp_path / "jax"), tiers)
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a == b, f"step {i} differs"


def test_tier_quant_codes_and_scales_bit_equal():
    rng = np.random.RandomState(5)
    pages = rng.randn(3, 2, 4, 4, 16).astype(np.float32)   # [L, 2, H, bs, D]
    pages[0, 1, 2] = 0.0                                    # an all-zero head
    pages[1, 0, 1, 0, :4] = [63.5, -63.5, 0.5, 127.0]       # ties to even
    codes, scales = p_serving.PagedContinuousBatcher._quant_page(
        torch.from_numpy(pages))
    for li in range(3):
        for kv in range(2):
            q, s = j_serving.PagedContinuousBatcher._quant_page(
                pages[li, kv])
            assert q.dtype == np.int8 and s.dtype == np.float32
            np.testing.assert_array_equal(codes[li, kv].numpy(), q)
            assert scales[li, kv].numpy().tobytes() == s.tobytes()
    back = p_serving.PagedContinuousBatcher._dequant_rows(codes, scales)
    ref = [j_serving.PagedContinuousBatcher._dequant_rows(
        [(codes[li, 0].numpy(), codes[li, 1].numpy())],
        [(scales[li, 0].numpy(), scales[li, 1].numpy())])[0]
        for li in range(3)]
    for li in range(3):
        for kv in range(2):
            assert back[li, kv].numpy().tobytes() == ref[li][kv].tobytes()


# -- the paged batchers under churn -------------------------------------------

@pytest.fixture(scope="session")
def models():
    """(jax_model, port_model): the tiny GPT-2 with the same weights, built
    once in a process for this file and tests/test_torch_sessions.py."""
    paddle.seed(0)
    jm = JaxGPT2(JaxGPT2Config(**TINY))
    jm.eval()
    state = _gpt2_state(jm)
    jm.set_state_dict(state)
    pm = GPT2ForCausalLM(GPT2Config(**TINY), device="cpu").eval()
    pm.load_state_dict(gpt2_state_from_paddle_tpu(state))
    return jm, pm


def _churn_prompts(seed, n_prefixes=6, n_requests=14, prefix_len=12,
                   tail=3):
    """tests/test_kv_tier.py's churn stream at block 4: one cold pass over
    every shared prefix (their 18 pages overflow the 15-page pool), then
    re-references that must come back by promotion; unique tails."""
    rng = np.random.RandomState(seed)
    prefixes = [rng.randint(0, 128, (prefix_len,)).astype(np.int64)
                for _ in range(n_prefixes)]
    picks = (list(range(n_prefixes))
             + list(rng.randint(0, n_prefixes,
                                (max(n_requests - n_prefixes, 0),))))
    return [np.concatenate([prefixes[p], rng.randint(0, 128, (tail,))])
            for p in picks]


def _series(side):
    out = {}
    for inst in side.metrics.get_registry()._instruments():
        s = inst._series()
        key = (s["name"], tuple(sorted((s["labels"] or {}).items())))
        if s["name"] in COUNTERS:
            out[key] = s["value"]
        elif s["name"] in HISTOGRAMS:
            out[key] = s["count"]
    return out


def _delta(now, base):
    return sorted((k, v - base.get(k, 0)) for k, v in now.items()
                  if v - base.get(k, 0))


def churn_run(side, models, seed, tier_quant=None, chaos=None,
              loader="sync"):
    """One package's paged batcher with a host tier over the churn stream;
    returns its tokens, cache counters, tier audit and series."""
    model = models[0] if side.jax else models[1]
    b = side.serving.PagedContinuousBatcher(model, tier_quant=tier_quant,
                                            **TIERED)
    if side.jax:
        _margin_guard(b)
    if loader == "sync":
        b._promoter.close()
        b._promoter = SyncLoader(side.prefetch)
    base = _series(side)
    if chaos:
        side.chaos.arm_scenario(chaos)
    try:
        prompts = _churn_prompts(seed)
        rids = [b.submit(p, NEW) for p in prompts]
        outs = b.run_until_done(max_steps=20000)
        side.chaos.disarm()
        b.audit_pages()
        host = b._host_bytes_g.value
        return {"tokens": [np.asarray(outs[r]).tolist() for r in rids],
                "stats": b.prefix_cache.stats(),
                "audit": b.prefix_cache.audit_tiers(),
                "series": _delta(_series(side), base),
                "host_bytes_gauge": host,
                "promo": b._promo is None}
    finally:
        b.close()


CHURNS = {"seed3": (3, None, None), "seed11": (11, None, None),
          "seed3_int8": (3, "int8", None), "seed11_int8": (11, "int8", None),
          "promote_chaos": (5, None,
                            "seed=0; kv.host_promote:transient_error:"
                            "count=999"),
          "demote_chaos": (9, None,
                           "seed=0; kv.host_demote:transient_error:p=0.5")}


def test_churns_match_the_jax_batcher(models):
    """Every churn in one test: the JAX package compiles the geometry's
    ops once in a process, and a test runner that spreads tests over
    worker processes would pay that in each worker a case landed on."""
    for name, (seed, tq, chaos) in CHURNS.items():
        with paddle.no_grad():
            ref = churn_run(JAX, models, seed, tq, chaos)
        with torch.no_grad():
            got = churn_run(PORT, models, seed, tq, chaos)
        assert got == ref, name
        st = got["stats"]
        if name == "promote_chaos":
            assert st["promotion_failures"] > 0 and st["promotions"] == 0
            assert st["demotions"] > 0
        elif name == "demote_chaos":
            assert st["demote_failures"] > 0
        else:
            assert st["demotions"] > 0 and st["promotions"] > 0, name
            assert st["host_hit_tokens"] > 0, name
        if tq:
            series = dict(got["series"])
            assert series[("serving.prefix_spill_blob_bytes", ())] < \
                0.55 * series[("serving.prefix_spill_raw_bytes", ())]


@pytest.fixture(scope="session")
def port_model():
    """The tiny GPT-2 in the port alone, for port-only runs."""
    return GPT2ForCausalLM(GPT2Config(**TINY), device="cpu").eval()


def test_async_promotion_gives_the_sync_tokens(port_model):
    """The port's own worker thread: the schedule may shift by a step, the
    tokens may not (the loader that completes at submit gives the JAX
    package's, above)."""
    models = (None, port_model)
    with torch.no_grad():
        ref = churn_run(PORT, models, 3)
        got = churn_run(PORT, models, 3, loader="async")
    assert got["tokens"] == ref["tokens"]
    assert got["stats"]["promotions"] > 0 and got["promo"]
