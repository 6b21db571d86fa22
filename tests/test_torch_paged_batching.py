"""The port's PagedContinuousBatcher (paddle_tpu_torch.inference) and Llama's
paged methods against the JAX package's, on the CPU.

Llama tiny (GQA 4/2, two layers, float32) with the same weights in both
packages (moved across by models/convert.py): ``paged_prefill`` and
``paged_decode_step`` logits within 1e-4, ``generate_paged`` tokens equal to
the JAX package's and to the port's own ``generate``.

Both batchers serve that model; both run with compile=False (the port's
CUDA graph needs a card). Each scenario below mirrors a test of
tests/test_paged_batching.py, tests/test_prefix_cache.py or
tests/test_continuous_batching.py: it drives a batcher through the API the
two packages share, asserts the reference test's assertions on it, checks
that the page audit is clean, and returns what it saw. Each JAX result is
computed once per process (module fixture, on first use) and the port's
must equal it: every token, every typed failure, every count. The fixture
asserts a top-1/top-2 logit margin above 1e-3 at every greedy pick the JAX
batcher makes, so a near-tie shows up as a fixture problem rather than as a
port fault.

The radix prefix cache's host-side operations are held to the JAX
package's on scripted sequences, and the options that wait to be ported
must raise.

The JAX package runs op by op here, and each new shape costs it a compile,
so the scenarios and the model checks share one geometry where they can.
"""
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import prefix_cache as jax_prefix_cache
from paddle_tpu.inference import serving as jax_serving
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny_config as jax_tiny_config
from paddle_tpu.observability import metrics as jax_metrics
from paddle_tpu_torch import jit
from paddle_tpu_torch.inference import (HostTier, PagedContinuousBatcher,
                                        RadixPrefixCache, chain_hashes)
from paddle_tpu_torch.models import (LlamaForCausalLM,
                                     llama_state_from_paddle_tpu,
                                     llama_tiny_config)
from paddle_tpu_torch.observability import metrics as port_metrics

LOGIT_ATOL = 1e-4
MARGIN = 1e-3
NEW = 8
# tests/test_continuous_batching.py's Llama config
CFG = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
           num_key_value_heads=2, vocab_size=128, max_position_embeddings=64,
           initializer_range=0.2)


def _prompts(seed, lengths, vocab=128):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (s,)) for s in lengths]


def _pair(positions):
    """(jax_model, port_model) with the same weights and a RoPE table of
    ``positions`` rows; norm weights are drawn too, so the norms' scaling
    is exercised."""
    paddle.seed(0)
    cfg = dict(CFG, max_position_embeddings=positions)
    jm = JaxLlama(jax_tiny_config(**cfg))
    jm.eval()
    rng = np.random.RandomState(0)
    state = {k: np.asarray(v.numpy(), np.float32)
             for k, v in jm.state_dict().items()}
    for k in state:
        if k.endswith("norm.weight"):
            state[k] = (1.0 + 0.3 * rng.randn(*state[k].shape)
                        ).astype(np.float32)
    jm.set_state_dict(state)
    pm = LlamaForCausalLM(llama_tiny_config(**cfg), device="cpu")
    pm.load_state_dict(llama_state_from_paddle_tpu(state))
    return jm, pm


@pytest.fixture(scope="module")
def models():
    """The model pair with a 64-row RoPE table, and the same weights with a
    30-row table (for a slot capacity past the table)."""
    return {64: _pair(64), 30: _pair(30)}


class _Side:
    """One package's batcher factory and metrics registry, so a scenario
    runs the same code against either."""

    def __init__(self, make, metrics):
        self.make = make
        self.registry = metrics.get_registry()


def _margin_guard(b):
    """Wrap a JAX batcher's token pick: every greedy pick of a live row must
    clear the top-1/top-2 margin."""
    pick = b._pick

    def guarded(logits_np):
        rows = (list(b._slot_req) if logits_np.shape[0] == b.max_batch
                and b._slot_req else [0])
        top2 = np.sort(logits_np[rows], axis=-1)[:, -2:]
        assert np.all(top2[:, 1] - top2[:, 0] > MARGIN), "fixture near-tie"
        return pick(logits_np)

    b._pick = guarded
    return b


def _jax_side(models):
    def make(positions=64, **kw):
        b = jax_serving.PagedContinuousBatcher(models[positions][0],
                                               compile=False, **kw)
        return b if kw.get("do_sample") else _margin_guard(b)
    return _Side(make, jax_metrics)


def _port_side(models):
    def make(positions=64, **kw):
        return PagedContinuousBatcher(models[positions][1], compile=False,
                                      **kw)
    return _Side(make, port_metrics)


def _error_name(fn):
    """The type name of what ``fn()`` raises (the packages' classes differ,
    their names must not)."""
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__


def _drain(b, steps=40):
    done = []
    for _ in range(steps):
        done += b.step()
        if not b._has_work():
            break
    return done


def _pool_state(b):
    """The audit (raises on a leak), then where every page is."""
    assert b.audit_pages() == 0
    cached = (b.prefix_cache.cached_pages if b.prefix_cache is not None
              else 0)
    assert b.free_page_count + cached == b.n_pages
    assert (b._bt == b._scratch).all()
    return [b.free_page_count, cached]


def _count(side, name):
    fam = side.registry.get(name)
    return 0 if fam is None else fam.value


# -- scenarios: each returns what it saw; both packages must see the same ---

# Most scenarios share one geometry (2 slots, block 4, 8 blocks a slot, a
# pool of 15 pages and the scratch page: generate_paged's pool for 2
# sequences). Every prefill, chunk and suffix is 8 or 12 tokens wide
# (12 x 1 tokens are generate_paged's 2 x 6 to the attention): the JAX
# package compiles each op once per shape, which is most of this file's
# time.
GEOM = dict(max_batch=2, s_max=32, block_size=4, n_pages=15)


def reserve_slot_reuse(side):
    """More requests than slots: later arrivals admit into freed slots and
    recycled pages mid-run (test_paged_slot_and_page_reuse)."""
    b = side.make(**GEOM)
    prompts = _prompts(1, (12, 8, 8, 12, 8, 12))
    ns = (3, 7, 4, 6, 5, 4)
    rids = [b.submit(p, n) for p, n in zip(prompts[:3], ns[:3])]
    early = []
    for _ in range(3):
        early += b.step()
    rids += [b.submit(p, n) for p, n in zip(prompts[3:], ns[3:])]
    outs = b.run_until_done()
    for rid in early:
        outs[rid] = b.pop_result(rid)
    st = b.stats()
    return [[outs[r].tolist() for r in rids], _pool_state(b),
            [st[k] for k in ("steps", "generated_tokens", "preemptions",
                             "completed_requests", "mean_active_slots")]]


def ondemand_preemption(side):
    """A pool too small for both requests' full lengths: the later one is
    preempted and resumes exactly (test_ondemand_preemption_is_exact,
    test_ondemand_growth_allocates_lazily); admissions go through 8-token
    chunks, so the resumed prompt takes the same shapes."""
    b = side.make(policy="ondemand", prefill_chunk=8, **GEOM)
    prompts = _prompts(3, (8, 8))
    rids = [b.submit(p, 24) for p in prompts]
    b.step()
    after_admit = b.n_pages - b.free_page_count
    outs = b.run_until_done()
    st = b.stats()
    assert st["preemptions"] >= 1
    return [[outs[r].tolist() for r in rids], after_admit, _pool_state(b),
            st["preemptions"], st["steps"]]


def prefix_cache_shared(side):
    """Shared system prefixes through the radix cache, in waves, in a pool
    tight enough to evict idle chains (test_prefix_cache_batcher_token_
    exact_and_hits, test_prefix_cache_eviction_pressure_stays_exact)."""
    hit0 = _count(side, "serving.prefix_hit_tokens")
    miss0 = _count(side, "serving.prefix_miss_tokens")
    ev0 = _count(side, "serving.prefix_evictions")
    b = side.make(policy="ondemand", prefix_cache=True, **GEOM)
    rng = np.random.RandomState(20)
    systems = [rng.randint(0, 128, (4,)) for _ in range(3)]
    prompts = [np.concatenate([systems[i % 3], rng.randint(0, 128, (8,))])
               for i in range(12)]
    rids = []
    for i in range(0, 12, 2):
        rids += [b.submit(p, 2) for p in prompts[i:i + 2]]
        _drain(b)
    outs = {r: b.pop_result(r) for r in rids}
    cs = b.prefix_cache.stats()
    assert cs["hit_tokens"] > 0 and cs["evictions"] > 0
    return [[outs[r].tolist() for r in rids], _pool_state(b),
            [cs[k] for k in ("nodes", "cached_pages", "hit_tokens",
                             "miss_tokens", "evictions")],
            [_count(side, "serving.prefix_hit_tokens") - hit0,
             _count(side, "serving.prefix_miss_tokens") - miss0,
             _count(side, "serving.prefix_evictions") - ev0],
            side.registry.get("serving.pages_leaked").value]


def prefix_cache_preemption(side):
    """A slot that hit the cache is the one preempted: its pins and pages
    are released, and its resume hits again
    (test_prefix_cache_preemption_releases_pages); admissions go through
    8-token chunks after the cached prefix."""
    b = side.make(policy="ondemand", prefix_cache=True, prefill_chunk=8,
                  **GEOM)
    rng = np.random.RandomState(21)
    system = rng.randint(0, 128, (4,))
    first = np.concatenate([system, rng.randint(0, 128, (4,))])
    other = rng.randint(0, 128, (8,))
    hit = np.concatenate([system, rng.randint(0, 128, (4,))])
    rids = [b.submit(first, 2), b.submit(other, 24)]
    early = b.step() + b.step()            # the first finishes
    assert early == rids[:1]
    rids.append(b.submit(hit, 24))
    outs = b.run_until_done()
    outs[rids[0]] = b.pop_result(rids[0])
    st = b.stats()
    assert st["preemptions"] >= 1
    return [[outs[r].tolist() for r in rids], _pool_state(b),
            st["preemptions"], b.prefix_cache.stats()]


def pow2_ladder(side):
    """Prompts padded up the pow2 ladder's rung 8, with the pad tokens
    counted."""
    fam = side.registry.counter("serving.bucket_pad_waste",
                                labelnames=("rung",))

    def counts():
        return {c.labels["rung"]: c.value for c in fam.children()}

    before = counts()
    b = side.make(prompt_buckets="pow2", **GEOM)
    prompts = _prompts(11, (5, 8, 7, 6, 5))
    rids = [b.submit(p, 3) for p in prompts]
    outs = b.run_until_done()
    after = counts()
    return [[outs[r].tolist() for r in rids], _pool_state(b),
            {r: v - before.get(r, 0) for r, v in after.items()
             if v != before.get(r, 0)}]


def chunked_prefill(side):
    """Fixed-width chunks for prompts shorter, equal and longer than the
    chunk (test_chunked_prefill_token_exact_mixed_lengths); chunked
    admission under preemption is ondemand_preemption's."""
    b = side.make(prefill_chunk=8, **GEOM)
    prompts = _prompts(7, (3, 8, 13, 17))
    rids = [b.submit(p, 6) for p in prompts]
    outs = b.run_until_done()
    return [[outs[r].tolist() for r in rids], _pool_state(b)]


def capacity_clamps(side):
    """s_max 30 at block 4: capacity 32. Chunk 12 would pad a 25-token
    prompt to 36; the tail chunk shortens to 8 at the capacity instead
    (test_chunked_prefill_tail_clamped_to_capacity), and its pad rows 30-31
    lie past the model's 30-row RoPE table, whose last row both packages
    take for them; neither may change what is read."""
    b = side.make(positions=30, **dict(GEOM, s_max=30), prefill_chunk=12)
    (prompt,) = _prompts(13, (25,))
    rid = b.submit(prompt, 5)
    return [b.run_until_done()[rid].tolist(), _pool_state(b)]


def eos_early_stop(side):
    (prompt,) = _prompts(3, (8,))
    b = side.make(**GEOM)
    rid = b.submit(prompt, 4)
    full = b.run_until_done()[rid]
    eos = int(full[8 + 2])        # the 3rd generated token
    b = side.make(eos_id=eos, **GEOM)
    rid = b.submit(prompt, 10)
    got = b.run_until_done()[rid]
    assert int(got[-1]) == eos and len(got) <= len(full)
    return [full.tolist(), got.tolist(), _pool_state(b)]


def sampling(side):
    prompts = _prompts(6, (8, 8))
    seen = {}
    for seed, kw in ((7, {}), (7, dict(top_k=20, temperature=0.8))):
        b = side.make(do_sample=True, seed=seed, **GEOM, **kw)
        rids = [b.submit(p, 6) for p in prompts]
        outs = b.run_until_done()
        seen[f"{seed} {sorted(kw.items())}"] = [outs[r].tolist()
                                                 for r in rids]
    return seen


def deadlines_and_shedding(side):
    """A queued request expires, an active one expires mid-decode and gives
    its slot and pages to the next, and a full queue sheds
    (test_continuous_batching.py's deadline and shedding tests)."""
    b = side.make(default_deadline_s=1000.0, **GEOM)
    rid_q = b.submit(np.arange(8), 8, deadline_s=0.0)
    rid_x = b.submit(np.arange(8) + 1, 6)
    rid_a = b.submit(np.arange(8) + 2, 12, deadline_s=0.05)
    rid_b = b.submit(np.arange(8) + 3, 2)
    time.sleep(0.001)
    b.step()                               # admits X and A; B waits
    assert b.active == 2
    time.sleep(0.06)                       # A's deadline lapses mid-decode
    done = _drain(b)
    assert sorted(done) == sorted([rid_b, rid_x])
    st = b.stats()
    seen = [_error_name(lambda: b.result(rid_q)),
            _error_name(lambda: b.result(rid_a)),
            b.pop_result(rid_b).tolist(), b.pop_result(rid_x).tolist(),
            st["deadline_expired"], _pool_state(b)]
    b = side.make(max_queue_depth=2, **GEOM)
    b.submit(np.arange(8), 4)
    b.submit(np.arange(8), 4)
    seen.append(_error_name(lambda: b.submit(np.arange(8), 4)))
    seen.append(b.stats()["requests_shed"])
    seen.append(sorted(v.tolist() for v in b.run_until_done().values()))
    return seen + [_pool_state(b)]


SCENARIOS = [reserve_slot_reuse, ondemand_preemption, prefix_cache_shared,
             prefix_cache_preemption, pow2_ladder, chunked_prefill,
             capacity_clamps, eos_early_stop, sampling,
             deadlines_and_shedding]


class _Results(dict):
    """Each scenario's result on one side, computed on first use."""

    def __init__(self, side):
        super().__init__()
        self.side = side

    def __missing__(self, name):
        fn = next(f for f in SCENARIOS if f.__name__ == name)
        self[name] = result = fn(self.side)
        return result


@pytest.fixture(scope="module")
def jax_results(models):
    """The JAX batcher's results, each scenario computed once per test
    process (a worker runs only the scenarios it was given)."""
    return _Results(_jax_side(models))


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_the_jax_batcher(models, jax_results, scenario):
    got = scenario(_port_side(models))
    assert got == jax_results[scenario.__name__]


def test_stats_keys_and_serving_series(models):
    jb = jax_serving.PagedContinuousBatcher(models[64][0], max_batch=2,
                                            s_max=32, block_size=4,
                                            compile=False)
    b = PagedContinuousBatcher(models[64][1], max_batch=2, s_max=32,
                               block_size=4, compile=False,
                               prefix_cache=True)
    reg = port_metrics.get_registry()
    before = reg.get("serving_requests_total").labels(engine="paged").value
    for p in _prompts(3, (5, 5, 5)):
        b.submit(p, 4)
    b.run_until_done()
    assert set(b.stats()) == set(jb.stats())
    assert reg.get("serving_requests_total").labels(
        engine="paged").value == before + 3
    for name in ("serving.prefix_hit_tokens", "serving.prefix_miss_tokens",
                 "serving.prefix_evictions", "serving.prefix_tier_hit_tokens",
                 "serving.pages_leaked", "serving_preemptions_total"):
        assert reg.get(name) is not None, name
        assert jax_metrics.get_registry().get(name) is not None, name
    assert reg.get("serving.pages_leaked").value == 0
    assert set(b.prefix_cache.stats()) == set(
        jax_prefix_cache.RadixPrefixCache(4).stats())


def test_the_page_audit_raises_on_a_leak(models):
    b = PagedContinuousBatcher(models[64][1], max_batch=2, s_max=32,
                               block_size=4, compile=False)
    b._free_pages.pop()
    with pytest.raises(RuntimeError, match="leaked"):
        b.audit_pages()
    assert port_metrics.get_registry().get("serving.pages_leaked").value == 1
    b._free_pages.extend([0, 0])
    with pytest.raises(RuntimeError, match="twice"):
        b.audit_pages()


def test_capacity_validation(models):
    pm = models[64][1]
    b = PagedContinuousBatcher(pm, max_batch=2, s_max=16, block_size=8,
                               compile=False)
    with pytest.raises(ValueError, match="exceeds slot capacity"):
        b.submit(np.zeros(10, np.int64), 8)
    with pytest.raises(ValueError, match="max_new_tokens"):
        b.submit(np.zeros(4, np.int64), 0)
    small = PagedContinuousBatcher(pm, max_batch=1, s_max=16, block_size=8,
                                   n_pages=1, compile=False)
    with pytest.raises(ValueError, match="pool"):
        small.submit(np.zeros(6, np.int64), 8)
    for kw, msg in ((dict(policy="lazy"), "policy"),
                    (dict(prefill_chunk=0), "prefill_chunk"),
                    (dict(prefill_chunk=64), "exceeds s_max"),
                    (dict(s_max=128), "max_position_embeddings")):
        with pytest.raises(ValueError, match=msg):
            PagedContinuousBatcher(pm, **{"s_max": 32, "compile": False,
                                          **kw})


def test_compile_on_a_cpu_model_raises(models):
    with pytest.raises(ValueError, match="compile=False"):
        PagedContinuousBatcher(models[64][1], max_batch=2, s_max=32)


def _tier_layout(b):
    """What a batcher built of the tiers and sessions: the host and disk
    tiers' capacities, the promotion settings, the store's type."""
    cache = b.prefix_cache
    host = cache.host_tier if cache is not None else None
    disk = host.next_tier if host is not None else None
    return [cache is not None, b.tier_quant,
            None if host is None else host.capacity_bytes,
            None if disk is None else disk.capacity_bytes,
            b._promoter is not None, b.promo_slots, b.promo_chunk_blocks,
            b.promo_timeout_s, type(b.session_store).__name__]


@pytest.mark.parametrize("kw", [
    dict(tier_quant="int8", prefix_cache=True), dict(draft_model=object()),
    dict(host_kv_gib=1.0), dict(disk_kv_dir="kv"),
    dict(session_store="sessions")], ids=lambda kw: next(iter(kw)))
def test_options_that_wait_raise(models, kw, tmp_path):
    """draft_model waits for queue 1, item 1.5; the tier and session
    options (item 1.4) build what the JAX package builds from them, with
    the prefix cache and without it."""
    name = next(iter(kw))
    if name == "draft_model":
        with pytest.raises(NotImplementedError, match="item 1.5"):
            PagedContinuousBatcher(models[64][1], max_batch=2, s_max=32,
                                   compile=False, **kw)
        return
    kw = {k: str(tmp_path / v) if k in ("disk_kv_dir", "session_store")
          else v for k, v in kw.items()}
    for extra in (dict(prefix_cache=True, host_kv_gib=0.5),
                  dict(prefix_cache=False)):
        args = dict(max_batch=2, s_max=32, compile=False, **{**extra, **kw})
        got = PagedContinuousBatcher(models[64][1], **args)
        ref = jax_serving.PagedContinuousBatcher(models[64][0], **args)
        try:
            assert _tier_layout(got) == _tier_layout(ref)
        finally:
            got.close()
            ref.close()


def test_host_tier_from_the_environment_raises(models, monkeypatch,
                                               tmp_path):
    """PADDLE_KV_HOST_GIB, PADDLE_KV_DISK_DIR and PADDLE_KV_DISK_GIB build
    the tiers as in the JAX package (they raised before item 1.4)."""
    monkeypatch.setenv("PADDLE_KV_HOST_GIB", "1")
    monkeypatch.setenv("PADDLE_KV_DISK_DIR", str(tmp_path / "kv"))
    monkeypatch.setenv("PADDLE_KV_DISK_GIB", "0.5")
    args = dict(max_batch=2, s_max=32, compile=False, prefix_cache=True)
    got = PagedContinuousBatcher(models[64][1], **args)
    ref = jax_serving.PagedContinuousBatcher(models[64][0], **args)
    try:
        assert _tier_layout(got) == _tier_layout(ref)
        assert _tier_layout(got)[2:4] == [1 << 30, 1 << 29]
    finally:
        got.close()
        ref.close()
    with pytest.raises(ValueError, match="capacity"):
        RadixPrefixCache(4, host_tier=HostTier(0))
    for bad in (dict(promo_slots=0), dict(promo_chunk_blocks=0),
                dict(promo_slots=0, policy="lazy"),
                dict(promo_chunk_blocks=0, prefix_cache=True,
                     cache_quant="dynamic_int8")):
        errors = []
        for cls, m in ((PagedContinuousBatcher, models[64][1]),
                       (jax_serving.PagedContinuousBatcher, models[64][0])):
            with pytest.raises(ValueError) as info:
                cls(m, compile=False, **bad)
            errors.append(str(info.value))
        assert errors[0] == errors[1]


# -- the radix tree alone -----------------------------------------------------

def _radix_script(mod):
    """Inserts, matches, pins, LRU evictions under pins and a double
    release, on one package's RadixPrefixCache; returns what it saw."""
    c = mod.RadixPrefixCache(block_size=4)
    seen = []
    a = c.insert(np.arange(12), [7, 8, 9], 0, 3)          # chain A, pinned
    seen.append([n.page for n in a])
    other = np.concatenate([np.arange(4), np.arange(50, 58)])
    b = c.insert(other, [7, 3, 4], 1, 3)                  # shares block 0
    seen.append([n.page for n in b])
    seen.append([n.page for n in c.match(other, max_blocks=2)])
    seen.append(c.insert(np.arange(8), [5, 6], 0, 2))     # already cached
    c.unpin(b)
    seen.append([c.evictable_pages(), c.evict(1), sorted(c.pages())])
    c.unpin(a)
    c.pin(c.match(np.arange(4)))                          # root block hot
    seen.append([c.evictable_pages(), c.evict(10), sorted(c.pages())])
    seen.append(_error_name(lambda: c.unpin(c.match(np.arange(12)))
                            or c.unpin(c.match(np.arange(12)))))
    seen.append(sorted(c.summary()["hashes"].values()))
    seen.append(c.summary()["hashes"] == {
        h: i + 1 for i, h in enumerate(mod.chain_hashes(np.arange(4), 4))})
    st = c.stats()
    seen.append([st[k] for k in ("nodes", "cached_pages", "evictions")])
    seen.append(c.audit_tiers())
    return seen


def test_radix_tree_matches_the_jax_package():
    class _Port:
        RadixPrefixCache = RadixPrefixCache
        chain_hashes = staticmethod(chain_hashes)
    assert _radix_script(_Port) == _radix_script(jax_prefix_cache)


@pytest.mark.parametrize("n", [0, 3, 4, 11, 16])
def test_chain_hashes_match_the_jax_package(n):
    toks = np.random.RandomState(n).randint(0, 32000, n)
    assert chain_hashes(toks, 4) == jax_prefix_cache.chain_hashes(toks, 4)


def test_to_static_flattens_and_rebuilds_a_paged_state():
    leaves = []
    state = {"layers": [(1, 2), (3, 4)], "block_size": 16, "t": [5]}
    tree = jit._flatten(state, leaves)
    assert leaves == [1, 2, 3, 4, 16, 5]
    assert jit._unflatten(tree, iter(leaves)) == state
    with pytest.raises(TypeError, match="holds no tensor"):
        jit.to_static(lambda x: x, donate_args=(0,))({"a": 1})


# -- Llama tiny's paged methods ---------------------------------------------

def _margins(logits):
    top2 = np.sort(logits, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def _ids():
    return np.stack(_prompts(30, (6, 6)))


@pytest.fixture(scope="module")
def jax_paged(models):
    """The JAX package's paged prefill logits, each decode step's logits
    and generate_paged's tokens at block size 4 with 8 blocks a sequence
    (GEOM's pool), computed once; every greedy pick clears the margin."""
    jm = models[64][0]
    ids = paddle.to_tensor(_ids())
    with paddle.no_grad():
        logits, state = jm.paged_prefill(ids, 4, 8)
        steps = [np.asarray(logits.numpy())]
        for _ in range(NEW - 1):
            assert np.all(_margins(steps[-1]) > MARGIN), "fixture near-tie"
            tok = paddle.to_tensor(steps[-1].argmax(-1))
            logits, state = jm.paged_decode_step(tok, state)
            steps.append(np.asarray(logits.numpy()))
        tokens = np.asarray(jm.generate_paged(ids, NEW, block_size=4,
                                              blocks_per_seq=8).numpy())
    return steps, tokens


def test_paged_prefill_and_decode_logits(models, jax_paged):
    pm = models[64][1]
    steps, _ = jax_paged
    logits, state = pm.paged_prefill(torch.from_numpy(_ids()), 4, 8)
    assert set(state) == {"layers", "block_tables", "dec_lens",
                          "block_size", "capacity", "zeros_b", "ones_b",
                          "cu_b"}
    assert state["capacity"] == 32 and state["dec_lens"].tolist() == [6, 6]
    for i, ref in enumerate(steps):
        np.testing.assert_allclose(logits.numpy(), ref, atol=LOGIT_ATOL,
                                   rtol=0, err_msg=f"step {i}")
        if i + 1 < len(steps):
            tok = torch.from_numpy(ref.argmax(-1))
            logits, new_state = pm.paged_decode_step(tok, state)
            assert new_state["layers"][0][0] is state["layers"][0][0]
            assert new_state["dec_lens"].tolist() == [7 + i] * 2
            state = new_state


def test_generate_paged_tokens(models, jax_paged):
    pm = models[64][1]
    ids = torch.from_numpy(_ids())
    got = pm.generate_paged(ids, NEW, block_size=4, blocks_per_seq=8)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), jax_paged[1])
    np.testing.assert_array_equal(got.numpy(),
                                  pm.generate(ids, NEW).numpy())


def test_generate_paged_capacity_errors(models):
    pm = models[64][1]
    ids = torch.from_numpy(_ids())
    with pytest.raises(ValueError, match="max_position_embeddings"):
        pm.generate_paged(ids, 64)
    with pytest.raises(ValueError, match="capacity"):
        pm.generate_paged(ids, NEW, block_size=4, blocks_per_seq=3)


@pytest.mark.parametrize("kw,error,text", [
    (dict(dynamic_cache_scales=True), ValueError, "non-int8"),
    (dict(logits_all=True), NotImplementedError, "not ported")],
    ids=["int8", "logits_all"])
def test_paged_prefill_into_waiting_options_raise(models, kw, error, text):
    """Speculative verify waits; dynamic int8 scales on float pools break
    the scale contract (int8 pages: tests/test_torch_quant_serving.py)."""
    pm = models[64][1]
    with pytest.raises(error, match=text):
        pm.paged_prefill_into(torch.from_numpy(_ids()), pm.paged_alloc(8, 4),
                              torch.zeros(2, 4, dtype=torch.int32), 4, **kw)


def test_captured_paged_step_needs_the_card(models):
    """to_static flattens the paged state (pools, int32 tables, Python
    ints); a CPU tensor anywhere in it raises, as a flat one does."""
    pm = models[64][1]
    _, state = pm.paged_prefill(torch.from_numpy(_ids()), 4, 8)
    step = jit.to_static(pm.paged_decode_step, donate_args=(1,))
    with pytest.raises(ValueError, match="on the card"):
        step(torch.zeros(2, dtype=torch.int64), state)
