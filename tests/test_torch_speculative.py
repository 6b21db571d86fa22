"""The port's speculative decoding against the JAX package's, on the CPU.

- ``generate_paged_speculative`` for both families and across them, with
  the drafts of tests/test_speculative.py (GPT-2: a smaller draft, another
  seed, the target itself; Llama: another Llama, a GPT-2): the tokens equal
  the JAX loop's, which are the JAX package's greedy tokens
  (tests/test_speculative.py holds them to ``generate``), and for one
  draft a family ``return_stats`` equals the JAX loop's. The verify pass
  (``paged_prefill_into(logits_all=True)``) gives the JAX logits within
  1e-4 of the largest.
- The EOS and budget edges against the port's own greedy tokens, and the
  guards with the JAX package's texts.
- The paged batcher with a draft, in tests/test_prefix_cache.py's
  scenarios (draft seeds 0, 1 and 2, and with the prefix cache): tokens
  and ``spec_stats`` equal the JAX batcher's, with clean page audits; the
  batcher's draft guards raise the JAX package's errors.
- tests/test_gateway.py's failover drill with speculation: two paged
  replicas with the prefix cache and a draft, one killed by chaos, held
  to the JAX gateway tick for tick (test_torch_gateway.py's record).
- Demotion and promotion of both pools under a host tier, plain and with
  ``tier_quant="int8"``: tokens, ``spec_stats``, cache counters and tier
  audits equal the JAX batcher's (both given a loader that completes at
  submit, as in test_torch_kv_tier.py).

Every JAX result is computed once a run (test_torch_refcache.py), in five
bundles that compute in parallel under xdist; the port's models are built
from the JAX models' numpy states. The JAX loop runs its steps compiled
(``compile=True``, XLA executables, several times faster than op by op on
the CPU); the JAX batchers run op by op (compiled, their draft step
donates the per-batch constants the draft state shares with the
target's, and it was slower here in any case); the port's run eagerly, as
CUDA graphs need the card. The batcher, gateway and tier scenarios share
one geometry and one prompt length, so the JAX package compiles each op
once for a bundle. The models use ``initializer_range`` 0.2, and the JAX
batchers' greedy picks (the target's and the draft's) must clear a
top-1/top-2 margin of 1e-3, so a near-tie shows up as a fixture problem,
not as a port fault.
"""
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import serving as j_serving
from paddle_tpu.models import GPT2Config as JaxGPT2Config
from paddle_tpu.models import GPT2ForCausalLM as JaxGPT2
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny_config as jax_llama_tiny
from paddle_tpu_torch.inference import serving as p_serving
from paddle_tpu_torch.models import (GPT2Config, GPT2ForCausalLM,
                                     LlamaForCausalLM,
                                     gpt2_state_from_paddle_tpu,
                                     llama_state_from_paddle_tpu,
                                     llama_tiny_config)
from test_torch_gateway import JAX as GW_JAX
from test_torch_gateway import PORT as GW_PORT
from test_torch_gateway import TINY
from test_torch_gateway import _run as gw_run
from test_torch_gpt2_serving import _gpt2_state
from test_torch_kv_tier import JAX as KV_JAX
from test_torch_kv_tier import PORT as KV_PORT
from test_torch_kv_tier import SyncLoader, _churn_prompts
from test_torch_refcache import jax_refs, normalize, register  # noqa: F401

MARGIN = 1e-3
LOGIT_REL = 1e-4
INIT = 0.2


# -- the models --------------------------------------------------------------

def _gpt_cfg(layers=2, hidden=64, positions=96):
    return dict(vocab_size=128, hidden_size=hidden, num_hidden_layers=layers,
                num_attention_heads=4, max_position_embeddings=positions,
                dropout=0.0, initializer_range=INIT)


LLAMA = dict(max_position_embeddings=96, initializer_range=INIT)

# name -> (family, config, seed): tests/test_speculative.py's models
# (targets and drafts), and for the batcher, gateway and tier scenarios
# test_torch_gateway.py's GPT-2 (``tgt``, its biases and norms drawn) with
# drafts of its shape from the seeds of tests/test_prefix_cache.py and
# tests/test_gateway.py
MODELS = {"gpt": ("gpt2", _gpt_cfg(), 0),
          "gpt_small": ("gpt2", _gpt_cfg(1, 32), 1),
          "gpt_other": ("gpt2", _gpt_cfg(), 7),
          "gpt_draft4": ("gpt2", _gpt_cfg(), 4),
          "llama": ("llama", LLAMA, 0),
          "llama_draft": ("llama", LLAMA, 3),
          "tgt": ("gpt2_drawn", TINY, 0),
          "d1": ("gpt2", TINY, 1),
          "d2": ("gpt2", TINY, 2),
          "d9": ("gpt2", TINY, 9),
          "d42": ("gpt2", TINY, 42)}
# the guards' draft of another vocabulary (the guards read configs only)
SMALL_VOCAB = dict(_gpt_cfg(1, 32, 64), vocab_size=64)


def _jax_model(name):
    family, cfg, seed = MODELS[name]
    paddle.seed(seed)
    if family == "llama":
        m = JaxLlama(jax_llama_tiny(**cfg))
    else:
        m = JaxGPT2(JaxGPT2Config(**cfg))
    m.eval()
    if family == "gpt2_drawn":            # biases and norms drawn too
        m.set_state_dict(_gpt2_state(m))
    return m


def _state(m):
    return {k: np.asarray(v.numpy(), np.float32)
            for k, v in m.state_dict().items()}


def _port_model(name, state):
    family, cfg, _ = MODELS[name]
    if family == "llama":
        m = LlamaForCausalLM(llama_tiny_config(**cfg), device="cpu")
        m.load_state_dict(llama_state_from_paddle_tpu(state))
    else:
        m = GPT2ForCausalLM(GPT2Config(**cfg), device="cpu")
        m.load_state_dict(gpt2_state_from_paddle_tpu(state))
    return m.eval()


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, 128, (n,)).astype(np.int64)


# tests/test_speculative.py's cases: target, drafts, prompt, new tokens, k;
# the first draft of each family's list also has its stats compared
STANDALONE = {"gpt2": ("gpt", ["gpt_small", "gpt_other", "gpt"],
                       _prompt(50, 11), 14, 4),
              "llama": ("llama", ["llama_draft", "gpt_draft4", "llama"],
                        _prompt(51, 9), 12, 3)}
STANDALONE_CASES = [(fam, d) for fam, (_, ds, _, _, _) in STANDALONE.items()
                    for d in ds]
BLOCK = 8


def _margins_ok(logits):
    top2 = np.sort(np.asarray(logits).reshape(-1, logits.shape[-1]),
                   axis=-1)[:, -2:]
    assert np.all(top2[:, 1] - top2[:, 0] > MARGIN), "fixture near-tie"


def _shared_prompts(seed, n, shared_len=12, tail=3):
    """tests/test_prefix_cache.py's prompts cut to the shared geometry: a
    shared prefix of 3 blocks and 3-token tails, so every prompt has
    test_torch_kv_tier.py's churn length (one prefill shape a model)."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, 128, (shared_len,))
    return [np.concatenate([shared, rng.randint(0, 128, (tail,))])
            for _ in range(n)]


# -- the batcher scenarios, run the same on either package -------------------

# One geometry for every batcher, gateway and tier scenario (the JAX
# package compiles each op at each new shape): 2 slots of 8 blocks of 4,
# draft_k 3, on test_torch_gateway.py's GPT-2; tests/test_prefix_cache.py's
# and tests/test_gateway.py's prompts cut to it (a shared 12-token prefix)
BATCHER = dict(max_batch=2, s_max=32, block_size=4, draft_k=3)
# scenario -> (draft, prompts seed, prompts, extra batcher options)
BATCHER_RUNS = {"draft_seed0": ("tgt", 11, 3, {}),
                "draft_seed1": ("d1", 12, 3, {}),
                "draft_seed2": ("d2", 13, 3, {}),
                "prefix_cache": ("d9", 13, 4,
                                 dict(n_pages=12, policy="ondemand",
                                      prefix_cache=True,
                                      prompt_buckets="pow2"))}
TIERED = dict(BATCHER, n_pages=15, policy="ondemand", prefix_cache=True,
              host_kv_gib=0.25)
# scenario -> (draft, churn seed, tier_quant): the self draft shows that
# promoted draft rows are the demoted ones (a stale row would cost matches)
TIER_RUNS = {"plain": ("tgt", 3, None), "tier_quant": ("d1", 11, "int8")}


def _spec_guard(b):
    """Every greedy pick of a JAX batcher's live rows, the target's and the
    draft's, must clear the margin: the draft's picks decide the stats."""
    for attr in ("_catchup_fn", "_dstep_fn", "_verify_fn"):
        fn = getattr(b, attr)

        def guarded(*args, _fn=fn):
            out = _fn(*args)
            _margins_ok(np.asarray(out[0].numpy())[list(b._slot_req)])
            return out
        setattr(b, attr, guarded)
    pick = b._pick

    def picked(logits_np):
        _margins_ok(logits_np[list(b._slot_req) or [0]]
                    if logits_np.shape[0] == b.max_batch else logits_np)
        return pick(logits_np)
    b._pick = picked
    return b


def batcher_run(jax, models, name):
    draft, seed, n, extra = BATCHER_RUNS[name]
    serving = j_serving if jax else p_serving
    b = serving.PagedContinuousBatcher(
        models["tgt"], compile=False, draft_model=models[draft],
        **BATCHER, **extra)
    if jax:
        _spec_guard(b)
    prompts = _shared_prompts(seed, n)
    rids = [b.submit(p, 8) for p in prompts]
    outs = b.run_until_done()
    b.audit_pages()
    return {"tokens": [np.asarray(outs[r]).tolist() for r in rids],
            "spec_stats": dict(b.spec_stats),
            "hit_tokens": (b.prefix_cache.hit_tokens
                           if b.prefix_cache is not None else None),
            "leaked": b._pages_leaked_g.value}


def tier_run(side, models, name):
    draft, seed, tq = TIER_RUNS[name]
    b = side.serving.PagedContinuousBatcher(
        models["tgt"], compile=False, draft_model=models[draft],
        tier_quant=tq, **TIERED)
    if side.jax:
        _spec_guard(b)
    b._promoter.close()
    b._promoter = SyncLoader(side.prefetch)
    try:
        prompts = _churn_prompts(seed)
        rids = [b.submit(p, 4) for p in prompts]
        outs = b.run_until_done(max_steps=20000)
        b.audit_pages()
        return {"tokens": [np.asarray(outs[r]).tolist() for r in rids],
                "spec_stats": dict(b.spec_stats),
                "stats": b.prefix_cache.stats(),
                "audit": b.prefix_cache.audit_tiers()}
    finally:
        b.close()


def gw_failover(run, side, clock, models):
    """tests/test_gateway.py::test_gateway_failover_with_speculation_
    reprefixes: paged replicas with the prefix cache and a disagreeing
    draft; chaos kills one mid-decode; the requeued requests re-match
    their cached prefix on the survivor, token-exact, and no page leaks."""
    serving = j_serving if side.jax else p_serving

    def paged():
        b = serving.PagedContinuousBatcher(
            models["tgt"], compile=False, prefix_cache=True,
            draft_model=models["d42"], **BATCHER)
        return _spec_guard(b) if side.jax else b
    rng = np.random.RandomState(21)
    shared = rng.randint(0, 128, (12,)).astype(np.int64)
    tails = np.random.RandomState(22)
    prompts = [np.concatenate([shared, tails.randint(0, 128, (3,))])
               for _ in range(4)]
    gw = side.gw.Gateway(policy="affinity")
    gw.add_replica("r0", paged())
    gw.add_replica("r1", paged())
    gids = [gw.submit(p, 10) for p in prompts]
    side.chaos.arm_scenario(
        "seed=0; serving.step:transient_error:after=6,count=3")
    for _ in range(200):
        run.tick(gw)
        if any(not r.alive for r in gw.pool.replicas()):
            break
    survivor = next(r for r in gw.pool.replicas() if r.alive)
    hits = survivor.batcher.prefix_cache.hit_tokens
    run.until_done(gw)
    run.note([r.alive for r in gw.pool.replicas()],
             survivor.batcher.prefix_cache.hit_tokens - hits,
             {r.name: [dict(r.batcher.spec_stats), r.batcher.audit_pages()]
              for r in gw.pool.replicas()})
    run.results(gw, gids)


def _guard_errors(target, drafts, cls, case):
    """A batcher guard's (type, text) for a draft configuration both
    packages refuse (tests/test_prefix_cache.py's gates and the rest of the
    JAX package's draft guards, in its order); ``drafts`` by vocabulary."""
    kw = dict(BATCHER_GUARDS[case])
    draft = drafts[kw.pop("vocab", 128)]
    try:
        cls(target, compile=False, max_batch=2, s_max=32, block_size=4,
            draft_model=draft, **kw)
    except Exception as e:                 # noqa: BLE001 — compared
        return [type(e).__name__, str(e)]
    return None


def _config_only(config):
    """A stand-in model for the guards, which read its config only."""
    return types.SimpleNamespace(config=config, _cachekv_scales=None)


BATCHER_GUARDS = [dict(draft_k=0), dict(do_sample=True),
                  dict(decode_block=4), dict(prefill_chunk=8,
                                             fused_admission=True),
                  dict(cache_quant="dynamic_int8", prefill_chunk=8),
                  dict(prefill_chunk=8), dict(vocab=64),
                  dict(kv_quant="int8")]
GUARD_IDS = ["draft_k", "do_sample", "decode_block", "fused_admission",
             "cache_quant", "prefill_chunk", "vocab", "kv_quant"]


# -- the JAX side, once a run -------------------------------------------------

def _standalone_ref(models, fam):
    """The JAX loop's tokens (its greedy ones: tests/test_speculative.py
    holds them to ``generate``) and stats with the family's first draft,
    its steps compiled, and the verify pass's logits after the prompt."""
    target, drafts, prompt, new, k = STANDALONE[fam]
    tm = models[target]
    ids = paddle.to_tensor(prompt[None])
    with paddle.no_grad():
        out, stats = tm.generate_paged_speculative(
            ids, new, models[drafts[0]], draft_k=k, block_size=BLOCK,
            return_stats=True)
        want = np.asarray(out.numpy())[0]
        # the verify pass: pending token and k proposals after the prompt
        tail = paddle.to_tensor(want[None, len(prompt):len(prompt) + k + 1])
        _, state = tm.paged_prefill(ids, BLOCK, 4)
        verify, _ = tm.paged_prefill_into(
            tail, state["layers"], state["block_tables"], BLOCK,
            dec_base=paddle.to_tensor(np.array([len(prompt)], np.int32)),
            logits_all=True)
    return {"tokens": want, "stats": stats,
            "verify": np.asarray(verify.numpy())}


def _jax_guard_text(case):
    """The JAX loop's ValueError text for a guard case, on config-only
    stand-ins (every guard raises before a model runs)."""
    ids, new, vocab, kw = _loop_guards()[case]
    target = _config_only(JaxGPT2Config(**MODELS["gpt"][1]))
    draft = (target if vocab == 128 else
             _config_only(JaxGPT2Config(**SMALL_VOCAB)))
    kw = dict(dict(draft_k=4, block_size=BLOCK, eos_id=None,
                   compile=False, return_stats=False), **kw)
    with pytest.raises(ValueError) as e:
        JaxGPT2._speculative_loop(target, draft, paddle.to_tensor(ids), new,
                                  **kw)
    return str(e.value)


def _loop_guards():
    return [(np.zeros((1, 8), np.int64), 4, 128, dict(draft_k=0)),
            (np.zeros((2, 8), np.int64), 4, 128, {}),
            (np.zeros((1, 8), np.int64), 4, 64, {}),
            (np.zeros((1, 90), np.int64), 20, 128, {})]


LOOP_GUARD_IDS = ["draft_k", "single_sequence", "vocab",
                  "max_position_embeddings"]

def _compute(models, key):
    with paddle.no_grad():
        if key == "states":
            return {n: _state(m) for n, m in models.items()}
        kind, _, name = key.partition(".")
        if kind == "standalone":
            return _standalone_ref(models, name)
        if kind == "batcher":
            return batcher_run(True, models, name)
        if kind == "tiers":
            return tier_run(KV_JAX, models, name)
        return gw_run(gw_failover, GW_JAX, models)


# The JAX side in five bundles (test_torch_refcache.py), each its JAX
# models and keys: the keys of a bundle share the JAX package's per-shape
# compiles in one process, and the bundles compute in parallel in separate
# workers, so that no more than a few tests wait for any one of them.
# Each bundle's first key is its models' states.
GROUPS = {"gpt2": (["gpt", "gpt_small", "gpt_other"], ["standalone.gpt2"]),
          "llama": (["llama", "llama_draft", "gpt_draft4"],
                    ["standalone.llama"]),
          "serving_a": (["tgt", "d1", "d2"],
                        [f"batcher.draft_seed{i}" for i in range(3)]),
          "serving_b": (["tgt", "d9", "d1"],
                        ["batcher.prefix_cache", "tiers.plain",
                         "tiers.tier_quant"]),
          "serving_c": (["tgt", "d42"], ["gateway"])}
REFS = {g: register(f"speculative.{g}",
                    {n: list(MODELS[n]) for n in names}, ["states"] + keys,
                    lambda names=names: {n: _jax_model(n) for n in names},
                    _compute)
        for g, (names, keys) in GROUPS.items()}
# where each key and each model's state comes from
KEY_GROUP = {k: g for g, (_, keys) in GROUPS.items() for k in keys}
MODEL_GROUP = {}
for _g, (_names, _) in GROUPS.items():
    for _n in _names:
        MODEL_GROUP.setdefault(_n, _g)


class _Refs:
    """The JAX results by key, from their bundles."""

    def __init__(self, jax_refs):
        self.bundles = {g: jax_refs(name) for g, name in REFS.items()}

    def __getitem__(self, key):
        return self.bundles[KEY_GROUP[key]][key]

    def state(self, name):
        return self.bundles[MODEL_GROUP[name]]["states"][name]


@pytest.fixture(scope="module")
def refs(jax_refs):
    return _Refs(jax_refs)


class _Models(dict):
    """The port's models, each built on first use from its JAX model's
    state."""

    def __init__(self, refs):
        super().__init__()
        self.refs = refs

    def __missing__(self, name):
        self[name] = m = _port_model(name, self.refs.state(name))
        return m


@pytest.fixture(scope="module")
def models(refs):
    return _Models(refs)


# -- the standalone loop -----------------------------------------------------

@pytest.mark.parametrize("fam,draft", STANDALONE_CASES,
                         ids=[f"{f}-{d}" for f, d in STANDALONE_CASES])
def test_standalone_tokens_equal_the_jax_greedy(refs, models, fam, draft):
    target, drafts, prompt, new, k = STANDALONE[fam]
    ref = refs[f"standalone.{fam}"]
    out, stats = models[target].generate_paged_speculative(
        torch.from_numpy(prompt[None]), new, models[draft], draft_k=k,
        block_size=BLOCK, compile=False, return_stats=True)
    assert out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy()[0], ref["tokens"])
    assert stats["rounds"] > 0
    if draft == drafts[0]:
        assert normalize(stats) == ref["stats"]
    if draft == target:                    # the self draft accepts all
        assert stats["acceptance_rate"] == 1.0
        assert stats["tokens_per_target_dispatch"] > 1.0


@pytest.mark.parametrize("fam", list(STANDALONE))
def test_verify_pass_logits_match(refs, models, fam):
    target, _, prompt, _, k = STANDALONE[fam]
    tm, ref = models[target], refs[f"standalone.{fam}"]
    _, state = tm.paged_prefill(torch.from_numpy(prompt[None]), BLOCK, 4)
    tail = torch.from_numpy(ref["tokens"][None, len(prompt):
                                          len(prompt) + k + 1].copy())
    got, layers = tm.paged_prefill_into(
        tail, state["layers"], state["block_tables"], BLOCK,
        dec_base=torch.tensor([len(prompt)], dtype=torch.int32),
        logits_all=True)
    assert got.shape == (1, k + 1, 128) and layers is not None
    want = ref["verify"]
    assert np.abs(got.numpy() - want).max() <= LOGIT_REL * np.abs(want).max()


@pytest.mark.parametrize("case", ["eos", "one", "zero", "six"])
def test_eos_and_budget_edges(models, case):
    """tests/test_speculative.py's edges against the port's own greedy:
    an EOS mid-generation truncates there, a budget of one runs no round,
    zero returns the prompt, and a budget that is not a multiple of
    draft_k shrinks the last rounds."""
    tm, dm = models["gpt"], models["gpt_small"]
    prompt = _prompt(52, 10)
    ids = torch.from_numpy(prompt[None])
    full = tm.generate(ids, max_new_tokens=12).numpy()[0]
    kw = dict(draft_k=4, block_size=BLOCK, compile=False)
    if case == "eos":
        eos = int(full[len(prompt) + 4])
        first = list(full[len(prompt):]).index(eos)
        out = tm.generate_paged_speculative(ids, 12, dm, eos_id=eos, **kw)
        np.testing.assert_array_equal(out.numpy()[0],
                                      full[:len(prompt) + first + 1])
        return
    n = {"one": 1, "zero": 0, "six": 6}[case]
    out, stats = tm.generate_paged_speculative(ids, n, dm,
                                               return_stats=True, **kw)
    np.testing.assert_array_equal(out.numpy()[0], full[:len(prompt) + n])
    if n <= 1:
        assert stats["rounds"] == 0


@pytest.mark.parametrize("case", range(4), ids=LOOP_GUARD_IDS)
def test_loop_guards_raise_the_jax_texts(models, case):
    ids, new, vocab, kw = _loop_guards()[case]
    draft = (models["gpt"] if vocab == 128 else GPT2ForCausalLM(
        GPT2Config(**SMALL_VOCAB), device="cpu"))
    with pytest.raises(ValueError) as e:
        models["gpt"].generate_paged_speculative(
            torch.from_numpy(ids), new, draft, **kw)
    assert str(e.value) == _jax_guard_text(case)


def test_compile_needs_the_card(models):
    tm = models["gpt"]
    with pytest.raises(ValueError, match="compile=False"):
        tm.generate_paged_speculative(torch.from_numpy(_prompt(50, 11)[None]),
                                      4, models["gpt_small"])
    with pytest.raises(ValueError, match="compile=False"):
        p_serving.PagedContinuousBatcher(tm, max_batch=2, s_max=32,
                                         draft_model=models["gpt_small"])


# -- the paged batcher -------------------------------------------------------

@pytest.mark.parametrize("name", list(BATCHER_RUNS))
def test_batcher_matches_the_jax_batcher(refs, models, name):
    with torch.no_grad():
        got = batcher_run(False, models, name)
    ref = refs[f"batcher.{name}"]
    assert normalize(got) == ref
    assert got["spec_stats"]["rounds"] > 0 and got["leaked"] == 0
    if name == "draft_seed0":             # the self draft matches
        assert got["spec_stats"]["matched"] > 0
    if name == "prefix_cache":
        assert got["hit_tokens"] > 0


@pytest.mark.parametrize("case", range(len(BATCHER_GUARDS)), ids=GUARD_IDS)
def test_batcher_guards_raise_the_jax_errors(models, case):
    small = GPT2ForCausalLM(GPT2Config(**SMALL_VOCAB), device="cpu")
    got = _guard_errors(models["tgt"], {128: models["d1"], 64: small},
                        p_serving.PagedContinuousBatcher, case)
    jax_cfg = {v: _config_only(JaxGPT2Config(**cfg))
               for v, cfg in ((128, TINY), (64, SMALL_VOCAB))}
    ref = _guard_errors(jax_cfg[128], jax_cfg,
                        j_serving.PagedContinuousBatcher, case)
    assert got is not None and got == ref


@pytest.mark.parametrize("name", list(TIER_RUNS))
def test_tiers_demote_and_promote_both_pools(refs, models, name):
    with torch.no_grad():
        got = tier_run(KV_PORT, models, name)
    assert normalize(got) == refs[f"tiers.{name}"]
    st = got["stats"]
    assert st["demotions"] > 0 and st["promotions"] > 0
    assert got["spec_stats"]["rounds"] > 0
    if name == "plain":                  # the self draft
        assert got["spec_stats"]["matched"] > 0


def test_gateway_failover_with_speculation_matches(refs, models):
    got = normalize(gw_run(gw_failover, GW_PORT, models))
    ref = refs["gateway"]
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a == b, f"record {i} differs"
    alive, rehit, reps = got[-2]
    assert alive.count(False) == 1 and rehit > 0
    assert all(audit == 0 for _, audit in reps.values())
    stats = got[-3][2]
    assert stats["requeued"] > 0 and stats["failures"] == 0
