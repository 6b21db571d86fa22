"""The port's dense ContinuousBatcher (paddle_tpu_torch.inference) against the
JAX package's, on the CPU.

Both batchers serve Llama tiny (GQA 4/2, two layers, float32) with the same
weights (moved across by models/convert.py); the JAX batcher runs with
compile=False and the port's eagerly (compile=False: the CUDA graph needs a
card). Each scenario below mirrors a test of tests/test_continuous_batching.py,
tests/test_resilience.py or tests/test_observability.py; it drives a batcher
through the API the two packages share, asserts the reference test's
assertions on it, and returns what it saw. Each JAX result is computed once
(module fixture, on first use) and the port's must equal it: every token,
every typed failure, every count. The fixture asserts a top-1/top-2 logit
margin above 1e-3 at every greedy pick the JAX batcher makes, so a near-tie
shows up as a fixture problem rather than as a port fault. Float
comparisons use atol 1e-5 (float32, different summation orders).
"""
import json
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import serving as jax_serving
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny_config as jax_tiny_config
from paddle_tpu.models.gpt import GPT2ForCausalLM as JaxGPT2
from paddle_tpu.observability import metrics as jax_metrics
from paddle_tpu.resilience import chaos as jax_chaos
from paddle_tpu_torch import jit
from paddle_tpu_torch.inference import ContinuousBatcher
from paddle_tpu_torch.models import (LlamaForCausalLM,
                                     llama_state_from_paddle_tpu,
                                     llama_tiny_config)
from paddle_tpu_torch.models.generation import select_token
from paddle_tpu_torch.observability import fleet as port_fleet
from paddle_tpu_torch.observability import metrics as port_metrics
from paddle_tpu_torch.observability.trace_context import (get_recorder,
                                                          new_trace)
from paddle_tpu_torch.resilience import chaos as port_chaos

ATOL = 1e-5
MARGIN = 1e-3
# tests/test_continuous_batching.py's Llama config
CFG = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
           num_key_value_heads=2, vocab_size=128, max_position_embeddings=64,
           initializer_range=0.2)
S_MAX = 32


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (s,)) for s in lengths]


@pytest.fixture(scope="module")
def models():
    """(jax_model, port_model) with the same weights; norm weights are drawn
    too, so the norms' scaling is exercised."""
    paddle.seed(0)
    jm = JaxLlama(jax_tiny_config(**CFG))
    jm.eval()
    rng = np.random.RandomState(0)
    state = {k: np.asarray(v.numpy(), np.float32)
             for k, v in jm.state_dict().items()}
    for k in state:
        if k.endswith("norm.weight"):
            state[k] = (1.0 + 0.3 * rng.randn(*state[k].shape)
                        ).astype(np.float32)
    jm.set_state_dict(state)
    pm = LlamaForCausalLM(llama_tiny_config(**CFG), device="cpu")
    pm.load_state_dict(llama_state_from_paddle_tpu(state))
    return jm, pm


class _Side:
    """One package's batcher factory, chaos module and metrics registry, so
    a scenario runs the same code against either."""

    def __init__(self, make, chaos, metrics):
        self.make = make
        self.chaos = chaos
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


def _jax_side(jm):
    def make(**kw):
        b = jax_serving.ContinuousBatcher(jm, s_max=S_MAX, compile=False,
                                          **kw)
        return b if kw.get("do_sample") else _margin_guard(b)
    return _Side(make, jax_chaos, jax_metrics)


def _port_side(pm):
    def make(**kw):
        return ContinuousBatcher(pm, s_max=S_MAX, compile=False, **kw)
    return _Side(make, port_chaos, port_metrics)


def _error_name(fn):
    """The type name of what ``fn()`` raises (the packages' classes differ,
    their names must not)."""
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__


def _drain(b, steps=20):
    done = []
    for _ in range(steps):
        done += b.step()
        if not b._has_work():
            break
    return done


# -- scenarios: each returns what it saw; both packages must see the same ---

def batched(side):
    b = side.make(max_batch=4)
    prompts = _prompts(0, (5, 9, 12, 7))
    rids = [b.submit(p, n) for p, n in zip(prompts, (6, 4, 8, 5))]
    outs = b.run_until_done()
    return [outs[r].tolist() for r in rids]


def staggered_slot_reuse(side):
    b = side.make(max_batch=2)
    prompts = _prompts(1, (4, 6, 8, 5, 7, 9))
    ns = (3, 7, 4, 6, 5, 4)
    rids = [b.submit(p, n) for p, n in zip(prompts[:3], ns[:3])]
    early = []
    for _ in range(3):
        early += b.step()
    # new work arrives while the batch is mid-flight
    rids += [b.submit(p, n) for p, n in zip(prompts[3:], ns[3:])]
    outs = b.run_until_done()
    for rid in early:
        outs[rid] = b.pop_result(rid)
    assert b.active == 0
    return [outs[r].tolist() for r in rids]


def eos_early_stop(side):
    (prompt,) = _prompts(3, (6,))
    b = side.make(max_batch=2)
    rid = b.submit(prompt, 10)
    full = b.run_until_done()[rid]
    eos = int(full[6 + 2])        # the 3rd generated token
    b = side.make(max_batch=2, eos_id=eos)
    rid = b.submit(prompt, 10)
    got = b.run_until_done()[rid]
    assert int(got[-1]) == eos and len(got) <= len(full)
    return [full.tolist(), got.tolist()]


def admission_finish_and_pop(side):
    p1, p2 = _prompts(4, (5, 4))
    b = side.make(max_batch=2)
    rid1 = b.submit(p1, 1)                 # finishes at admission
    assert rid1 in b.step()
    assert b.step() == []                  # nothing historical re-reported
    out1 = b.pop_result(rid1)
    assert len(out1) == 6
    missing = _error_name(lambda: b.result(rid1))
    rid2 = b.submit(p2, 3)
    outs = b.run_until_done()
    assert set(outs) == {rid2}
    return [out1.tolist(), missing, outs[rid2].tolist()]


def sampling(side):
    prompts = _prompts(6, (6, 6))
    seen = {}
    for seed, kw in ((7, {}), (8, {}), (7, dict(top_k=20)),
                     (7, dict(top_p=0.9, temperature=0.8)),
                     (9, dict(top_k=30, top_p=0.7, temperature=1.3))):
        b = side.make(max_batch=2, do_sample=True, seed=seed, **kw)
        rids = [b.submit(p, 6) for p in prompts]
        outs = b.run_until_done()
        seen[f"{seed} {sorted(kw.items())}"] = [outs[r].tolist()
                                                 for r in rids]
    g = side.make(max_batch=2)
    rids = [g.submit(p, 6) for p in prompts]
    outs = g.run_until_done()
    greedy = [outs[r].tolist() for r in rids]
    plain = [v for k, v in seen.items() if k.endswith("[]")]
    assert plain[0] != plain[1] and greedy not in plain
    return seen


def deadline_in_queue(side):
    b = side.make(max_batch=2)
    rid_dead = b.submit(np.arange(4), 8, deadline_s=0.0)
    rid_live = b.submit(np.arange(4), 3)
    time.sleep(0.001)
    done = _drain(b)
    assert done == [rid_live]
    st = b.stats()
    return [_error_name(lambda: b.result(rid_dead)),
            _error_name(lambda: b.pop_result(rid_dead)),
            b.pop_result(rid_live).tolist(), st["deadline_expired"],
            st["completed_requests"]]


def deadline_in_slot(side):
    b = side.make(max_batch=1, default_deadline_s=1000.0)
    rid_a = b.submit(np.arange(4), 20, deadline_s=0.05)
    rid_b = b.submit(np.arange(4), 2)
    b.step()                               # admits A; B waits
    assert b.active == 1
    time.sleep(0.06)                       # A's deadline lapses mid-decode
    done = _drain(b)
    assert done == [rid_b]                 # B got A's slot
    return [_error_name(lambda: b.result(rid_a)),
            b.pop_result(rid_b).tolist(), b.stats()["deadline_expired"]]


def shedding(side):
    b = side.make(max_batch=2, max_queue_depth=2)
    prompt = np.arange(4)
    b.submit(prompt, 4)
    b.submit(prompt, 4)
    shed = _error_name(lambda: b.submit(prompt, 4))
    st = b.stats()
    state = b.health.state
    outs = b.run_until_done()
    # an expired queue entry frees its spot: that submit is admitted, not
    # shed (shed and deadline_expired stay disjoint)
    b2 = side.make(max_batch=2, max_queue_depth=2)
    rid_dead = b2.submit(prompt, 4, deadline_s=0.0)
    live = [b2.submit(prompt, 4)]
    time.sleep(0.001)
    live.append(b2.submit(prompt, 4))
    outs2 = b2.run_until_done()
    assert sorted(outs2) == live
    st2 = b2.stats()
    return [shed, st["requests_shed"], state, sorted(v.tolist()
                                                     for v in outs.values()),
            b.stats()["completed_requests"],
            _error_name(lambda: b2.result(rid_dead)),
            [outs2[r].tolist() for r in live],
            [st2[k] for k in ("deadline_expired", "requests_shed",
                              "completed_requests")]]


def abort(side):
    b = side.make(max_batch=2)
    prompts = _prompts(10, (5, 7, 6, 8))
    rids = [b.submit(p, 5) for p in prompts]
    b.step()                               # admits the first two
    withdrawn = [b.abort(rids[0]), b.abort(rids[3]), b.abort(999)]
    assert b.request(rids[0]) is None and b.request(rids[2]) is not None
    outs = b.run_until_done()
    assert sorted(outs) == [rids[1], rids[2]]
    return [withdrawn, b.abort(rids[1]),
            [outs[r].tolist() for r in rids[1:3]]]


def chaos_drives_health(side):
    b = side.make(max_batch=2)
    b.submit(np.arange(4), 6)
    side.chaos.arm_scenario("seed=0; serving.step:transient_error:count=3")
    try:
        errors = [_error_name(b.step) for _ in range(3)]
    finally:
        side.chaos.disarm()
    state = b.health.state
    assert not b.health.ready()
    outs = b.run_until_done()
    assert b.health.ready()
    return [errors, state, [v.tolist() for v in outs.values()]]


def bucket_pad_waste(side):
    fam = side.registry.counter("serving.bucket_pad_waste",
                                labelnames=("rung",))

    def counts():
        return {c.labels["rung"]: c.value for c in fam.children()}

    before = counts()
    b = side.make(max_batch=2)
    for p in _prompts(11, (5, 8, 9, 16, 3)):
        b.submit(p, 2)
    b.run_until_done()
    after = counts()
    return {r: v - before.get(r, 0) for r, v in after.items()
            if v != before.get(r, 0)}


SCENARIOS = [batched, staggered_slot_reuse, eos_early_stop,
             admission_finish_and_pop, sampling, deadline_in_queue,
             deadline_in_slot, shedding, abort, chaos_drives_health,
             bucket_pad_waste]


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
    return _Results(_jax_side(models[0]))


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_the_jax_batcher(models, jax_results, scenario):
    got = scenario(_port_side(models[1]))
    assert got == jax_results[scenario.__name__]


def test_bucket_pad_waste_counts_pad_tokens(jax_results):
    # prompts 5, 8, 9, 16, 3 on the pow2 ladder: 3 + 0 + 7 + 0 + 1 pads
    assert jax_results["bucket_pad_waste"] == {"8": 3, "16": 7, "4": 1}


def test_capacity_validation(models):
    pm = models[1]
    b = ContinuousBatcher(pm, max_batch=1, s_max=16, compile=False)
    with pytest.raises(ValueError, match="capacity"):
        b.submit(np.arange(10), 10)
    with pytest.raises(ValueError, match="max_new_tokens"):
        b.submit(np.arange(4), 0)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        ContinuousBatcher(pm, max_batch=1, s_max=128, compile=False)


def test_run_until_done_budget_raises(models):
    b = ContinuousBatcher(models[1], max_batch=1, s_max=S_MAX, compile=False)
    for p in _prompts(5, (4, 4, 4)):
        b.submit(p, 4)
    with pytest.raises(RuntimeError, match="remain after"):
        b.run_until_done(max_steps=2)


def test_compile_on_a_cpu_model_raises(models):
    with pytest.raises(ValueError, match="compile=False"):
        ContinuousBatcher(models[1], max_batch=2, s_max=S_MAX)
    step = jit.to_static(models[1].decode_step, donate_args=(1,))
    with pytest.raises(ValueError, match="on the card"):
        step(torch.zeros(2, 1, dtype=torch.int64),
             torch.zeros(2, 2, 2, 2, S_MAX, 16),
             torch.zeros(2, 1, dtype=torch.int32))


def test_prefill_n_valid_matches_the_jax_prefill(models):
    jm, pm = models
    (prompt,) = _prompts(12, (11,))
    ids = np.zeros((1, 16), np.int64)
    ids[0, :11] = prompt
    n_valid = np.full((1, 1), 11, np.int32)
    with paddle.no_grad():
        jl, _, jt = jm.prefill(paddle.to_tensor(ids), S_MAX,
                               paddle.to_tensor(n_valid))
    pl, pc, pt = pm.prefill(torch.from_numpy(ids), S_MAX,
                            torch.from_numpy(n_valid))
    np.testing.assert_allclose(pl.numpy(), jl.numpy(), atol=ATOL, rtol=0)
    assert pt.dtype == torch.int32
    np.testing.assert_array_equal(pt.numpy(), jt.numpy())
    # the padded prompt's logits and its first 11 cache rows are the
    # exact-length prefill's
    el, ec, _ = pm.prefill(torch.from_numpy(ids[:, :11]), S_MAX)
    np.testing.assert_allclose(pl.numpy(), el.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(pc[..., :11, :].numpy(),
                               ec[..., :11, :].numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("kw", [
    dict(do_sample=False, temperature=1.0, top_k=0, top_p=None),
    dict(do_sample=True, temperature=1.0, top_k=0, top_p=None),
    dict(do_sample=True, temperature=0.7, top_k=5, top_p=None),
    dict(do_sample=True, temperature=1.2, top_k=0, top_p=0.8),
    dict(do_sample=True, temperature=1.0, top_k=40, top_p=0.5),
], ids=["greedy", "sample", "top_k", "top_p", "top_k_top_p"])
def test_select_token_matches_the_jax_package(kw):
    logits = np.random.RandomState(13).randn(5, 128).astype(np.float32) * 3
    ref = JaxGPT2._select_token(logits, rng=np.random.RandomState(3), **kw)
    got = select_token(logits, rng=np.random.RandomState(3), **kw)
    np.testing.assert_array_equal(got, ref)


def test_stats_keys_and_serving_series(models):
    jb = jax_serving.ContinuousBatcher(models[0], max_batch=2, s_max=S_MAX,
                                       compile=False)
    reg = port_metrics.get_registry()
    names = ("serving_requests_total", "serving_admissions_total",
             "serving_completions_total", "serving_preemptions_total",
             "serving_tokens_total", "serving_steps_total",
             "serving_decode_blocks_total", "serving_queue_depth",
             "serving_active_slots", "serving_ttft_seconds",
             "serving_step_seconds", "serving_per_token_seconds",
             "requests_shed_total", "serving_deadline_expired_total",
             "serving_health_state")

    def dense(name):
        return reg.get(name).labels(engine="dense")

    b = ContinuousBatcher(models[1], max_batch=2, s_max=S_MAX, compile=False)
    before = dense("serving_requests_total").value
    rids = [b.submit(p, 4) for p in _prompts(3, (5, 5, 5))]
    outs = b.run_until_done()
    assert set(outs) == set(rids)
    for name in names:
        assert reg.get(name) is not None, name
        assert jax_metrics.get_registry().get(name) is not None, name
    assert set(b.stats()) == set(jb.stats())
    assert dense("serving_requests_total").value == before + 3
    # all drained: the depth gauge is back at zero, its peak saw the queue
    assert dense("serving_queue_depth").value == 0
    assert dense("serving_queue_depth").peak >= 1
    ttft = dense("serving_ttft_seconds")
    assert ttft.count >= 3 and sum(ttft.bucket_counts()) == ttft.count
    s = b.stats()
    assert s["completed_requests"] == 3 and s["generated_tokens"] == 12
    assert s["pending_now"] == 0 and s["active_now"] == 0
    b.reset_stats()
    assert b.stats()["completed_requests"] == 0
    # a per-instance reset leaves the process-wide series alone
    assert dense("serving_requests_total").value == before + 3


def test_traced_requests_reach_an_armed_spool(models, tmp_path, monkeypatch):
    """With PADDLE_TELEMETRY_DIR set, a traced request's admit, prefill and
    decode spans and the step's metrics snapshot land in the rank's
    spool."""
    monkeypatch.setenv("PADDLE_TELEMETRY_DIR", str(tmp_path))
    port_fleet.reset_spool()
    try:
        b = ContinuousBatcher(models[1], max_batch=2, s_max=S_MAX,
                              compile=False)
        trace = new_trace("request")
        rid = b.submit(np.arange(5), 3, trace=trace)
        assert len(b.run_until_done()[rid]) == 8
        spans = {s.name for s in get_recorder().spans(trace.trace_id)}
        assert spans == {"admit", "prefill", "decode"}
        port_fleet.get_spool().close()
    finally:
        port_fleet.reset_spool()
    lines = (tmp_path / "rank00000.jsonl").read_text().splitlines()
    kinds = [json.loads(ln)["kind"] for ln in lines]
    assert kinds[0] == "meta" and "metrics" in kinds
    assert kinds.count("span") == 3


def test_a_registered_roofline_gets_the_serving_rate(models, tmp_path,
                                                     monkeypatch):
    """observe_serving_step joins each decode dispatch against a roofline
    model registered through PADDLE_ROOFLINE, and does nothing without
    one."""
    reg = port_metrics.get_registry()
    b = ContinuousBatcher(models[1], max_batch=2, s_max=S_MAX, compile=False)
    b.submit(np.arange(5), 3)
    b.run_until_done()
    assert reg.get("roofline.serving.bound_frac") is None
    path = tmp_path / "roofline.json"
    path.write_text(json.dumps({"configs": [
        {"config": "tiny", "tokens_per_s_bound": 1e6}]}))
    monkeypatch.setenv("PADDLE_ROOFLINE", str(path))
    b.submit(np.arange(5), 3)
    b.run_until_done()
    rate = reg.get("roofline.serving.tokens_per_s").value
    assert rate > 0
    assert reg.get("roofline.serving.bound_frac").value == \
        pytest.approx(rate / 1e6)
