"""The port's fused admission and K-step decode blocks
(``PagedContinuousBatcher(fused_admission=True, decode_block=K)`` and Llama's
``paged_fused_step``) against the JAX package's, on the CPU.

Llama tiny (GQA 4/2, two layers, float32) with the same weights in both
packages (moved across by models/convert.py); both batchers run with
compile=False (the port's CUDA graphs need a card). Each scenario mirrors a
test of tests/test_paged_batching.py's fused-admission and decode-block
sections on the Llama family: it drives a batcher through the API the two
packages share, checks the reference test's assertions, and returns what it
saw; the port's must equal the JAX batcher's token for token. Each JAX
result is computed once per process, on first use. The JAX batcher's host
picks must clear a top-1/top-2 margin of 1e-3, so a near-tie shows up as a
fixture problem rather than as a port fault.

The scenarios keep tests/test_torch_paged_batching.py's geometry (2 slots,
block 4, 8 blocks a slot, 15 pages) and 8-token chunks, and the decode
blocks admit through the fused call too: the JAX package runs op by op here
and compiles each new shape once (a second admission path costs it ~5 s),
which is most of this file's time. A block's tokens do not depend on how
its requests were admitted: the port's blocks are also held to its own
per-step engine after plain admissions.

``paged_fused_step`` is held to the JAX function on the same pools, tables
and chunk inputs, and every constructor guard to the JAX package's
``ValueError`` text.
"""
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import serving as jax_serving
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny_config as jax_tiny_config
from paddle_tpu_torch import jit
from paddle_tpu_torch.inference import PagedContinuousBatcher, serving
from paddle_tpu_torch.models import (LlamaForCausalLM,
                                     llama_state_from_paddle_tpu,
                                     llama_tiny_config)
from paddle_tpu_torch.models.generation import paged_state

MARGIN = 1e-3
# tests/test_continuous_batching.py's Llama config
CFG = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
           num_key_value_heads=2, vocab_size=128, max_position_embeddings=64,
           initializer_range=0.2)
GEOM = dict(max_batch=2, s_max=32, block_size=4, n_pages=15)
FUSED = dict(prefill_chunk=8, fused_admission=True)


def _prompts(seed, lengths, vocab=128):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (s,)) for s in lengths]


@pytest.fixture(scope="module")
def models():
    """(jax_model, port_model) with the same weights; the norm weights are
    drawn too, so the norms' scaling is exercised."""
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


def _margin_guard(b):
    """Wrap a JAX batcher's host pick: every pick of a live row (or of an
    admission's chunk logits) must clear the top-1/top-2 margin."""
    pick = b._pick

    def guarded(logits_np):
        rows = (list(b._slot_req) if logits_np.shape[0] == b.max_batch
                and b._slot_req else [0])
        top2 = np.sort(logits_np[rows], axis=-1)[:, -2:]
        assert np.all(top2[:, 1] - top2[:, 0] > MARGIN), "fixture near-tie"
        return pick(logits_np)

    b._pick = guarded
    return b


def _jax_make(models):
    def make(**kw):
        return _margin_guard(jax_serving.PagedContinuousBatcher(
            models[0], compile=False, **kw))
    return make


def _port_make(models):
    def make(**kw):
        return PagedContinuousBatcher(models[1], compile=False, **kw)
    return make


def _counted(b, name):
    """Count the calls of ``b.name`` and collect what they returned."""
    fn, seen = getattr(b, name), []

    def counted(*args):
        seen.append(fn(*args))
        return seen[-1]
    setattr(b, name, counted)
    return seen


def _serve(b, prompts, news):
    rids = [b.submit(p, n) for p, n in zip(prompts, news)]
    outs = b.run_until_done(max_steps=400)
    return [outs[r].tolist() for r in rids]


def _pool_state(b):
    """The audit (raises on a leak), then every page back in the pool."""
    assert b.audit_pages() == 0
    assert b.free_page_count == b.n_pages
    assert (b._bt == b._scratch).all() and b._admitting is None
    return b.free_page_count


def _stats(b):
    st = b.stats()
    return [st[k] for k in ("steps", "generated_tokens", "preemptions",
                            "completed_requests", "decode_blocks")]


# -- scenarios: each returns what it saw; both packages must see the same ---

FUSED_RUN = (_prompts(12, (5, 11, 17, 8, 22)), (6,) * 5)


def fused_run(make):
    """Five prompts shorter than, equal to and longer than the chunk
    stream through one fused call a step beside the decoding slot
    (test_fused_admission_token_exact_both_families)."""
    b = make(**GEOM, **FUSED)
    return [_serve(b, *FUSED_RUN), _pool_state(b), _stats(b)]


def fused_abort(make):
    """A live decode needs a page while a two-chunk admission holds the
    rest of the pool and no other slot can be preempted: the admission is
    aborted (its pages back, the request to the queue's front) and
    restarts later (test_fused_admission_abort_under_pool_pressure). The
    decoder's 8-row prompt crosses into its third page on the step after
    the admission starts."""
    b = make(**dict(GEOM, n_pages=6), policy="ondemand", **FUSED)
    aborts = _counted(b, "_abort_admission")
    toks = _serve(b, _prompts(14, (7, 13)), (10, 4))
    st = b.stats()
    assert len(aborts) >= 1 and st["preemptions"] >= 1
    return [toks, len(aborts), _pool_state(b), _stats(b)]


BLOCK_RUN = (_prompts(40, (8, 12, 8)), (9, 3, 14))


def decode_block_budget_and_eos(make):
    """decode_block=4: a budget under K (3) and one past several blocks;
    then the first request again with its 3rd generated token as EOS,
    which lands inside a block (test_decode_block_token_exact_vs_single_
    step, test_decode_block_eos_mid_block)."""
    b = make(decode_block=4, **GEOM, **FUSED)
    toks = _serve(b, *BLOCK_RUN)
    assert b.stats()["decode_blocks"] > 0
    prompt = BLOCK_RUN[0][0]
    eos = toks[0][len(prompt) + 2]
    e = make(decode_block=4, eos_id=eos, **GEOM, **FUSED)
    got = _serve(e, [prompt], [12])
    assert got[0][-1] == eos and e.stats()["decode_blocks"] > 0
    return [toks, _pool_state(b), _stats(b), eos, got, _pool_state(e),
            _stats(e)]


DECLINE_RUN = (_prompts(42, (8, 8)), (24, 24))


def decode_block_declines(make):
    """Two requests that need 16 pages in all, in 15: once the pool cannot
    back both slots' next 8 rows, the probe declines without preempting and
    the per-step path serves the work, preempting as it must (test_decode_
    block_ondemand_pool_pressure_falls_back)."""
    b = make(**GEOM, policy="ondemand", decode_block=8, **FUSED)
    probes = _counted(b, "_block_backed")
    toks = _serve(b, *DECLINE_RUN)
    assert False in probes and True in probes
    return [toks, probes, _pool_state(b), _stats(b)]


BLOCK_FUSED_RUN = (_prompts(43, (9, 14)), (10, 10))


def decode_block_with_fused_admission(make):
    """Admissions go through the fused call; once nothing waits, the idle
    steps become K-step blocks (test_decode_block_composes_with_fused_
    admission)."""
    b = make(decode_block=4, **GEOM, **FUSED)
    toks = _serve(b, *BLOCK_FUSED_RUN)
    assert b.stats()["decode_blocks"] > 0
    return [toks, _pool_state(b), _stats(b)]


def fused_overlap(make):
    """Decode keeps running while a 3-chunk prompt admits: the run takes
    fewer steps than admitting and decoding one after the other (1 + 11
    steps for the first request, 3 + 3 for the second)
    (test_fused_admission_single_executable_and_overlap)."""
    b = make(**GEOM, **FUSED)
    first, second = _prompts(13, (4, 24))
    r0 = b.submit(first, 12)
    b.step()
    r1 = b.submit(second, 4)
    outs = b.run_until_done()
    steps = b.stats()["steps"]
    assert steps < 1 + 11 + 3 + 3
    return [outs[r0].tolist(), outs[r1].tolist(), steps, _pool_state(b)]


SCENARIOS = [fused_run, fused_abort, decode_block_budget_and_eos,
             decode_block_declines, decode_block_with_fused_admission,
             fused_overlap]


class _Results(dict):
    """Each scenario's result on the JAX side, computed on first use."""

    def __init__(self, make):
        super().__init__()
        self.make = make

    def __missing__(self, name):
        fn = next(f for f in SCENARIOS if f.__name__ == name)
        self[name] = result = fn(self.make)
        return result


@pytest.fixture(scope="module")
def jax_results(models):
    return _Results(_jax_make(models))


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_the_jax_batcher(models, jax_results, scenario):
    got = scenario(_port_make(models))
    assert got == jax_results[scenario.__name__]


@pytest.mark.parametrize("run, extra", [
    (FUSED_RUN, dict(**FUSED)),
    (BLOCK_RUN, dict(decode_block=4)),
    (BLOCK_RUN, dict(decode_block=4, **FUSED)),
    (DECLINE_RUN, dict(policy="ondemand", decode_block=8)),
    (BLOCK_FUSED_RUN, dict(decode_block=4, **FUSED))],
    ids=["fused_run", "block_run", "block_run_fused", "decline_run",
         "block_fused_run"])
def test_same_tokens_as_the_per_step_engine(models, run, extra):
    """Fused admission and blocks change when the work runs, not what it
    computes: the port's tokens equal its plain per-step batcher's (plain
    admissions, no blocks)."""
    make = _port_make(models)
    plain = {k: v for k, v in extra.items()
             if k not in ("fused_admission", "decode_block")}
    assert _serve(make(**dict(GEOM, **extra)), *run) == \
        _serve(make(**dict(GEOM, **plain)), *run)


def test_an_admission_in_flight_can_be_withdrawn_or_expire(models):
    """abort() and an expired deadline release an admission that has
    streamed some of its chunks: its pages and slot come back, its record
    is gone, and the batcher has no work left."""
    from paddle_tpu_torch.resilience.recovery import DeadlineExceeded
    make = _port_make(models)
    (prompt,) = _prompts(15, (24,))
    for withdraw in ("abort", "deadline"):
        b = make(**GEOM, **FUSED)
        rid = b.submit(prompt, 4, deadline_s=0.0 if withdraw == "deadline"
                       else None)
        b._start_admission()            # in flight before the deadline
        b._step_fused()                 # streams its first chunk
        assert b._admitting["offset"] == 8 and b.request(rid) is not None
        if withdraw == "abort":
            assert b.abort(rid)
            assert b.request(rid) is None
        else:
            b.step()                    # expires at the step boundary
            with pytest.raises(DeadlineExceeded, match="during admission"):
                b.result(rid)
        assert not b._has_work() and _pool_state(b) == b.n_pages
        assert sorted(b._free_slots) == [0, 1]


# -- paged_fused_step against the JAX function ------------------------------

def _fused_calls(to_tensor, state, step, numpy):
    """Two fused calls on a pool of GEOM's shape (16 pages of random rows,
    identity tables of 8 blocks for two decoding sequences at row 6): both
    sequences decode a token each while an 8-token admission chunk goes
    into pages 4-7 (rows sequence 0 has not reached), first at row 0 and
    then appended at row 8, reading the first chunk's rows back. ``state``
    builds the package's paged state from (pools, block table, timeline
    lengths). Returns each call's decode and chunk logits, the pools after
    it and the new timeline lengths."""
    rng = np.random.RandomState(32)
    pools = [[to_tensor(rng.randn(16, 2, 4, 16).astype(np.float32))
              for _ in range(2)] for _ in range(2)]
    st = state(pools, to_tensor(np.arange(16, dtype=np.int32).reshape(2, 8)),
               to_tensor(np.array([6, 6], np.int32)))
    bt = to_tensor(np.array([[4, 5, 6, 7, 12, 13, 14, 15]], np.int32))
    seen = []
    for i, at in enumerate((5, 2)):
        logits, chunk_logits, st = step(
            to_tensor(rng.randint(0, 128, 2)),
            to_tensor(rng.randint(0, 128, 8)), bt,
            to_tensor(np.array([8 * i], np.int32)),
            to_tensor(np.array([at], np.int32)), st)
        seen.append([numpy(logits), numpy(chunk_logits),
                     [[numpy(kc), numpy(vc)] for kc, vc in st["layers"]],
                     numpy(st["dec_lens"])])
    return seen


def _within(got, ref, rel):
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * float(np.abs(ref).max()))


def test_paged_fused_step_matches_the_jax_function(models):
    jm, pm = models

    def jax_state(pools, bt, dec):
        return {"layers": [tuple(p) for p in pools], "block_tables": bt,
                "dec_lens": dec, "block_size": 4, "capacity": 32}

    def port_state(pools, bt, dec):
        st = paged_state([tuple(p) for p in pools], bt, 2, 6, 4, 8)
        return dict(st, dec_lens=dec)

    with paddle.no_grad():
        ref = _fused_calls(paddle.to_tensor, jax_state, jm.paged_fused_step,
                           lambda t: np.asarray(t.numpy()))
    got = _fused_calls(torch.from_numpy, port_state, pm.paged_fused_step,
                       lambda t: t.numpy().copy())
    for call, (g, r) in enumerate(zip(got, ref)):
        assert g[0].shape == r[0].shape == (2, 128), call
        assert g[1].shape == r[1].shape == (1, 128), call
        _within(g[0], r[0], 1e-4)               # decode logits
        _within(g[1], r[1], 1e-4)               # chunk logits
        for gp, rp in zip(g[2], r[2]):          # the pools after the call
            for gx, rx in zip(gp, rp):
                _within(gx, rx, 1e-6)
        np.testing.assert_array_equal(g[3], r[3])


def _port_state(pm):
    return paged_state(pm.paged_alloc(16, 4), torch.zeros(2, 8,
                                                          dtype=torch.int32),
                       2, 6, 4, 8)


def test_paged_fused_step_refuses_dynamic_scales(models):
    pm = models[1]
    state = _port_state(pm)
    zeros = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="dynamic cachekv"):
        pm.paged_fused_step(torch.zeros(2, dtype=torch.int64),
                            torch.zeros(8, dtype=torch.int64),
                            torch.zeros(1, 8, dtype=torch.int32), zeros,
                            zeros, dict(state, cache_scales=[{}]))


def test_captured_fused_step_needs_the_card(models):
    pm = models[1]
    state = _port_state(pm)
    step = jit.to_static(pm.paged_fused_step, donate_args=(5,))
    zeros = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="on the card"):
        step(torch.zeros(2, dtype=torch.int64),
             torch.zeros(8, dtype=torch.int64),
             torch.zeros(1, 8, dtype=torch.int32), zeros, zeros, state)


# -- the constructor's guards -----------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(fused_admission=True),
    dict(fused_admission=True, prefill_chunk=0),
    dict(fused_admission=True, prefill_chunk=8, prefix_cache=True),
    dict(fused_admission=True, prefill_chunk=8, cache_quant="dynamic_int8"),
    dict(prefix_cache=True, cache_quant="dynamic_int8"),
    dict(fused_admission=True, prefill_chunk=12, s_max=40, block_size=8),
    dict(fused_admission=True, prefill_chunk=64),
    dict(decode_block=1),
    dict(decode_block=4, do_sample=True)],
    ids=["no_chunk", "chunk_0", "prefix_cache", "cache_quant",
         "prefix_cache_quant", "capacity", "chunk_past_s_max", "block_1",
         "block_sampled"])
def test_guards_raise_the_jax_packages_errors(models, kw):
    args = dict(dict(max_batch=2, s_max=32, block_size=4, compile=False),
                **kw)
    with pytest.raises(ValueError) as ref:
        jax_serving.PagedContinuousBatcher(models[0], **args)
    with pytest.raises(ValueError) as got:
        PagedContinuousBatcher(models[1], **args)
    assert str(got.value) == str(ref.value)


def test_serving_stats_take_the_jax_signatures():
    for name in ("on_step", "on_decode_time", "on_decode_block"):
        assert inspect.signature(getattr(serving._ServingStats, name)) == \
            inspect.signature(getattr(jax_serving._ServingStats, name)), name
