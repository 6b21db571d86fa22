"""The port's GPT-2 serving path against the JAX package's, on the CPU.

The JAX tests' tiny GPT-2 (vocab 128, hidden 64, 2 layers, 4 heads,
``max_position_embeddings=64``, dropout 0, float32) with the same weights in
both packages (moved across by ``gpt2_state_from_paddle_tpu``; the biases
and LayerNorm weights drawn, so the fused ``c_attn`` layout ``(3, H, D)``
and its bias are seen; ``initializer_range`` 0.2, as the Llama parity files
use, so that greedy picks are not near-ties). Inputs are numpy arrays from a
seed.

- ``masked_multihead_attention`` and ``block_multihead_attention`` against
  the JAX functions: output within 1e-5 of its largest magnitude, the
  caches and pools bit-equal after the call.
- ``prefill(n_valid=)``, ``decode_step``, ``paged_prefill_into`` (whole,
  and chunked with pad rows past position 63, which both packages clamp to
  the table's last row), ``paged_decode_step`` and ``paged_fused_step``:
  logits within 1e-4 of the largest, caches and pools within 1e-6.
- Token for token: ``generate`` (greedy, with EOS, sampled at three
  settings), ``generate_beam``, and both batchers in scenarios on the
  prompts of tests/test_continuous_batching.py, tests/test_paged_batching.py
  and tests/test_prefix_cache.py, each with a clean page audit. Llama
  tiny's ``generate_beam`` and sampled ``generate`` (the same drivers) are
  held to the JAX package's in tests/test_torch_llama_generate.py, at the
  shapes its JAX Llama has already compiled.

The JAX package runs op by op here and compiles each op at each new
shape (~50 ms an op, ~3 s a model call), which is most of this file's
time. So one JAX model serves every test, each JAX scenario is computed
once (module fixture, on first use), and the tests share a few shapes:
the dense path a prefill of one 16-token row (the batcher pads its prompts
to 16, beam search prefills one row) and decode at batch 2 and s_max 32
(the batcher's two slots, ``generate``'s two rows, two beams); the paged
path 2 slots of 8 blocks of 4 rows in a pool of 16 (or 7) pages, 8-token
chunks for every admission, and the fused step at 2 + 8 rows. The
attention functions run at the model's head count and width. Every greedy
pick the JAX side makes must clear a top-1/top-2 margin of 1e-3, so a
near-tie shows up as a fixture problem rather than as a port fault.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn.functional import decode_attention as jax_da
from paddle_tpu.inference import serving as jax_serving
from paddle_tpu.models import GPT2Config as JaxGPT2Config
from paddle_tpu.models import GPT2ForCausalLM as JaxGPT2
from paddle_tpu_torch.incubate.nn.functional import (
    block_multihead_attention, masked_multihead_attention)
from paddle_tpu_torch.inference import (ContinuousBatcher,
                                        PagedContinuousBatcher)
from paddle_tpu_torch.models import (GPT2Config, GPT2ForCausalLM,
                                     gpt2_state_from_paddle_tpu)
from paddle_tpu_torch.models.generation import paged_state
from test_torch_refcache import jax_refs, normalize, register  # noqa: F401

ATT_RTOL = 1e-5
LOGIT_REL = 1e-4
POOL_REL = 1e-6
MARGIN = 1e-3
TINY = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=64, dropout=0.0,
            initializer_range=0.2)
DENSE = dict(max_batch=2, s_max=32, prompt_buckets="fixed:16")
GEOM = dict(max_batch=2, s_max=32, block_size=4, n_pages=15,
            prefill_chunk=8)
SMALL = dict(GEOM, n_pages=6, policy="ondemand")


def _prompts(seed, lengths, vocab=128):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (s,)) for s in lengths]


def _gpt2_state(jm):
    """The JAX model's float32 state with drawn biases and LayerNorms."""
    rng = np.random.RandomState(0)
    out = {}
    for k, v in jm.state_dict().items():
        a = np.asarray(v.numpy(), np.float32)
        if k.endswith(".bias"):
            a = (0.2 * rng.randn(*a.shape)).astype(np.float32)
        elif ".ln_" in k:
            a = (1.0 + 0.3 * rng.randn(*a.shape)).astype(np.float32)
        out[k] = a
    return out


def _build_models():
    """(jax_model, port_model): the tiny GPT-2 with the same weights."""
    paddle.seed(0)
    jm = JaxGPT2(JaxGPT2Config(**TINY))
    jm.eval()
    state = _gpt2_state(jm)
    jm.set_state_dict(state)
    pm = GPT2ForCausalLM(GPT2Config(**TINY), device="cpu").eval()
    pm.load_state_dict(gpt2_state_from_paddle_tpu(state))
    return jm, pm




@pytest.fixture(scope="module")
def models():
    return _build_models()


def _np(t):
    return np.asarray(t.numpy())


def _within(got, ref, rel):
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * float(np.abs(ref).max()))


def _margins_ok(logits_np):
    top2 = np.sort(logits_np.reshape(-1, logits_np.shape[-1]), -1)[:, -2:]
    assert np.all(top2[:, 1] - top2[:, 0] > MARGIN), "fixture near-tie"


# -- the two attention functions --------------------------------------------

H, D = 4, 16                 # the tiny model's heads and head width


@pytest.mark.parametrize("bias", [False, True], ids=["plain", "bias"])
def test_masked_multihead_attention_matches_the_jax_function(bias):
    rng = np.random.RandomState(1)
    b, s_max = 2, 32
    x = rng.randn(b, 3 * H * D).astype(np.float32)
    cache = rng.randn(2, b, H, s_max, D).astype(np.float32)
    t = np.array([[7], [31]], np.int32)
    bb = rng.randn(3, H, D).astype(np.float32) if bias else None
    jo, jc = masked_multihead_attention_jax(x, cache, t, bb)
    pc = torch.from_numpy(cache.copy())
    po, pc_out = masked_multihead_attention(
        torch.from_numpy(x), pc, sequence_lengths=torch.from_numpy(t),
        bias=None if bb is None else torch.from_numpy(bb))
    assert pc_out is pc                             # written in place
    assert po.shape == jo.shape == (b, H * D)
    assert np.abs(po.numpy() - jo).max() / np.abs(jo).max() <= ATT_RTOL
    np.testing.assert_array_equal(pc.numpy(), jc)


def masked_multihead_attention_jax(x, cache, t, bias):
    out, c = jax_da.masked_multihead_attention(
        paddle.to_tensor(x), paddle.to_tensor(cache),
        bias=None if bias is None else paddle.to_tensor(bias),
        sequence_lengths=paddle.to_tensor(t))
    return _np(out), _np(c)


def _paged_inputs(mode, seed=0, lens=None):
    """Packed fused qkv for one call over pools of 16 pages of 4 rows
    (random contents) with a shuffled block table of 8 blocks a sequence:
    one sequence of 8 tokens (``lens``: uneven ones), or in decode 2
    sequences of one."""
    rng = np.random.RandomState(seed)
    if lens is None:
        lens = [1, 1] if mode == "decode" else [8]
    b = len(lens)
    n_pages = 15
    pools = [rng.randn(n_pages + 1, H, 4, D).astype(np.float32)
             for _ in range(2)]
    bt = rng.permutation(n_pages + 1)[:b * 8].reshape(b, 8).astype(np.int32)
    this = np.asarray(lens, np.int32)
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    if mode == "prefill":
        enc, dec = this.copy(), np.zeros(b, np.int32)
    else:
        enc = np.zeros(b, np.int32)
        dec = rng.randint(0, 33 - max(lens), b).astype(np.int32)
    qkv = rng.randn(int(cu[-1]), 3 * H * D).astype(np.float32)
    return dict(qkv=qkv, kc=pools[0], vc=pools[1], enc=enc, dec=dec,
                this=this, cu=cu, bt=bt)


@pytest.mark.parametrize("mode, lens, bias", [
    ("prefill", None, False), ("chunk", None, False),
    ("decode", None, False), ("chunk", [3, 5], False),
    ("decode", None, True)],
    ids=["prefill", "chunk", "decode", "uneven", "qkv_bias"])
def test_block_multihead_attention_matches_the_jax_function(mode, lens,
                                                            bias):
    x = _paged_inputs(mode, lens=lens)
    bias_np = (np.random.RandomState(9).randn(3 * H * D).astype(np.float32)
               if bias else None)
    j = jax_da.block_multihead_attention(
        paddle.to_tensor(x["qkv"]), paddle.to_tensor(x["kc"]),
        paddle.to_tensor(x["vc"]), x["enc"], x["dec"], x["this"], None,
        None, x["cu"], x["cu"], x["bt"], block_size=4,
        qkv_bias=None if bias_np is None else paddle.to_tensor(bias_np))
    t = torch.from_numpy
    kc, vc = t(x["kc"].copy()), t(x["vc"].copy())
    po, pqkv, pk, pv = block_multihead_attention(
        t(x["qkv"]), kc, vc, t(x["enc"]), t(x["dec"]), t(x["this"]), None,
        None, t(x["cu"]), t(x["cu"]), t(x["bt"]), block_size=4,
        qkv_bias=None if bias_np is None else t(bias_np))
    assert pk is kc and pv is vc                    # written in place
    jo = _np(j[0])
    assert po.shape == jo.shape
    assert np.abs(po.numpy() - jo).max() / np.abs(jo).max() <= ATT_RTOL
    np.testing.assert_array_equal(pqkv.numpy(), _np(j[1]))
    np.testing.assert_array_equal(pk.numpy(), _np(j[2]))
    np.testing.assert_array_equal(pv.numpy(), _np(j[3]))


def test_arguments_that_wait_raise():
    x = _paged_inputs("decode")
    t = torch.from_numpy
    args = (t(x["qkv"]), t(x["kc"]), t(x["vc"]), t(x["enc"]), t(x["dec"]),
            t(x["this"]), None, None, t(x["cu"]), t(x["cu"]), t(x["bt"]))
    for kw in (dict(rope_emb=torch.zeros(2)), dict(mask=torch.zeros(2)),
               dict(tgt_mask=torch.zeros(2))):
        with pytest.raises(NotImplementedError, match="queue 3, item 3"):
            block_multihead_attention(*args, **kw)
    # dynamic int8 on float pools breaks the scale contract (int8 pages
    # are held to the JAX function in tests/test_torch_quant_serving.py)
    with pytest.raises(ValueError, match="non-int8"):
        block_multihead_attention(*args, use_dynamic_cachekv_quant=True)
    cache = torch.zeros(2, 2, H, 8, D)
    qkv = torch.zeros(2, 3 * H * D)
    for kw in (dict(src_mask=torch.zeros(2, 1, 1, 8)),
               dict(rotary_tensor=torch.zeros(2, 1, 1, 8, D),
                    rotary_emb_dims=1)):
        with pytest.raises(NotImplementedError, match="queue 3, item 3"):
            masked_multihead_attention(qkv, cache, **kw)


# -- the model's dense and paged methods -------------------------------------

def test_prefill_n_valid_and_decode_steps_match(models):
    """Two prompts right-padded to 16 (true lengths 5 and 16), prefilled a
    row at a time as the batcher does; then both rows' caches side by side
    take 3 decode steps, each feeding the JAX package's argmax."""
    jm, pm = models
    ids = _prompts(2, (16, 16))
    n_valid = (5, 16)
    ref, got = [], []
    with paddle.no_grad():
        for row, n in zip(ids, n_valid):
            out = jm.prefill(paddle.to_tensor(row[None]), 32,
                             paddle.to_tensor(np.array([[n]], np.int32)))
            ref.append([_np(x) for x in out])
    for row, n in zip(ids, n_valid):
        got.append(pm.prefill(torch.from_numpy(row[None]), 32,
                              torch.tensor([[n]], dtype=torch.int32)))
    for (gl, gc, gt), (rl, rc, rt) in zip(got, ref):
        assert gl.shape == rl.shape == (1, 1, 128)
        assert gc.shape == rc.shape == (2, 2, 1, H, 32, D)
        _margins_ok(rl)
        _within(gl.numpy(), rl, LOGIT_REL)
        _within(gc.numpy(), rc, POOL_REL)
        np.testing.assert_array_equal(gt.numpy(), rt)
    rc = np.concatenate([r[1] for r in ref], axis=2)
    rt = np.concatenate([r[2] for r in ref])
    pc = torch.cat([g[1] for g in got], dim=2)
    pt = torch.cat([g[2] for g in got])
    tok = np.concatenate([r[0][:, -1].argmax(-1) for r in ref])[:, None]
    jc, jt = paddle.to_tensor(rc), paddle.to_tensor(rt)
    for step in range(3):
        with paddle.no_grad():
            jl, jc, jt = jm.decode_step(paddle.to_tensor(tok), jc, jt)
        rl = _np(jl)
        _margins_ok(rl)
        pl, pc2, pt = pm.decode_step(torch.from_numpy(tok), pc, pt)
        assert pc2 is pc                            # updated in place
        _within(pl.numpy(), rl, LOGIT_REL)
        _within(pc.numpy(), _np(jc), POOL_REL)
        np.testing.assert_array_equal(pt.numpy(), _np(jt))
        tok = rl[:, -1].argmax(-1)[:, None]


def _pools(rng, n_pages=16):
    return [[rng.randn(n_pages, H, 4, D).astype(np.float32)
             for _ in range(2)] for _ in range(2)]


def _paged_prefill_calls(model, to_tensor, numpy):
    """Into random pools of 16 pages: a whole 8-token prompt, then an
    8-token chunk appended at row 60 of a sequence of 8 blocks of 4 rows:
    its rows 4-7 lie past the 64-row position table, whose last row both
    packages take for them, and every row lies past the block table,
    whose last page both write."""
    rng = np.random.RandomState(3)
    pools = [tuple(to_tensor(a) for a in p) for p in _pools(rng)]
    prompt, chunk = _prompts(4, (8, 8))
    seen = []
    bt = rng.permutation(16)[:8][None].astype(np.int32)
    logits, pools = model.paged_prefill_into(to_tensor(prompt[None]), pools,
                                             to_tensor(bt), 4)
    seen.append([numpy(logits), [[numpy(a) for a in p] for p in pools]])
    bt = rng.permutation(16)[:8][None].astype(np.int32)
    logits, pools = model.paged_prefill_into(
        to_tensor(chunk[None]), pools, to_tensor(bt), 4,
        dec_base=to_tensor(np.array([60], np.int32)),
        logits_at=to_tensor(np.array([2], np.int32)))
    seen.append([numpy(logits), [[numpy(a) for a in p] for p in pools]])
    return seen


def test_paged_prefill_into_matches_whole_and_chunked_past_the_table(
        models):
    jm, pm = models
    with paddle.no_grad():
        ref = _paged_prefill_calls(jm, paddle.to_tensor, _np)
    got = _paged_prefill_calls(pm, torch.from_numpy,
                               lambda t: t.numpy().copy())
    for (gl, gp), (rl, rp) in zip(got, ref):
        assert gl.shape == rl.shape == (1, 128)
        _within(gl, rl, LOGIT_REL)
        for gx, rx in zip(gp, rp):
            for a, r in zip(gx, rx):
                _within(a, r, POOL_REL)


def _decode_and_fused_calls(model, to_tensor, numpy, state):
    """Two paged decode steps of 2 sequences at row 6 (identity tables of
    8 blocks), then two fused calls: both decode while an 8-token chunk
    goes into pages 4-7 and 12-15 at row 0, then at row 8 (reading the
    first chunk's rows back). Returns every call's logits, the pools and
    the timelines."""
    rng = np.random.RandomState(32)
    pools = [tuple(to_tensor(a) for a in p) for p in _pools(rng)]
    st = state(pools, to_tensor(np.arange(16, dtype=np.int32).reshape(2, 8)),
               to_tensor(np.array([6, 6], np.int32)))
    seen = []
    for _ in range(2):
        logits, st = model.paged_decode_step(
            to_tensor(rng.randint(0, 128, 2)), st)
        seen.append([numpy(logits), numpy(st["dec_lens"])])
    st = state(st["layers"], st["block_tables"], st["dec_lens"])
    bt = to_tensor(np.array([[4, 5, 6, 7, 12, 13, 14, 15]], np.int32))
    for i, at in enumerate((5, 2)):
        logits, chunk_logits, st = model.paged_fused_step(
            to_tensor(rng.randint(0, 128, 2)),
            to_tensor(rng.randint(0, 128, 8)), bt,
            to_tensor(np.array([8 * i], np.int32)),
            to_tensor(np.array([at], np.int32)), st)
        seen.append([numpy(logits), numpy(chunk_logits),
                     numpy(st["dec_lens"])])
    seen.append([[numpy(kc), numpy(vc)] for kc, vc in st["layers"]])
    return seen


def test_paged_decode_and_fused_steps_match(models):
    jm, pm = models

    def jax_state(pools, bt, dec):
        return JaxGPT2._paged_state(list(pools), bt, 2, 6, 4, 8) | {
            "dec_lens": dec}

    def port_state(pools, bt, dec):
        return dict(paged_state(list(pools), bt, 2, 6, 4, 8), dec_lens=dec)

    with paddle.no_grad():
        ref = _decode_and_fused_calls(jm, paddle.to_tensor, _np, jax_state)
    got = _decode_and_fused_calls(pm, torch.from_numpy,
                                  lambda t: t.numpy().copy(), port_state)
    for call, (g, r) in enumerate(zip(got[:-1], ref[:-1])):
        for a, b in zip(g[:-1], r[:-1]):           # decode / chunk logits
            assert a.shape == b.shape, call
            _within(a, b, LOGIT_REL)
        np.testing.assert_array_equal(g[-1], r[-1])
    for gp, rp in zip(got[-1], ref[-1]):
        for a, b in zip(gp, rp):
            _within(a, b, POOL_REL)


def test_paged_methods_that_wait_raise(models):
    """Int8 pools are allocated, and dynamic scales on float pools break the
    scale contract (int8 pages are held to the JAX package in
    tests/test_torch_quant_serving.py); speculative verify (``logits_all``,
    queue 1, item 1.5, ported) gives each position's ``logits_at`` logits
    (held to the JAX package in tests/test_torch_speculative.py)."""
    pm = models[1]
    assert pm.paged_alloc(4, 4, cache_dtype="int8")[0][0].dtype == \
        torch.int8
    pools = pm.paged_alloc(4, 4)
    ids = torch.zeros(1, 4, dtype=torch.int64)
    bt = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="non-int8"):
        pm.paged_prefill_into(ids, pools, bt, 4, dynamic_cache_scales=True)
    ids = torch.arange(1, 5, dtype=torch.int64).view(1, 4)
    got, _ = pm.paged_prefill_into(ids, pm.paged_alloc(4, 4), bt, 4,
                                   logits_all=True)
    assert got.shape == (1, 4, 128)
    for i in range(4):
        at, _ = pm.paged_prefill_into(ids, pm.paged_alloc(4, 4), bt, 4,
                                      logits_at=torch.tensor([i]))
        torch.testing.assert_close(got[:, i], at, rtol=0, atol=1e-5)


# -- generate and generate_beam, token for token ----------------------------

@pytest.fixture
def guarded(models, monkeypatch):
    """The JAX model with its prefill and decode step wrapped: every greedy
    pick must clear the margin."""
    jm = models[0]
    for name in ("prefill", "decode_step"):
        fn = getattr(jm, name)

        def wrapped(*a, _fn=fn):
            out = _fn(*a)
            _margins_ok(_np(out[0])[:, -1])
            return out
        monkeypatch.setattr(jm, name, wrapped)
    return jm


def _generate_ids():
    return np.stack(_prompts(6, (8, 8)))


def test_generate_greedy_and_eos_tokens_equal(models, guarded):
    pm = models[1]
    ids = _generate_ids()
    with paddle.no_grad():
        ref = _np(guarded.generate(paddle.to_tensor(ids), 8, s_max=32))
        eos = int(ref[0, 8 + 2])
        ref_eos = _np(guarded.generate(paddle.to_tensor(ids), 8, s_max=32,
                                       eos_id=eos, pad_id=0))
    got = pm.generate(torch.from_numpy(ids), 8, s_max=32)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
    got = pm.generate(torch.from_numpy(ids), 8, s_max=32, eos_id=eos,
                      pad_id=0)
    np.testing.assert_array_equal(got.numpy(), ref_eos)
    assert (ref_eos[0, 11:] == 0).all()


SAMPLING = [dict(temperature=0.7, seed=1),
            dict(temperature=1.0, top_k=20, seed=2),
            dict(temperature=1.3, top_p=0.9, seed=3)]


@pytest.mark.parametrize("kw", SAMPLING, ids=["temperature", "top_k",
                                              "top_p"])
def test_generate_sampled_tokens_equal(models, kw):
    jm, pm = models
    ids = _generate_ids()
    with paddle.no_grad():
        ref = _np(jm.generate(paddle.to_tensor(ids), 8, s_max=32,
                              do_sample=True, **kw))
    got = pm.generate(torch.from_numpy(ids), 8, s_max=32, do_sample=True,
                      **kw)
    np.testing.assert_array_equal(got.numpy(), ref)


def _beam_ids():
    return np.stack(_prompts(7, (16,)))


def test_generate_beam_tokens_equal(models):
    """One row, two beams: the prefill at the dense batcher's shape, the
    steps at its batch."""
    jm, pm = models
    ids = _beam_ids()
    with paddle.no_grad():
        ref = _np(jm.generate_beam(paddle.to_tensor(ids), 6, num_beams=2,
                                   s_max=32))
    got = pm.generate_beam(torch.from_numpy(ids), 6, num_beams=2, s_max=32)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
    with pytest.raises(ValueError, match="num_beams"):
        pm.generate_beam(torch.from_numpy(ids), 2, num_beams=200)


def test_serving_in_eval_draws_nothing_and_ignores_dropout(models):
    """With dropout 0.1 in the config, an eval model serves the same tokens
    as the dropout-0 one and leaves both of its generators where they
    were."""
    pm = models[1]
    m = GPT2ForCausalLM(GPT2Config(**dict(TINY, dropout=0.1)), device="cpu")
    m.load_state_dict(pm.state_dict())
    m.eval()
    seeds = m.attention_seeds.get_state()
    drops = m.dropout_generator.get_state()
    ids = torch.from_numpy(_generate_ids())
    np.testing.assert_array_equal(m.generate(ids, 6).numpy(),
                                  pm.generate(ids, 6).numpy())
    np.testing.assert_array_equal(
        m.generate_beam(ids, 4, num_beams=2).numpy(),
        pm.generate_beam(ids, 4, num_beams=2).numpy())
    np.testing.assert_array_equal(
        m.generate_paged(ids, 6, block_size=4).numpy(),
        pm.generate_paged(ids, 6, block_size=4).numpy())
    assert torch.equal(m.attention_seeds.get_state(), seeds)
    assert torch.equal(m.dropout_generator.get_state(), drops)


# -- both batchers, scenario by scenario ------------------------------------

def _margin_guard(b):
    """Wrap a JAX batcher's host pick: every greedy pick of a live row (or
    of an admission's chunk logits) must clear the top-1/top-2 margin."""
    pick = b._pick

    def guarded_pick(logits_np):
        rows = (list(b._slot_req) if logits_np.shape[0] == b.max_batch
                and b._slot_req else [0])
        _margins_ok(logits_np[rows])
        return pick(logits_np)

    b._pick = guarded_pick
    return b


def _side(models, jax):
    model = models[0] if jax else models[1]
    dense, paged = ((jax_serving.ContinuousBatcher,
                     jax_serving.PagedContinuousBatcher) if jax else
                    (ContinuousBatcher, PagedContinuousBatcher))

    def make(cls, **kw):
        b = cls(model, compile=False, **kw)
        return _margin_guard(b) if jax else b
    return {"dense": lambda **kw: make(dense, **kw),
            "paged": lambda **kw: make(paged, **kw)}


def _serve(b, prompts, news, max_steps=400):
    rids = [b.submit(p, n) for p, n in zip(prompts, news)]
    outs = b.run_until_done(max_steps=max_steps)
    return [outs[r].tolist() for r in rids]


def _pool_state(b):
    """The audit (raises on a leak), then where every page is."""
    assert b.audit_pages() == 0
    cached = (b.prefix_cache.cached_pages if b.prefix_cache is not None
              else 0)
    assert b.free_page_count + cached == b.n_pages
    assert (b._bt == b._scratch).all()
    return [b.free_page_count, cached]


def _stats(b):
    st = b.stats()
    return [st[k] for k in ("steps", "generated_tokens", "preemptions",
                            "completed_requests", "decode_blocks")
            if k in st]


def dense_staggered(side):
    """More requests than slots, arriving mid-run, every prompt padded to
    16 (test_continuous_batching.py::test_staggered_arrival_and_slot_
    reuse)."""
    b = side["dense"](**DENSE)
    prompts = _prompts(1, (4, 6, 8, 5, 7, 9))
    ns = (3, 7, 4, 6, 5, 4)
    rids = [b.submit(p, n) for p, n in zip(prompts[:3], ns[:3])]
    early = []
    for _ in range(3):
        early += b.step()
    rids += [b.submit(p, n) for p, n in zip(prompts[3:], ns[3:])]
    outs = b.run_until_done()
    for rid in early:
        outs[rid] = b.pop_result(rid)
    assert b.active == 0
    return [[outs[r].tolist() for r in rids], _stats(b)]


def paged_reserve(side):
    """Slot and page reuse, pages reserved up front (test_paged_batching.
    py::test_paged_slot_and_page_reuse)."""
    b = side["paged"](**GEOM)
    prompts = _prompts(1, (4, 6, 8, 5, 7, 9))
    ns = (3, 7, 4, 6, 5, 4)
    rids = [b.submit(p, n) for p, n in zip(prompts[:3], ns[:3])]
    early = []
    for _ in range(3):
        early += b.step()
    rids += [b.submit(p, n) for p, n in zip(prompts[3:], ns[3:])]
    outs = b.run_until_done()
    for rid in early:
        outs[rid] = b.pop_result(rid)
    return [[outs[r].tolist() for r in rids], _pool_state(b), _stats(b)]


def ondemand_preemption(side):
    """Two requests whose full timelines need 8 pages, in 6: the later one
    is preempted and resumes exactly (test_paged_batching.py::
    test_ondemand_preemption_is_exact)."""
    b = side["paged"](**SMALL)
    toks = _serve(b, _prompts(3, (6, 6)), (10, 10))
    assert b.stats()["preemptions"] >= 1
    return [toks, _pool_state(b), _stats(b)]


def chunked(side):
    """Prompts shorter, equal and longer than the chunk (test_paged_
    batching.py::test_chunked_prefill_token_exact_mixed_lengths)."""
    b = side["paged"](**GEOM)
    toks = _serve(b, _prompts(7, (3, 8, 13, 17)), (6,) * 4)
    return [toks, _pool_state(b), _stats(b)]


def prefix_cache(side):
    """A shared 16-token prefix through the radix cache, on demand
    (test_prefix_cache.py::test_prefix_cache_batcher_token_exact_and_hits,
    its prompts at a 16-token prefix)."""
    rng = np.random.RandomState(3)
    shared = rng.randint(0, 128, (16,))
    prompts = [np.concatenate([shared, rng.randint(0, 128, (5 + i,))])
               for i in range(4)]
    b = side["paged"](**GEOM, policy="ondemand", prefix_cache=True)
    toks = _serve(b, prompts, (8,) * 4)
    cs = b.prefix_cache.stats()
    assert cs["hit_tokens"] > 0
    return [toks, _pool_state(b), _stats(b),
            [cs[k] for k in ("nodes", "cached_pages", "hit_tokens",
                             "miss_tokens", "evictions")]]


def fused_abort(side):
    """Fused admission on demand in 6 pages: a live decode needs a page
    while the two-chunk admission holds the rest, so the admission is
    aborted and restarts (test_paged_batching.py::test_fused_admission_
    abort_under_pool_pressure; the decoder's 7-token prompt, not its 4,
    crosses into its third page while the admission is in flight at this
    slot capacity)."""
    b = side["paged"](**SMALL, fused_admission=True)
    aborts = [0]
    abort = b._abort_admission

    def counted():
        aborts[0] += 1
        abort()
    b._abort_admission = counted
    toks = _serve(b, _prompts(14, (7, 13)), (10, 4))
    assert aborts[0] >= 1 and b.stats()["preemptions"] >= 1
    return [toks, aborts[0], _pool_state(b), _stats(b)]


def decode_block(side):
    """decode_block=4 after fused admissions (test_paged_batching.py::
    test_decode_block_composes_with_fused_admission)."""
    b = side["paged"](**GEOM, fused_admission=True, decode_block=4)
    toks = _serve(b, _prompts(43, (9, 14)), (10, 10))
    assert b.stats()["decode_blocks"] > 0
    return [toks, _pool_state(b), _stats(b)]


SCENARIOS = [dense_staggered, paged_reserve, ondemand_preemption, chunked,
             prefix_cache, fused_abort, decode_block]


class _Results(dict):
    """Each scenario's result on the JAX side, computed on first use."""

    def __init__(self, side):
        super().__init__()
        self.side = side

    def __missing__(self, name):
        fn = next(f for f in SCENARIOS if f.__name__ == name)
        with paddle.no_grad():
            self[name] = result = fn(self.side)
        return result


REFS = register("gpt2_serving.scenarios", TINY,
                [f.__name__ for f in SCENARIOS],
                lambda: _Results(_side(_build_models(), jax=True)),
                lambda results, name: results[name])


@pytest.fixture(scope="module")
def jax_results(jax_refs):
    """Every scenario computed once a run (test_torch_refcache.py)."""
    return jax_refs(REFS)


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_the_jax_batcher(models, jax_results, scenario):
    got = scenario(_side(models, jax=False))
    assert normalize(got) == jax_results[scenario.__name__]
