"""The port's int8 serving against the JAX package's, on the CPU.

Int8 KV pages: ``block_gqa_attention`` and ``block_multihead_attention``
with static ``[KV]`` and dynamic ``[B, KV]`` scales (prefill with computed
scales and a masked pad tail, decode consuming them) on the same float32
numpy inputs as the JAX functions: output within 1e-5 of its largest
magnitude, int8 pools and returned scales bit-equal, and the scale
contract's errors of the same types with the same texts. Then both model
families: ``calibrate_cachekv_int8`` scales within 1e-5 (relative) of the
JAX package's (a dense prefill's amax: the products' rounding differs), and
with the JAX scales installed through ``models/convert.py``, int8-pool
``paged_prefill`` logits within 1e-5 of the largest and pools bit-equal.
The batchers with ``kv_quant``, with ``cache_quant`` (short and long
chunked prompts) and with static pages and fused admission give the JAX
package's tokens, ``stats()`` counts and ``cachekv_clip_rate``; the
configurations the JAX package refuses raise the same exception types.

Int8 weights: ``weight_quantize`` and ``WeightOnlyLinear`` (int8 and int4)
codes and scales bit-equal to the JAX package's (transposed: the port's
weights are ``[out, in]``); ``serving_quantize``'s report per layer
(``rel_err`` within 1e-6, the same decisions, a layer forced over a tiny
``err_bound``); quantized models' tokens through ``generate``,
``generate_paged`` and both batchers equal to the JAX package's, with the
weights moved across by ``models/convert.py``'s quantized path.

The models are the parity files' tiny GPT-2 (tests/test_torch_gpt2_serving
.py) and Llama (tests/test_torch_paged_batching.py), and the paged calls
their geometry (2 slots of 8 blocks of 4 rows, 15 pages, prefills and
chunks of 8 and 12 tokens): the JAX package compiles each op at each new
shape, which is most of this file's time, so each JAX scenario is computed
once per process.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.incubate.nn.functional import decode_attention as jax_da
from paddle_tpu.inference import serving as jax_serving
from paddle_tpu.models import GPT2Config as JaxGPT2Config
from paddle_tpu.models import GPT2ForCausalLM as JaxGPT2
from paddle_tpu.nn import quant as jax_nn_quant
from paddle_tpu import quantization as jax_quantization
from paddle_tpu_torch.incubate.nn.functional import (
    block_gqa_attention, block_multihead_attention)
from paddle_tpu_torch.inference import (ContinuousBatcher,
                                        PagedContinuousBatcher)
from paddle_tpu_torch.models import (GPT2Config, GPT2ForCausalLM,
                                     gpt2_state_from_paddle_tpu,
                                     load_quant_state,
                                     quant_state_from_paddle_tpu)
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import quant as nn_quant
from paddle_tpu_torch.observability import metrics as port_metrics
from paddle_tpu_torch import quantization

from test_torch_gpt2_serving import (TINY, _gpt2_state, _margin_guard,
                                     _pool_state, _prompts, _stats)
from test_torch_paged_attention import _attention_inputs, _rope_tables
from test_torch_paged_batching import _pair

ATT_RTOL = 1e-5          # attention output, relative to its largest
LOGIT_REL = 1e-5         # int8-pool prefill logits, relative to the largest
SCALE_RTOL = 1e-5        # calibrated scales: a dense prefill's amax
REL_ERR_ATOL = 1e-6      # serving_quantize's per-layer rel_err
H, KV, D = 4, 2, 16      # Llama tiny's heads (GPT-2 tiny: 4 of 4)


def _np(t):
    return np.asarray(t.numpy())


# -- the attention functions with int8 pages --------------------------------

def _int8_inputs(mode, mha, seed):
    """``_attention_inputs`` (the paged geometry of both tiny models) with
    int8 pools of random codes: an 8-token chunk of one sequence (the
    batchers' chunk calls) or one token of each of two (their decode
    steps)."""
    x = _attention_inputs(mode, 1 if mha else 2, 4, seed=seed,
                          kvh=H if mha else KV,
                          lens=[8] if mode == "chunk" else None)
    rng = np.random.RandomState(seed + 100)
    for name in ("kc", "vc"):
        x[name] = rng.randint(-127, 128, x[name].shape).astype(np.int8)
    return x, rng


def _scale_set(rng, shape):
    amax = rng.uniform(1.0, 4.0, (2,) + shape).astype(np.float32)
    return [127.0 / amax[0], 127.0 / amax[1], amax[0] / 127.0,
            amax[1] / 127.0]


SCALE_ARGS = ("cache_k_quant_scales", "cache_v_quant_scales",
              "cache_k_dequant_scales", "cache_v_dequant_scales")

# (mode, scale kind): static scales in a chunk and in decode; dynamic scales
# computed by a first chunk (5 valid rows of 8: a masked pad tail) and
# consumed by a decode step
CASES = [("chunk", "static"), ("decode", "static"),
         ("chunk", "compute"), ("decode", "dynamic")]


def _attention_call(pkg, mha, x, kind, rng_scales):
    """One call of either package's function; returns numpy (out, kc, vc,
    scales or None)."""
    if pkg == "jax":
        arr, fn_g, fn_m = jnp.asarray, jax_da.block_gqa_attention, \
            jax_da.block_multihead_attention
    else:
        arr, fn_g, fn_m = (lambda a: torch.from_numpy(np.array(a)),
                           block_gqa_attention, block_multihead_attention)
    kw = {}
    b = len(x["this"])
    if kind == "static":
        kw = dict(zip(SCALE_ARGS, map(arr, rng_scales[0])))
    elif kind == "dynamic":
        kw = dict(zip(SCALE_ARGS, map(arr, rng_scales[1])),
                  use_dynamic_cachekv_quant=True)
    elif kind == "compute":
        kw = dict(use_dynamic_cachekv_quant=True, compute_dynamic_scales=True,
                  dynamic_scale_valid=arr(np.array([5], np.int32)))
    kc, vc = arr(x["kc"]), arr(x["vc"])
    if mha:
        qkv = np.concatenate([x["q"][:, None], x["k"][:, None],
                              x["v"][:, None]], 1).reshape(len(x["q"]), -1)
        res = fn_m(arr(qkv), kc, vc, arr(x["enc"]), arr(x["dec"]),
                   arr(x["this"]), None, None, arr(x["cu"]), arr(x["cu"]),
                   arr(x["bt"]), block_size=x["bs"], **kw)
        res = (res[0],) + tuple(res[2:])
    else:
        cos, sin = _rope_tables(64, D)
        res = fn_g(arr(x["q"]), arr(x["k"]), arr(x["v"]), kc, vc,
                   arr(x["enc"]), arr(x["dec"]), arr(x["this"]),
                   arr(x["cu"]), arr(x["bt"]), block_size=x["bs"],
                   rope_cos=arr(cos), rope_sin=arr(sin), **kw)
    assert len(res) == (4 if kind == "compute" else 3)
    scales = [_np(s) for s in res[3]] if kind == "compute" else None
    assert b == len(x["this"])
    return _np(res[0]), _np(res[1]), _np(res[2]), scales


@pytest.mark.parametrize("mode,kind", CASES, ids=lambda v: v)
@pytest.mark.parametrize("mha", [False, True], ids=["gqa", "mha"])
def test_int8_attention_matches_the_jax_function(mha, mode, kind):
    x, rng = _int8_inputs(mode, mha, seed=3)
    heads = H if mha else KV
    scales = (_scale_set(rng, (heads,)), _scale_set(rng, (2, heads)))
    jo, jk, jv, js = _attention_call("jax", mha, x, kind, scales)
    po, pk, pv, ps = _attention_call("port", mha, x, kind, scales)
    assert pk.dtype == np.int8 and pv.dtype == np.int8
    assert np.abs(po - jo).max() / np.abs(jo).max() <= ATT_RTOL
    np.testing.assert_array_equal(pk, jk)
    np.testing.assert_array_equal(pv, jv)
    if kind == "compute":
        assert ps[0].shape == (1, heads)
        for a, b in zip(ps, js):
            np.testing.assert_array_equal(a, b)


def test_dynamic_scales_take_each_sequences_valid_rows():
    """The per-sequence amax of three unevenly packed sequences (one with no
    valid row: the 1e-6 floor) against the JAX package's ``segment_max``,
    bit for bit."""
    rng = np.random.RandomState(5)
    seq_of = np.array([0, 0, 0, 2, 2, 0, 2], np.int32)
    valid = np.array([1, 1, 0, 1, 0, 1, 1], bool)
    kt, vt = (rng.randn(7, KV, D).astype(np.float32) for _ in range(2))
    ref = jax_da._dynamic_prefill_scales(jnp.asarray(kt), jnp.asarray(vt),
                                         jnp.asarray(seq_of), 3,
                                         jnp.asarray(valid))
    from paddle_tpu_torch.incubate.nn.functional import decode_attention
    got = decode_attention._dynamic_prefill_scales(
        torch.from_numpy(kt), torch.from_numpy(vt),
        torch.from_numpy(seq_of).long(), 3, torch.from_numpy(valid))
    for k in ("kq", "vq", "kdq", "vdq"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    assert (got["kdq"][1] == np.float32(1e-6) / np.float32(127.0)).all()


def _contract_cases():
    """(name, build kwargs from the pools and a scale tensor, the text both
    packages raise): test_cachekv_scale_contract_errors' and
    test_cachekv_dynamic_decode_without_scales_raises' cases, plus the
    dynamic rows against the batch."""
    def four(sc):
        return dict(zip(SCALE_ARGS, [sc] * 4))
    return [
        ("no_scales", lambda p, sc, one: dict(), True, "int8 cache pool"),
        ("partial", lambda p, sc, one: dict(cache_k_dequant_scales=sc), True,
         "all four"),
        ("float_pool", lambda p, sc, one: four(sc), False, "allocate int8"),
        ("dynamic_no_opt_in", lambda p, sc, one: dict(
            use_dynamic_cachekv_quant=True), True, "compute_dynamic_scales"),
        ("decode_opt_in", lambda p, sc, one: dict(
            use_dynamic_cachekv_quant=True, compute_dynamic_scales=True),
         True, "decode-mode"),
        ("ambiguous", lambda p, sc, one: dict(
            four(one), use_dynamic_cachekv_quant=True,
            compute_dynamic_scales=True), True, "ambiguous"),
        ("compute_static", lambda p, sc, one: dict(
            compute_dynamic_scales=True), True, "requires"),
        ("dynamic_float_pool", lambda p, sc, one: dict(
            use_dynamic_cachekv_quant=True), False, "non-int8"),
        ("dynamic_rows", lambda p, sc, one: dict(
            four(p(np.ones((3, KV), np.float32))),
            use_dynamic_cachekv_quant=True), True, "per sequence"),
    ]


@pytest.mark.parametrize("case", _contract_cases(), ids=lambda c: c[0])
def test_scale_contract_errors_match_the_jax_package(case):
    _, build, int8, text = case
    x = _attention_inputs("decode", 2, 4, seed=4)
    for pkg, arr, fn in (("jax", jnp.asarray, jax_da.block_gqa_attention),
                         ("port", lambda a: torch.from_numpy(np.array(a)),
                          block_gqa_attention)):
        dt = np.int8 if int8 else np.float32
        kc, vc = arr(x["kc"].astype(dt)), arr(x["vc"].astype(dt))
        kw = build(arr, arr(np.ones(KV, np.float32)),
                   arr(np.ones((2, KV), np.float32)))
        with pytest.raises(ValueError, match=text):
            fn(arr(x["q"]), arr(x["k"]), arr(x["v"]), kc, vc, arr(x["enc"]),
               arr(x["dec"]), arr(x["this"]), arr(x["cu"]), arr(x["bt"]),
               block_size=4, **kw)


# -- the models ---------------------------------------------------------------

GEOM = dict(max_batch=2, s_max=32, block_size=4, n_pages=15)
DENSE = dict(max_batch=2, s_max=32, prompt_buckets="fixed:16")


def _gpt2_pair():
    paddle.seed(0)
    jm = JaxGPT2(JaxGPT2Config(**TINY))
    jm.eval()
    state = _gpt2_state(jm)
    jm.set_state_dict(state)
    pm = GPT2ForCausalLM(GPT2Config(**TINY), device="cpu").eval()
    pm.load_state_dict(gpt2_state_from_paddle_tpu(state))
    return jm, pm


def _quantized_pair(base, quantize):
    """The JAX GPT-2 quantized by ``quantize`` and the port's counterpart
    built from it by ``models/convert.py``'s quantized path (the codes
    installed, then the JAX state dict loaded: the biases and every layer
    left in float)."""
    jq = quantize(base)
    pq = GPT2ForCausalLM(GPT2Config(**TINY), device="cpu").eval()
    load_quant_state(pq, quant_state_from_paddle_tpu(jq))
    pq.load_state_dict(gpt2_state_from_paddle_tpu(
        {k: np.asarray(v.numpy(), np.float32)
         for k, v in jq.state_dict().items()}))
    return jq, pq


def _weight_only(algo):
    def quantize(jm):
        import copy
        jq = copy.deepcopy(jm)
        jax_nn_quant.quantize_linear_layers(jq, algo)
        return jq
    return quantize


class _Models(dict):
    """The model pairs, each built on first use: Llama tiny and GPT-2 tiny
    in float32, and GPT-2 with int8 serving weights (``serving_quantize``)
    and with weight-only int8 and int4 linears."""

    def __missing__(self, key):
        if key == "llama":
            pair = _pair(64)
        elif key == "gpt2":
            pair = _gpt2_pair()
        elif key == "gpt2_sq":
            pair = _quantized_pair(self["gpt2"][0],
                                   jax_quantization.serving_quantize)
        else:                                   # gpt2_int8, gpt2_int4
            pair = _quantized_pair(self["gpt2"][0], _weight_only(
                "weight_only_" + key.split("_")[1]))
        self[key] = pair
        return pair


@pytest.fixture(scope="module")
def models():
    return _Models()


class _Calibrated:
    """Static int8 pages on both models of a pair: the JAX model calibrated
    on ``calib``, its scales installed in the port's (``load_quant_state``),
    so both packages quantize with the same scales; undone on exit."""

    def __init__(self, pair, calib):
        self.pair, self.calib = pair, calib

    def __enter__(self):
        jm, pm = self.pair
        with paddle.no_grad():
            jm.calibrate_cachekv_int8(paddle.to_tensor(self.calib))
        load_quant_state(pm, quant_state_from_paddle_tpu(jm))
        return self

    def __exit__(self, *exc):
        for m in self.pair:
            m.calibrate_cachekv_int8(None)


def _calib_ids():
    return np.stack(_prompts(30, (8, 8)))


# -- calibration and int8-pool prefills ---------------------------------------

def _prefill_8(model, pools, numpy, tensor, **kw):
    """One 8-token prompt through ``paged_prefill_into`` at the batcher's
    chunk shape (``dec_base`` 0, logits at row 7), into a block-table row
    of 8 shuffled pages. Returns numpy (logits, pools, scales or None)."""
    (ids,) = _prompts(31, (8,))
    bt = np.random.RandomState(32).permutation(15)[:8].reshape(1, 8)
    res = model.paged_prefill_into(
        tensor(ids[None].astype(np.int64)), pools, tensor(bt.astype(
            np.int32)), 4, dec_base=tensor(np.zeros(1, np.int32)),
        logits_at=tensor(np.array([7], np.int32)), **kw)
    scales = None
    if len(res) == 3:
        scales = [{k: numpy(v) for k, v in layer.items()}
                  for layer in res[2]]
    return (numpy(res[0]), [[numpy(p) for p in layer] for layer in res[1]],
            scales)


def _jax_prefill_8(jm, **kw):
    with paddle.no_grad():
        pools = jm.paged_alloc(16, 4, cache_dtype="int8")
        return _prefill_8(jm, pools, _np, paddle.to_tensor, **kw)


def _port_prefill_8(pm, **kw):
    pools = pm.paged_alloc(16, 4, cache_dtype="int8")
    return _prefill_8(pm, pools, lambda t: t.numpy(), torch.from_numpy,
                      **kw)


def _pools_close(got, ref):
    """int8 pools of two prefills whose K/V rows agree to float rounding:
    equal codes, or one apart where a row's scaled value sits on a rounding
    boundary."""
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            assert a.dtype == b.dtype == np.int8
            assert np.abs(a.astype(np.int32) - b).max() <= 1


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_calibrated_scales_and_int8_prefill_match(models, family):
    jm, pm = models[family]
    calib = _calib_ids()
    with paddle.no_grad():
        ref = jm.calibrate_cachekv_int8(paddle.to_tensor(calib))
    try:
        got = pm.calibrate_cachekv_int8(torch.from_numpy(calib))
        assert len(got) == len(ref) == 2
        for g, r in zip(got, ref):
            for k in ("kq", "vq", "kdq", "vdq"):
                np.testing.assert_allclose(g[k].numpy(), np.asarray(r[k]),
                                           rtol=SCALE_RTOL, atol=0)
        # the JAX scales in the port: the same int8 prefill
        load_quant_state(pm, quant_state_from_paddle_tpu(jm))
        assert pm.paged_alloc(2, 4)[0][0].dtype == torch.int8
        jl, jp, _ = _jax_prefill_8(jm)
        pl, pp, _ = _port_prefill_8(pm)
        assert np.abs(pl - jl).max() <= LOGIT_REL * np.abs(jl).max()
        _pools_close(pp, jp)
    finally:
        jm.calibrate_cachekv_int8(None)
        pm.calibrate_cachekv_int8(None)
    assert pm.paged_alloc(2, 4)[0][0].dtype == torch.float32


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_dynamic_int8_prefill_matches(models, family):
    """A first chunk computing its own scales (its last 3 rows a pad tail
    kept out of them), then the same chunk quantized with them."""
    jm, pm = models[family]
    valid = dict(dynamic_cache_scales=True)
    jl, jp, js = _jax_prefill_8(jm, **valid, dynamic_scale_valid=(
        paddle.to_tensor(np.array([5], np.int32))))
    pl, pp, ps = _port_prefill_8(pm, **valid, dynamic_scale_valid=(
        torch.tensor([5], dtype=torch.int32)))
    assert np.abs(pl - jl).max() <= LOGIT_REL * np.abs(jl).max()
    _pools_close(pp, jp)
    for g, r in zip(ps, js):
        for k in r:
            assert g[k].shape == (1, KV if family == "llama" else H)
            np.testing.assert_allclose(g[k], r[k], rtol=SCALE_RTOL, atol=0)
    # later chunks take the first chunk's scales (the JAX ones in both)
    jl2, jp2, _ = _jax_prefill_8(jm, cache_scales=[
        {k: paddle.to_tensor(v) for k, v in layer.items()} for layer in js])
    pl2, pp2, _ = _port_prefill_8(pm, cache_scales=[
        {k: torch.tensor(v) for k, v in layer.items()} for layer in js])
    assert np.abs(pl2 - jl2).max() <= LOGIT_REL * np.abs(jl2).max()
    _pools_close(pp2, jp2)
    with pytest.raises(ValueError, match="pass one"):
        pm.paged_prefill_into(torch.zeros(1, 4, dtype=torch.int64),
                              pm.paged_alloc(2, 4, cache_dtype="int8"),
                              torch.zeros(1, 1, dtype=torch.int32), 4,
                              dynamic_cache_scales=True, cache_scales=[])


# -- the batchers, scenario by scenario --------------------------------------

class _Side:
    """One package's model and batcher classes; the JAX batcher's greedy
    picks guarded by the top-1/top-2 margin."""

    def __init__(self, model, jax):
        self.model, self.jax = model, jax
        self.dense, self.paged = ((jax_serving.ContinuousBatcher,
                                   jax_serving.PagedContinuousBatcher)
                                  if jax else
                                  (ContinuousBatcher, PagedContinuousBatcher))

    def make(self, cls, **kw):
        b = cls(self.model, compile=False, **kw)
        return _margin_guard(b) if self.jax else b

    def gauge(self, name):
        from paddle_tpu.observability import metrics as jax_metrics
        reg = (jax_metrics if self.jax else port_metrics).get_registry()
        return reg.get(name).value


def _serve(b, prompts, news):
    rids = [b.submit(p, n) for p, n in zip(prompts, news)]
    outs = b.run_until_done(max_steps=400)
    return [outs[r].tolist() for r in rids]


def _int8_pool(b):
    kc, vc = b._state["layers"][0]
    return str(kc.dtype).endswith("int8") and str(vc.dtype).endswith("int8")


def _scale_rows_reset(b):
    return all((layer[k] == 1.0).all() for layer in b._scales_np
               for k in layer)


def static_pages(side):
    """kv_quant="int8" on calibrated pages, chunked and on demand."""
    b = side.make(side.paged, kv_quant="int8", prefill_chunk=8,
                  policy="ondemand", **GEOM)
    assert _int8_pool(b)
    toks = _serve(b, _prompts(33, (8, 12, 5)), (6, 6, 6))
    return [toks, _pool_state(b), _stats(b),
            side.gauge("serving.kv_quant_enabled"),
            side.gauge("serving.kv_quant_bytes_saved")]


def static_fused(side):
    """Calibrated pages through fused admission and 4-step blocks
    (test_quant_serving.py::test_static_cachekv_int8_with_fused_admission_
    token_exact)."""
    b = side.make(side.paged, prefill_chunk=8, fused_admission=True,
                  decode_block=4, **GEOM)
    assert _int8_pool(b)
    toks = _serve(b, _prompts(17, (5, 11, 8)), (5, 5, 5))
    return [toks, _pool_state(b), _stats(b)]


def dynamic_short(side):
    """cache_quant with prompts within one chunk (their pad tails kept out
    of the scales), then whole-prompt prefills (test_quant_serving.py::
    test_dynamic_int8_chunked_short_prompts_match_unchunked, at the chunk's
    width); the scale rows reset on release."""
    seen = []
    for chunk, lens in ((8, (5, 8, 3, 8)), (None, (8, 8, 8))):
        b = side.make(side.paged, cache_quant="dynamic_int8",
                      prefill_chunk=chunk, **GEOM)
        assert _int8_pool(b)
        toks = _serve(b, _prompts(12, lens), (6,) * len(lens))
        seen.append([toks, _pool_state(b), _stats(b), _scale_rows_reset(b),
                     b.stats()["cachekv_clip_rate"]])
    return seen


def dynamic_long(side):
    """Prompts longer than the chunk: the first chunk's scales quantize the
    rest, and the last later chunk's saturation is sampled
    (test_dynamic_int8_chunked_long_prompts_scale_consistent,
    test_chunked_int8_clip_telemetry)."""
    b = side.make(side.paged, cache_quant="dynamic_int8", prefill_chunk=8,
                  policy="ondemand", **GEOM)
    toks = _serve(b, _prompts(13, (19, 13)), (5, 6))
    return [toks, _pool_state(b), _stats(b), _scale_rows_reset(b),
            b._stat_cachekv_elems, b._stat_cachekv_clipped,
            b.stats()["cachekv_clip_rate"]]


def weights_serving(side):
    """Int8 weights through generate, generate_paged and both batchers
    (test_quant_serving.py::test_quantized_batchers_token_exact,
    test_quantized_paged_matches_quantized_dense)."""
    ids = np.stack(_prompts(6, (8, 8)))
    if side.jax:
        with paddle.no_grad():
            gen = _np(side.model.generate(paddle.to_tensor(ids), 6,
                                          s_max=32))
            paged = _np(side.model.generate_paged(
                paddle.to_tensor(ids), 6, block_size=4, blocks_per_seq=8))
    else:
        gen = side.model.generate(torch.from_numpy(ids), 6, s_max=32).numpy()
        paged = side.model.generate_paged(torch.from_numpy(ids), 6,
                                          block_size=4,
                                          blocks_per_seq=8).numpy()
    prompts = _prompts(1, (4, 6, 8))
    dense = _serve(side.make(side.dense, **DENSE), prompts, (5, 5, 5))
    b = side.make(side.paged, prefill_chunk=8, **GEOM)
    pg = _serve(b, prompts, (5, 5, 5))
    return [gen.tolist(), paged.tolist(), dense, pg, _pool_state(b)]


def weights_generate(side):
    """Weight-only int8 or int4 linears through generate."""
    ids = np.stack(_prompts(6, (8, 8)))
    if side.jax:
        with paddle.no_grad():
            return _np(side.model.generate(paddle.to_tensor(ids), 6,
                                           s_max=32)).tolist()
    return side.model.generate(torch.from_numpy(ids), 6,
                               s_max=32).numpy().tolist()


# (model key, scenario, calibrated): each scenario runs once per package
RUNS = [("llama", static_pages, True), ("llama", static_fused, True),
        ("llama", dynamic_short, False), ("llama", dynamic_long, False),
        ("gpt2", static_pages, True), ("gpt2", dynamic_long, False),
        ("gpt2_sq", weights_serving, False),
        ("gpt2_int8", weights_serving, False),
        ("gpt2_int4", weights_generate, False)]


def _run(models, run, jax):
    key, scenario, calibrated = run
    pair = models[key]
    side = _Side(pair[0] if jax else pair[1], jax)
    if not calibrated:
        return scenario(side)
    with _Calibrated(pair, _calib_ids()):
        return scenario(side)


class _Results(dict):
    """Each run's result on the JAX side, computed on first use."""

    def __init__(self, models):
        super().__init__()
        self.models = models

    def __missing__(self, run):
        with paddle.no_grad():
            self[run] = result = _run(self.models, run, jax=True)
        return result


@pytest.fixture(scope="module")
def jax_results(models):
    return _Results(models)


@pytest.mark.parametrize("run", RUNS,
                         ids=lambda r: f"{r[0]}-{r[1].__name__}")
def test_scenario_matches_the_jax_batcher(models, jax_results, run):
    got = _run(models, run, jax=False)
    assert got == jax_results[run]


# -- the configurations both packages refuse ---------------------------------

REFUSED = [
    ("cache_quant_unknown", dict(cache_quant="int4"), False),
    ("kv_quant_unknown", dict(kv_quant="int4"), False),
    ("kv_quant_uncalibrated", dict(kv_quant="int8"), False),
    ("two_quantizers", dict(kv_quant="int8", cache_quant="dynamic_int8"),
     True),
    ("prefix_cache_dynamic", dict(cache_quant="dynamic_int8",
                                  prefix_cache=True), False),
    ("fused_dynamic", dict(cache_quant="dynamic_int8", prefill_chunk=8,
                           fused_admission=True), False),
    ("one_token_chunk", dict(cache_quant="dynamic_int8", prefill_chunk=1),
     False),
    ("tier_quant_unknown", dict(tier_quant="int4"), False),
    ("tier_quant_no_prefix_cache", dict(tier_quant="int8"), False),
    ("tier_quant_calibrated", dict(tier_quant="int8", prefix_cache=True),
     True),
]


@pytest.mark.parametrize("case", REFUSED, ids=lambda c: c[0])
def test_refused_configurations_raise_the_jax_packages_errors(models, case):
    _, kw, calibrated = case
    pair = models["llama"]
    args = dict(GEOM, compile=False, **kw)

    def errors():
        seen = []
        for cls, m in ((jax_serving.PagedContinuousBatcher, pair[0]),
                       (PagedContinuousBatcher, pair[1])):
            with pytest.raises(Exception) as info:
                cls(m, **args)
            seen.append((type(info.value).__name__, str(info.value)))
        return seen

    if calibrated:
        with _Calibrated(pair, _calib_ids()):
            ref, got = errors()
    else:
        ref, got = errors()
    assert ref[0] == "ValueError"
    assert got == ref


def test_options_that_wait_name_their_roadmap_items(models):
    """tier_quant passes the JAX package's checks and builds the same
    quantizing host tier (queue 1, item 1.4, ported; its codes are held in
    tests/test_torch_kv_tier.py); draft_model (item 1.5, ported) with
    calibrated int8 pages raises the JAX package's error."""
    jm, pm = models["llama"]
    for kw in (dict(tier_quant="int8", prefix_cache=True, host_kv_gib=1.0),
               dict(host_kv_gib=1.0)):
        built = []
        for cls, m in ((PagedContinuousBatcher, pm),
                       (jax_serving.PagedContinuousBatcher, jm)):
            b = cls(m, compile=False, **GEOM, **kw)
            host = b.prefix_cache.host_tier if b.prefix_cache else None
            built.append([b.tier_quant, getattr(host, "capacity_bytes",
                                                None)])
            b.close()
        assert built[0] == built[1]
    seen = []
    with _Calibrated(models["llama"], _calib_ids()):
        for cls, m in ((PagedContinuousBatcher, pm),
                       (jax_serving.PagedContinuousBatcher, jm)):
            with pytest.raises(ValueError) as info:
                cls(m, compile=False, **GEOM, kv_quant="int8", draft_model=m)
            seen.append(str(info.value))
    assert seen[0] == seen[1] and "draft_model" in seen[0]


# -- int8 weights -----------------------------------------------------------

@pytest.mark.parametrize("algo", ["weight_only_int8", "weight_only_int4"])
def test_weight_quantize_and_weight_only_linear_match(algo):
    rng = np.random.RandomState(40)
    w = rng.randn(48, 24).astype(np.float32)          # JAX layout [in, out]
    w[:, 5] = 0.0                                     # an all-zero channel
    jq, js = jax_nn_quant.weight_quantize(paddle.to_tensor(w), algo)
    pq, ps = nn_quant.weight_quantize(torch.from_numpy(w.T.copy()), algo)
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(), _np(jq).T)
    np.testing.assert_array_equal(ps.numpy(), _np(js))
    assert ps[5] == 1.0
    assert np.abs(pq.numpy()).max() == (7 if "int4" in algo else 127)
    # the layer around those codes, and the functions it calls
    lin = Linear(48, 24, bias=True, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
        lin.bias.copy_(torch.from_numpy(rng.randn(24).astype(np.float32)))
    jlin = paddle.nn.Linear(48, 24)
    jlin.weight.set_value(w)
    jlin.bias.set_value(lin.bias.detach().numpy())
    jl, pl = jax_nn_quant.WeightOnlyLinear(jlin, algo), \
        nn_quant.WeightOnlyLinear(lin, algo)
    np.testing.assert_array_equal(pl.quant_weight.numpy(),
                                  _np(jl.quant_weight).T)
    np.testing.assert_array_equal(pl.weight_scale.numpy(),
                                  _np(jl.weight_scale))
    assert (pl.in_features, pl.out_features) == (jl.in_features,
                                                 jl.out_features)
    x = rng.randn(3, 48).astype(np.float32)
    with paddle.no_grad():
        ref = _np(jl(paddle.to_tensor(x)))
    got = pl(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    deq = nn_quant.weight_dequantize(pq, ps, algo, out_dtype="float32")
    np.testing.assert_array_equal(deq.numpy(), _np(
        jax_nn_quant.weight_dequantize(jq, js, algo,
                                       out_dtype="float32")).T)
    got = nn_quant.llm_int8_linear(torch.from_numpy(x), pq, lin.bias, ps)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_quantize_linear_layers_swaps_the_same_layers(models):
    import copy
    jm, pm = models["gpt2"]
    for min_features in (1, 65):
        jc, pc = copy.deepcopy(jm), copy.deepcopy(pm)
        n = jax_nn_quant.quantize_linear_layers(jc, min_features=min_features)
        assert nn_quant.quantize_linear_layers(
            pc, min_features=min_features) == n
        swapped = sorted(p for p, m in pc.named_modules()
                         if isinstance(m, nn_quant.WeightOnlyLinear))
        assert swapped == sorted(
            p for p, m in jc.named_sublayers()
            if isinstance(m, jax_nn_quant.WeightOnlyLinear))
    assert n == 2                                  # c_fc takes 64 inputs
    assert isinstance(nn_quant.Stub()(torch.ones(2)), torch.Tensor)


def _report(model):
    rep = model._serving_quant_report
    return ({p: (v["quantized"], v["rel_err"], v["mae"])
             for p, v in rep["layers"].items()},
            [rep[k] for k in ("layers_quantized", "layers_fallback",
                              "bytes_saved", "err_bound")])


@pytest.mark.parametrize("kw", [dict(), dict(channelwise=False),
                                dict(err_bound=None)],
                         ids=["channel", "tensor", "forced_fallback"])
def test_serving_quantize_reports_match(models, kw):
    """Per layer: the same decision, rel_err within 1e-6 and mae within
    1e-6 relative; the counts, bytes and the quant.* series equal.
    ``forced_fallback``: a bound between the layers' errors, so that the
    layers over it stay float."""
    jm, pm = models["gpt2"]
    if "err_bound" in kw:
        errs = sorted(v["rel_err"] for v in jax_quantization.serving_quantize(
            jm)._serving_quant_report["layers"].values())
        kw = dict(err_bound=(errs[1] + errs[2]) / 2)
    from paddle_tpu.observability import metrics as jax_metrics
    names = ("quant.layers_quantized", "quant.layers_fallback",
             "quant.weight_bytes_saved")

    def counts(metrics):
        reg = metrics.get_registry()
        return [reg.get(n).value if reg.get(n) is not None else 0
                for n in names]

    j0, p0 = counts(jax_metrics), counts(port_metrics)
    jq = jax_quantization.serving_quantize(jm, **kw)
    pq = quantization.serving_quantize(pm, **kw)
    j1, p1 = counts(jax_metrics), counts(port_metrics)
    (jl, jc), (pl, pc) = _report(jq), _report(pq)
    assert pc == jc and list(pl) == list(jl)
    for path, (ok, rel, mae) in jl.items():
        assert pl[path][0] == ok, path
        assert abs(pl[path][1] - rel) <= REL_ERR_ATOL, path
        assert abs(pl[path][2] - mae) <= REL_ERR_ATOL * max(mae, 1.0), path
    assert [b - a for a, b in zip(p0, p1)] == [b - a for a, b in zip(j0, j1)]
    if "err_bound" in kw:
        assert 0 < jc[0] < len(jl)                  # some of each
    # a quantized layer holds the JAX codes; the input model is untouched
    for path, (ok, _, _) in pl.items():
        layer = pq.get_submodule(path)
        assert isinstance(layer, quantization._ConvertedLinear) == ok
        if ok:
            jlayer = dict(jq.named_sublayers())[path]
            np.testing.assert_array_equal(layer.w_int8.numpy(),
                                          _np(jlayer.w_int8).T)
        assert type(pm.get_submodule(path)) is Linear


def test_converted_layers_carry_the_jax_codes_and_report(models):
    """models/convert.py's quantized path: the JAX model's codes, scales
    and report, equal to what the port's own serving_quantize makes of the
    same float weights."""
    jq, pq = models["gpt2_sq"]
    own = quantization.serving_quantize(models["gpt2"][1])
    assert pq._serving_quant_report == jq._serving_quant_report
    n = 0
    for path, layer in own.named_modules():
        if isinstance(layer, quantization._ConvertedLinear):
            moved = pq.get_submodule(path)
            assert isinstance(moved, quantization._ConvertedLinear)
            assert torch.equal(moved.w_int8, layer.w_int8)
            assert torch.equal(moved.scale, layer.scale)
            assert torch.equal(moved._dq, layer._dq)
            n += 1
    assert n == jq._serving_quant_report["layers_quantized"] > 0
    assert set(pq.state_dict()) == set(jq.state_dict())
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        quantization.serving_quantize(models["gpt2"][1], mesh=object())
