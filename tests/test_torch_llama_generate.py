"""The port's Llama serving path (paddle_tpu_torch.models) against the JAX
package's, on llama_tiny_config (GQA 4/2), on the CPU.

Weights move across with models/convert.py; seeds are never matched.
Inputs are explicit float32/int64 numpy arrays (the suite runs JAX with x64
on). Float comparisons use atol 1e-5 (float32, different summation
orders); token comparisons are exact, and the fixture asserts a top-1/top-2
logit margin above 1e-3 at every step, so a near-tie shows up as a fixture
problem rather than as a port fault.
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama as jax_llama
from paddle_tpu.models import llama_tiny_config as jax_tiny_config
from paddle_tpu.nn import functional as jax_F
from paddle_tpu_torch.models import (LlamaForCausalLM, llama2_7b_config,
                                     llama_state_from_paddle_tpu,
                                     llama_tiny_config)
from paddle_tpu_torch.models import llama as port_llama
from paddle_tpu_torch.models.generation import generate_loop
from paddle_tpu_torch.nn import functional as port_F

ATOL = 1e-5
MARGIN = 1e-3
NEW = 6
REPO = Path(__file__).resolve().parent.parent


def _margins(logits):
    top2 = np.sort(logits.reshape(logits.shape[0], -1), axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


@pytest.fixture(scope="module")
def pair():
    """(jax_model, port_model, ids) with the same weights. Norm weights are
    drawn too, so the norms' scaling is exercised."""
    paddle.seed(0)
    cfg = jax_tiny_config(initializer_range=0.2)
    jm = JaxLlama(cfg)
    jm.eval()
    rng = np.random.RandomState(0)
    state = {k: np.asarray(v.numpy(), np.float32)
             for k, v in jm.state_dict().items()}
    for k in state:
        if k.endswith("norm.weight"):
            state[k] = (1.0 + 0.3 * rng.randn(*state[k].shape)
                        ).astype(np.float32)
    jm.set_state_dict(state)
    pm = LlamaForCausalLM(llama_tiny_config(initializer_range=0.2),
                          device="cpu")
    converted = llama_state_from_paddle_tpu(state)
    assert len(converted) == 21
    pm.load_state_dict(converted)
    ids = rng.randint(0, cfg.vocab_size, (2, 10)).astype(np.int64)

    # every greedy step of the reference must be far from a tie
    with paddle.no_grad():
        logits, caches, t = jm.prefill(paddle.to_tensor(ids), 10 + NEW)
        for _ in range(NEW):
            lg = np.asarray(logits.numpy())
            assert np.all(_margins(lg) > MARGIN), "fixture near-tie"
            tok = paddle.to_tensor(lg[:, -1].argmax(-1)[:, None])
            logits, caches, t = jm.decode_step(tok, caches, t)
    return jm, pm, ids


def _jax_generate(jm, ids, n, **kw):
    with paddle.no_grad():
        return np.asarray(jm.generate(paddle.to_tensor(ids), n, **kw).numpy())


def test_prefill_logits_and_caches_match(pair):
    jm, pm, ids = pair
    s_max = ids.shape[1] + NEW
    with paddle.no_grad():
        jl, jc, jt = jm.prefill(paddle.to_tensor(ids), s_max)
    pl, pc, pt = pm.prefill(torch.from_numpy(ids), s_max)
    assert tuple(pc.shape) == tuple(jc.shape) == (2, 2, 2, 2, s_max, 16)
    np.testing.assert_allclose(pl.numpy(), jl.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(pc.numpy(), jc.numpy(), atol=ATOL, rtol=0)
    assert pt.dtype == torch.int32
    np.testing.assert_array_equal(pt.numpy(), jt.numpy())


def test_decode_step_matches(pair):
    jm, pm, ids = pair
    s_max = ids.shape[1] + NEW
    with paddle.no_grad():
        jl, jc, jt = jm.prefill(paddle.to_tensor(ids), s_max)
        tok = np.asarray(jl.numpy())[:, -1].argmax(-1)[:, None]
        jl2, jc2, jt2 = jm.decode_step(paddle.to_tensor(tok), jc, jt)
    pl, pc, pt = pm.prefill(torch.from_numpy(ids), s_max)
    pl2, pc2, pt2 = pm.decode_step(torch.from_numpy(tok), pc, pt)
    np.testing.assert_allclose(pl2.numpy(), jl2.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(pc2.numpy(), jc2.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(pt2.numpy(), jt2.numpy())


def test_full_forward_logits_match(pair):
    jm, pm, ids = pair
    with paddle.no_grad():
        ref = jm(paddle.to_tensor(ids)).numpy()
    with torch.no_grad():
        out = pm(torch.from_numpy(ids))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_tied_embeddings_logits_match():
    paddle.seed(1)
    jm = JaxLlama(jax_tiny_config(tie_word_embeddings=True,
                                  initializer_range=0.2))
    jm.eval()
    state = {k: np.asarray(v.numpy(), np.float32)
             for k, v in jm.state_dict().items()}
    pm = LlamaForCausalLM(llama_tiny_config(tie_word_embeddings=True,
                                            initializer_range=0.2),
                          device="cpu")
    pm.load_state_dict(llama_state_from_paddle_tpu(state))
    assert pm.lm_head is None and "lm_head.weight" not in state
    ids = np.random.RandomState(5).randint(0, 128, (2, 7)).astype(np.int64)
    with paddle.no_grad():
        ref, _, _ = jm.prefill(paddle.to_tensor(ids), 9)
    out, _, _ = pm.prefill(torch.from_numpy(ids), 9)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL, rtol=0)


def test_generate_tokens_equal(pair):
    jm, pm, ids = pair
    ref = _jax_generate(jm, ids, NEW)
    out = pm.generate(torch.from_numpy(ids), NEW)
    assert out.dtype == torch.int64
    assert tuple(out.shape) == (2, ids.shape[1] + NEW)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("rows", [2, 1])
def test_generate_with_eos_equal(pair, rows):
    # eos = row 0's second new token: with two rows one finishes early and
    # the other keeps going; with one row all rows finish and the output is
    # right-padded with pad_id
    jm, pm, ids = pair
    ids = ids[:rows]
    s = ids.shape[1]
    eos = int(_jax_generate(jm, ids, NEW)[0, s + 1])
    ref = _jax_generate(jm, ids, NEW, eos_id=eos, pad_id=0)
    out = pm.generate(torch.from_numpy(ids), NEW, eos_id=eos, pad_id=0)
    assert tuple(out.shape) == (rows, s + NEW)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (ref[0, s + 2:] == 0).all()


def test_greedy_keeps_first_index_of_a_tie():
    logits = torch.tensor([[[0.0, 2.0, 2.0, 1.0]], [[3.0, 1.0, 3.0, 3.0]]])

    def prefill():
        return logits, None, None

    out = generate_loop(prefill, None, torch.zeros(2, 1, dtype=torch.int64),
                        1)
    assert out[:, 1].tolist() == [1, 0]


def test_rope_tables_and_rotation_match_in_bf16():
    cos_j, sin_j = jax_llama._rope_cos_sin(64, 16, 1e4, jnp.bfloat16)
    cos_p, sin_p = port_llama._rope_cos_sin(64, 16, 1e4, torch.bfloat16,
                                            "cpu")
    assert torch.equal(cos_p.float(),
                       torch.from_numpy(np.asarray(cos_j, np.float32)))
    assert torch.equal(sin_p.float(),
                       torch.from_numpy(np.asarray(sin_j, np.float32)))
    x = np.random.RandomState(1).randn(2, 64, 4, 16).astype(np.float32)
    ref = np.asarray(jax_llama.apply_rotary_pos_emb(
        jnp.asarray(x, jnp.bfloat16), cos_j, sin_j).astype(jnp.float32))
    out = port_llama.apply_rotary_pos_emb(
        torch.from_numpy(x).to(torch.bfloat16), cos_p, sin_p).float().numpy()
    # one bf16 ulp: XLA may fuse the rotation's multiply-add
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert np.all(np.abs(out - ref) <= ulp)


def test_decode_attention_matches():
    rng = np.random.RandomState(2)
    b, h, kvh, d, s_max = 3, 4, 2, 16, 12
    q = rng.randn(b, h, d).astype(np.float32)
    kn = rng.randn(b, kvh, d).astype(np.float32)
    vn = rng.randn(b, kvh, d).astype(np.float32)
    ck = rng.randn(b, kvh, s_max, d).astype(np.float32)
    cv = rng.randn(b, kvh, s_max, d).astype(np.float32)
    t = np.array([0, 5, 11], np.int32)
    cos_j, sin_j = jax_llama._rope_cos_sin(s_max, d, 1e4, jnp.float32)
    ctx_j, ck_j, cv_j = jax_llama._decode_attn(
        *(jnp.asarray(a) for a in (q, kn, vn, ck, cv, t)), cos_j, sin_j)
    cos_p, sin_p = port_llama._rope_cos_sin(s_max, d, 1e4, torch.float32,
                                            "cpu")
    ck_p, cv_p = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    ctx_p = port_llama._decode_attn(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        ck_p, cv_p, torch.from_numpy(t).long(), cos_p, sin_p)
    np.testing.assert_allclose(ctx_p.numpy(), np.asarray(ctx_j), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(ck_p.numpy(), np.asarray(ck_j), atol=ATOL,
                               rtol=0)
    np.testing.assert_array_equal(cv_p.numpy(), np.asarray(cv_j))


@pytest.mark.parametrize("causal", [True, False])
def test_dense_sdpa_matches_on_cpu(causal):
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(2, 9, 4, 16).astype(np.float32) for _ in range(3))
    ref = jax_F.scaled_dot_product_attention(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
        is_causal=causal).numpy()
    out = port_F.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), is_causal=causal)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_configs_match_the_jax_package():
    for port_cfg, jax_cfg in ((llama2_7b_config(),
                               jax_llama.llama2_7b_config()),
                              (llama_tiny_config(), jax_tiny_config())):
        for f in dataclasses.fields(port_cfg):
            assert getattr(port_cfg, f.name) == getattr(jax_cfg, f.name), \
                f.name
        assert port_cfg.head_dim == jax_cfg.head_dim


def test_model_without_device_raises_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaForCausalLM(llama_tiny_config())


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_paddle_tpu():
    files = sorted((REPO / "paddle_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    bad = [(str(p.relative_to(REPO)), m) for p in files for m in _imports(p)
           if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
    assert bad == []
