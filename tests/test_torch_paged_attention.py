"""The port's paged attention against the JAX package's, on the CPU.

``paddle_tpu_torch.incubate.nn.functional.block_gqa_attention`` runs on the
same float32 numpy inputs as the JAX function (XLA code there, run as the
JAX package's own tests run it): prefill, chunk (append after ``dec``) and
decode modes, GQA rep 1 and 2, block sizes 4 and 16, a shuffled block table
whose last entry is the scratch row, uneven packing, and the two indices the
JAX path clamps (a block index past the table, a RoPE position past the
table). The output must agree within 1e-5 relative to its largest
magnitude; the pools must be bit-equal after the call. Llama's paged
methods, which call it, are held to the JAX package's in
tests/test_torch_paged_batching.py.

The JAX package compiles each op once per shape, so the calls take the
shapes Llama tiny's paged calls give the function there (4 query and 2 KV
heads of 16, a 64-row RoPE table, 2 sequences of 8 blocks of 4 rows in a
pool of 16 pages, prefill 2 x 6 tokens as ``generate_paged``'s, a
12-token chunk as a 12-token prompt's, decode 2 x 1, an 8-token chunk
past the table): run in one process, the two files compile those ops
once.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.incubate.nn.functional.decode_attention import \
    block_gqa_attention as jax_block_gqa_attention
from paddle_tpu_torch.incubate.nn.functional import block_gqa_attention

RTOL = 1e-5


def _rope_tables(rows, d):
    inv = 1.0 / (10000 ** (np.arange(0, d, 2, dtype=np.float32) / d))
    freqs = np.outer(np.arange(rows, dtype=np.float32), inv)
    return np.cos(freqs).astype(np.float32), np.sin(freqs).astype(np.float32)


def _attention_inputs(mode, rep, bs, seed=0, kvh=2, d=16,
                      past_capacity=False, lens=None):
    """Packed q/k/v, pools with random contents, a shuffled block table
    whose last entry is the scratch row, and the sequence lengths of one
    call: 2 sequences of 6 tokens in prefill, one of 12 appended after
    ``dec`` in chunk mode (``lens``: uneven ones), 2 of one in decode. The
    timelines hold 32 rows (8 blocks of 4, or 2 of 16) in pools of 16
    pages."""
    rng = np.random.RandomState(seed)
    if lens is None:
        lens = {"prefill": [6, 6], "chunk": [12], "decode": [1, 1]}[mode]
    b = len(lens)
    bps = 32 // bs
    n_pages = 15                                          # and the scratch
    pools = [rng.randn(n_pages + 1, kvh, bs, d).astype(np.float32)
             for _ in range(2)]
    bt = np.append(rng.permutation(n_pages)[:b * bps - 1],
                   n_pages).reshape(b, bps).astype(np.int32)
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    this = np.asarray(lens, np.int32)
    if mode == "prefill":
        enc, dec = this.copy(), np.zeros(b, np.int32)
    else:
        enc = np.zeros(b, np.int32)
        dec = rng.randint(0, bs * bps - max(lens), b).astype(np.int32)
    if past_capacity:
        # the last rows fall past the table: their block index clamps
        dec[:] = bs * bps - 2
    t = int(cu[-1])
    q = rng.randn(t, kvh * rep, d).astype(np.float32)
    k = rng.randn(t, kvh, d).astype(np.float32)
    v = rng.randn(t, kvh, d).astype(np.float32)
    return dict(q=q, k=k, v=v, kc=pools[0], vc=pools[1], enc=enc, dec=dec,
                this=this, cu=cu, bt=bt, bs=bs)


def _jax(x, rope_rows=64):
    cos, sin = _rope_tables(rope_rows, x["q"].shape[-1])
    out = jax_block_gqa_attention(
        jnp.asarray(x["q"]), jnp.asarray(x["k"]), jnp.asarray(x["v"]),
        jnp.asarray(x["kc"]), jnp.asarray(x["vc"]), x["enc"], x["dec"],
        x["this"], x["cu"], x["bt"], block_size=x["bs"],
        rope_cos=jnp.asarray(cos), rope_sin=jnp.asarray(sin))
    return tuple(np.asarray(a.numpy()) for a in out)


def _port(x, rope_rows=64, cu=None):
    cos, sin = _rope_tables(rope_rows, x["q"].shape[-1])
    kc, vc = torch.from_numpy(x["kc"].copy()), torch.from_numpy(
        x["vc"].copy())
    t = torch.from_numpy
    po, pk, pv = block_gqa_attention(
        t(x["q"]), t(x["k"]), t(x["v"]), kc, vc, t(x["enc"]), t(x["dec"]),
        t(x["this"]), t(x["cu"]) if cu is None else cu, t(x["bt"]),
        block_size=x["bs"], rope_cos=t(cos), rope_sin=t(sin))
    assert pk is kc and pv is vc                 # written in place
    return po.numpy(), pk.numpy(), pv.numpy()


def _both(x, rope_rows=64):
    return _jax(x, rope_rows), _port(x, rope_rows)


def _assert_close(ref, got):
    (jo, jk, jv), (po, pk, pv) = ref, got
    assert po.shape == jo.shape and po.dtype == jo.dtype
    err = np.abs(po - jo).max() / np.abs(jo).max()
    assert err <= RTOL, err
    np.testing.assert_array_equal(pk, jk)
    np.testing.assert_array_equal(pv, jv)


@pytest.mark.parametrize("bs", [4, 16])
@pytest.mark.parametrize("rep", [1, 2])
@pytest.mark.parametrize("mode", ["prefill", "chunk", "decode"])
def test_block_gqa_attention_matches_the_jax_package(mode, rep, bs):
    x = _attention_inputs(mode, rep, bs)
    ref, got = _both(x)
    _assert_close(ref, got)
    # the boundaries as a tuple of ints, as the paged decode state holds
    # them, give the same result
    _assert_close(ref, _port(x, cu=tuple(x["cu"].tolist())))


@pytest.mark.parametrize("mode", ["prefill", "chunk"])
def test_uneven_packing_attends_sequence_by_sequence(mode):
    _assert_close(*_both(_attention_inputs(mode, 2, 4, seed=1,
                                           lens=[5, 7])))


@pytest.mark.parametrize("rope_rows", [64, 12], ids=["table", "rope_clamp"])
def test_clamped_indices_match_the_jax_package(rope_rows):
    # rows past the block table write into its last page (the JAX gather
    # clamps the block index), two of them at the same offset as an
    # earlier row of the same call; with 12 RoPE rows, positions 12-37 also
    # take the table's last row
    x = _attention_inputs("chunk", 2, 4, seed=2, past_capacity=True,
                          lens=[8])
    _assert_close(*_both(x, rope_rows=rope_rows))


@pytest.mark.parametrize("kw,text", [
    (dict(cache_k_quant_scales=np.ones(2, np.float32)), "all four"),
    (dict(use_dynamic_cachekv_quant=True), "non-int8"),
    (dict(compute_dynamic_scales=True), "requires"),
], ids=["static", "dynamic", "compute"])
def test_int8_pages_raise(kw, text):
    """Int8 arguments on float pools break the scale contract: the JAX
    package's ValueError, with its text (the int8 pages themselves are held
    to the JAX function in tests/test_torch_quant_serving.py)."""
    x = _attention_inputs("decode", 1, 4)
    t = torch.from_numpy
    kw = {k: t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    with pytest.raises(ValueError, match=text):
        block_gqa_attention(t(x["q"]), t(x["k"]), t(x["v"]), t(x["kc"]),
                            t(x["vc"]), t(x["enc"]), t(x["dec"]),
                            t(x["this"]), t(x["cu"]), t(x["bt"]), **kw)
