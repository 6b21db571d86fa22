"""Decode attention for serving (counterpart of
``paddle_tpu/incubate/nn/functional/decode_attention.py``:
``masked_multihead_attention``, ``_token_timeline``, ``_scatter_paged``,
``_gather_paged``, ``block_multihead_attention`` and
``block_gqa_attention``).

``masked_multihead_attention`` is one token a sequence over a dense cache
``[2, B, H, S_max, D]`` (GPT-2's decode step); the Llama decode step shares
its body (``dense_decode``). The paged functions work on a pool of
physical pages ``[n_pages, KV, block_size, D]`` per layer; a block table
``[B, blocks_per_seq]`` maps each sequence's logical blocks onto pool rows.
A call writes every packed token's K/V row at its timeline position
(``dec + local``) through the block table, then attends each token over
its sequence's gathered timeline. ``block_multihead_attention`` (GPT-2's
fused ``qkv``, one K/V head a head) is ``block_gqa_attention`` with groups
of one. All of this is XLA code in the JAX package, so it is plain
PyTorch here, not the stand-in for a kernel.

Differences from the JAX package, same results:

- The caches and pools are written in place and the same tensors are
  returned (the JAX package returns new arrays).
- Scores, softmax and P V run in float32 (the JAX package scores in the
  inputs' type and softmaxes in float32: the same for float32 inputs).
- Paged attention is computed per sequence (``[B, KV, rep * s, S_kv]``
  scores), never over per-token copies of the timeline (the JAX code
  gathers ``[T, KV, S_kv, D]``, 8.6 GB for K alone at a 512-token
  admission of a 7B model with s_max 1024).
- JAX clamps an out-of-range gather index; here the two clamps the path
  relies on are explicit: the block index ``pos // block_size`` at
  ``blocks_per_seq - 1`` (pad rows past a sequence's capacity) and the RoPE
  position at the table's last row.

Not ported: the int8 pools (static and dynamic scales, ROADMAP queue 1,
item 3), any of whose arguments raises ``NotImplementedError``; the decode
RoPE table and additive masks of the two GPT-2-style functions
(``rotary_tensor``, ``src_mask``; ``rope_emb``, ``mask``, ``tgt_mask``:
ROADMAP queue 3, item 3), which raise too.
"""
from __future__ import annotations

import torch

__all__ = ["block_gqa_attention", "block_multihead_attention",
           "masked_multihead_attention"]

_NEG = -1e9


def _tokens_per_seq(cu, bsz, token_num):
    """The packing's one length when every sequence holds the same number
    of tokens (``cu == arange(B + 1) * s``), else None."""
    lens = {b - a for a, b in zip(cu, cu[1:])}
    if cu[0] == 0 and len(cu) == bsz + 1 and len(lens) == 1 \
            and cu[-1] == token_num and token_num > 0:
        return lens.pop()
    return None


def _token_timeline(cu, s, dec, token_num):
    """Map packed-token index -> (sequence, kv-timeline row), both int64
    ``[T]``, from the host's sequence boundaries ``cu`` (ints) and their
    uniform length ``s`` (or None). Decode appends after the existing
    prefix (dec), prefill starts at 0 (dec is 0 in encoder mode). Uniform
    packing copies nothing to the device."""
    tok = torch.arange(token_num, device=dec.device)
    if s is not None:
        seq_of = tok // s
        local = tok - seq_of * s
    else:
        cu_d = torch.tensor(cu, device=dec.device)
        seq_of = (torch.searchsorted(cu_d, tok, right=True) - 1).clamp(
            0, dec.shape[0] - 1)
        local = tok - cu_d[seq_of]
    return seq_of, dec[seq_of] + local


def _scatter_paged(kc, vc, bt, seq_of, pos, kt, vt, block_size):
    """Write each token's k/v row at (block_tables[seq, pos // bs],
    pos % bs), in place. The block index is clamped to the table's last
    column, as the JAX gather clamps it."""
    blk = (pos // block_size).clamp(max=bt.shape[1] - 1)
    phys = bt[seq_of, blk]
    off = pos % block_size
    kc[phys, :, off] = kt.to(kc.dtype)
    vc[phys, :, off] = vt.to(vc.dtype)


def _gather_paged(pool, bt):
    """Every sequence's timeline from its pages, in float32:
    ``[B, heads, blocks_per_seq * block_size, D]``: one gather of whole
    pages, then one copy that moves the head axis and casts. (Gathering
    from a view with the head axis first, to cast a contiguous tensor,
    was slower on the card: PERF.md.)"""
    bsz, bps = bt.shape
    heads, bs_, hd = pool.shape[1:]
    pages = pool[bt.reshape(-1)].view(bsz, bps, heads, bs_, hd)
    out = torch.empty(bsz, heads, bps, bs_, hd, dtype=torch.float32,
                      device=pool.device)
    out.copy_(pages.transpose(1, 2))
    return out.view(bsz, heads, bps * bs_, hd)


def _attend(q, gk, gv, pos, kv_len):
    """Grouped attention of ``s`` tokens of each of B sequences over their
    timelines. q ``[B, s, H, D]``; gk/gv ``[B, KV, S_kv, D]`` float32;
    pos ``[B, s]`` each token's timeline row; kv_len ``[B]``. Scores and
    P V in float32; returns ``[B, s, H * D]`` float32."""
    b, s, nh, hd = q.shape
    kvh, s_kv = gk.shape[1], gk.shape[2]
    rep = nh // kvh
    qg = q.float().view(b, s, kvh, rep, hd).permute(0, 2, 3, 1, 4)
    qg = qg.reshape(b, kvh, rep * s, hd)
    scale = 1.0 / float(hd) ** 0.5
    scores = torch.matmul(qg, gk.transpose(-1, -2)) * scale
    scores = scores.view(b, kvh, rep, s, s_kv)
    kv_pos = torch.arange(s_kv, device=q.device)
    ok = (kv_pos <= pos[:, None, None, :, None]) \
        & (kv_pos < kv_len[:, None, None, None, None])
    probs = torch.softmax(scores.masked_fill(~ok, _NEG), dim=-1)
    out = torch.matmul(probs.view(b, kvh, rep * s, s_kv), gv)
    out = out.view(b, kvh, rep, s, hd).permute(0, 3, 1, 2, 4)
    return out.reshape(b, s, nh * hd)


def _rope(u, cos_t, sin_t):
    """Rotate interleaved (even, odd) pairs of u ``[T, heads, D]`` in float32
    by per-token tables ``[T, D/2]``; cast back to u's type."""
    uf = u.float()
    u1, u2 = uf[..., 0::2], uf[..., 1::2]
    c, s = cos_t[:, None, :], sin_t[:, None, :]
    return torch.stack([u1 * c - u2 * s, u2 * c + u1 * s],
                       dim=-1).view(u.shape).to(u.dtype)


def _flat_ints(x, device):
    return torch.as_tensor(x, device=device).reshape(-1).long()


def _not_ported(what, names):
    raise NotImplementedError(
        f"{what}: {', '.join(names)} not ported yet (ROADMAP, queue 3, "
        "item 3)")


def dense_decode(q, k, v, cache_k, cache_v, t):
    """One token a sequence over a dense cache: write k/v ``[B, KV, D]`` at
    row ``t`` ``[B]`` of cache_k/cache_v ``[B, KV, S_max, D]`` in place,
    then attend q ``[B, H, D]`` (H a multiple of KV: grouped heads) over
    the rows at or before t, in float32. Returns ``[B, H * D]`` in q's
    type."""
    b, h, d = q.shape
    kvh, s_max = cache_k.shape[1], cache_k.shape[2]
    b_idx = torch.arange(b, device=q.device)
    cache_k[b_idx, :, t] = k.to(cache_k.dtype)
    cache_v[b_idx, :, t] = v.to(cache_v.dtype)
    qg = q.reshape(b, kvh, h // kvh, d).float()
    scores = torch.einsum("bgrd,bgsd->bgrs", qg, cache_k.float()) \
        * (1.0 / d ** 0.5)
    pos = torch.arange(s_max, device=q.device)
    scores = torch.where(pos <= t[:, None, None, None], scores, _NEG)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bgrs,bgsd->bgrd", probs, cache_v.float())
    return ctx.reshape(b, h * d).to(q.dtype)


def masked_multihead_attention(x, cache_kv=None, bias=None, src_mask=None,
                               cum_offsets=None, sequence_lengths=None,
                               rotary_tensor=None, beam_cache_offset=None,
                               qkv_out_scale=None, out_shift=None,
                               out_smooth=None, seq_len=1, rotary_emb_dims=0,
                               use_neox_rotary_style=False,
                               compute_dtype="default", out_scale=-1,
                               quant_round_type=1, quant_max_bound=127.0,
                               quant_min_bound=-127.0):
    """One-token decode attention over a dense KV cache.

    x: ``[B, 3 * H * D]``, this step's fused qkv (split as ``(3, H, D)``),
    plus ``bias`` (``[3, H, D]`` or flat) when given. cache_kv:
    ``[2, B, H, S_max, D]``; row ``sequence_lengths`` (``[B, 1]``, default
    0) of each sequence is written in place, and each sequence attends to
    its rows at or before it. Returns ``(out [B, H * D], cache_kv)``, the
    cache the one given. The arguments the JAX function ignores are
    ignored here too; its quantized path raises as it does, and the decode
    RoPE table (``rotary_tensor``) and ``src_mask`` are not ported."""
    if qkv_out_scale is not None or out_scale != -1:
        raise NotImplementedError(
            "quantized decode path: use paddle_tpu.quantization")
    if src_mask is not None or (rotary_tensor is not None
                                and rotary_emb_dims > 0):
        _not_ported("masked_multihead_attention",
                    ["src_mask", "rotary_tensor"])
    if cache_kv is None:
        raise ValueError("cache_kv is required")
    _, bsz, nh, _, hd = cache_kv.shape
    qkv = x.reshape(bsz, 3, nh, hd)
    if bias is not None:
        qkv = qkv + bias.reshape(1, 3, nh, hd)
    if sequence_lengths is not None:
        t = sequence_lengths.reshape(bsz).long()
    else:
        t = torch.zeros(bsz, dtype=torch.long, device=x.device)
    out = dense_decode(qkv[:, 0], qkv[:, 1], qkv[:, 2], cache_kv[0],
                       cache_kv[1], t)
    return out, cache_kv


def block_gqa_attention(q, k, v, key_cache, value_cache, seq_lens_encoder,
                        seq_lens_decoder, seq_lens_this_time, cu_seqlens_q,
                        block_tables, block_size=64, rope_cos=None,
                        rope_sin=None, cache_k_quant_scales=None,
                        cache_v_quant_scales=None,
                        cache_k_dequant_scales=None,
                        cache_v_dequant_scales=None,
                        use_dynamic_cachekv_quant=False,
                        compute_dynamic_scales=False,
                        dynamic_scale_valid=None):
    """Paged-KV attention with unexpanded grouped-query heads.

    q: ``[T, H, D]``; k/v: ``[T, KV, D]``, packed unpadded tokens with
    sequence boundaries in cu_seqlens_q ``[B + 1]``. key_cache/value_cache:
    ``[n_pages, KV, block_size, D]`` (the block size is the pools'; the
    ``block_size`` argument is kept for the JAX signature). block_tables:
    ``[B, blocks_per_seq]``. Per sequence: prefill when
    ``seq_lens_encoder[i] > 0`` (timeline from 0, ``enc`` rows valid), else
    append at ``seq_lens_decoder[i]`` (``dec + this`` rows valid).

    rope_cos/rope_sin: optional ``[S, D/2]`` tables; q and k are rotated
    (interleaved pairs, float32) at each token's timeline position before
    the cache write. A token attends to the timeline rows at or before its
    own position and below its sequence's valid length, in float32; the
    output is cast back to q's type.

    cu_seqlens_q is read on the host: a CPU tensor or a sequence of ints
    costs nothing, a tensor on the card a sync (which a CUDA graph cannot
    capture). Sequences of one length are attended together, uneven ones
    one at a time.

    Writes the pools in place. Returns ``(out [T, H * D], key_cache,
    value_cache)``, the last two the pools given.
    """
    if any(a is not None for a in (cache_k_quant_scales,
                                   cache_v_quant_scales,
                                   cache_k_dequant_scales,
                                   cache_v_dequant_scales,
                                   dynamic_scale_valid)) \
            or use_dynamic_cachekv_quant or compute_dynamic_scales:
        raise NotImplementedError(
            "block_gqa_attention: int8 KV pages (static or dynamic scales) "
            "are not ported yet (ROADMAP, queue 1, item 3: int8 caches)")
    kc, vc = key_cache, value_cache
    device = kc.device
    enc = _flat_ints(seq_lens_encoder, device)
    dec = _flat_ints(seq_lens_decoder, device)
    this = _flat_ints(seq_lens_this_time, device)
    bt = torch.as_tensor(block_tables, device=device).long()
    bsz = bt.shape[0]
    kvh, bs_ = kc.shape[1], kc.shape[2]
    token_num, nh, hd = q.shape

    cu = torch.as_tensor(cu_seqlens_q).reshape(-1).tolist()
    s = _tokens_per_seq(cu, bsz, token_num)
    seq_of, pos = _token_timeline(cu, s, dec, token_num)

    if rope_cos is not None:
        p = pos.clamp(0, rope_cos.shape[0] - 1)
        cos_t, sin_t = rope_cos[p].float(), rope_sin[p].float()
        q, k = _rope(q, cos_t, sin_t), _rope(k, cos_t, sin_t)

    _scatter_paged(kc, vc, bt, seq_of, pos, k, v, bs_)
    kv_len = torch.where(enc > 0, enc, dec + this)
    gk, gv = _gather_paged(kc, bt), _gather_paged(vc, bt)

    if s is not None:
        out = _attend(q.view(bsz, s, nh, hd), gk, gv, pos.view(bsz, s),
                      kv_len).view(token_num, nh * hd)
    else:
        out = q.new_empty(token_num, nh * hd, dtype=torch.float32)
        for i, (a, b) in enumerate(zip(cu, cu[1:])):
            if b > a:
                out[a:b] = _attend(q[None, a:b], gk[i:i + 1], gv[i:i + 1],
                                   pos[None, a:b], kv_len[i:i + 1])[0]
    return out.to(q.dtype), kc, vc


def block_multihead_attention(qkv, key_cache, value_cache, seq_lens_encoder,
                              seq_lens_decoder, seq_lens_this_time,
                              padding_offsets, cum_offsets, cu_seqlens_q,
                              cu_seqlens_k, block_tables, pre_key_cache=None,
                              pre_value_cache=None, cache_k_quant_scales=None,
                              cache_v_quant_scales=None,
                              cache_k_dequant_scales=None,
                              cache_v_dequant_scales=None, qkv_out_scale=None,
                              qkv_bias=None, out_shift=None, out_smooth=None,
                              rope_emb=None, mask=None, tgt_mask=None,
                              max_seq_len=-1, block_size=64,
                              use_neox_style=False,
                              use_dynamic_cachekv_quant=False,
                              compute_dynamic_scales=False,
                              dynamic_scale_valid=None,
                              quant_round_type=1, quant_max_bound=127.0,
                              quant_min_bound=-127.0, out_scale=-1,
                              compute_dtype="default"):
    """Paged-KV attention over packed fused qkv (one K/V head a head).

    qkv: ``[T, 3 * H * D]`` packed unpadded tokens, split as ``(3, H, D)``
    (plus ``qkv_bias``, ``[3 * H * D]``, when given), sequence boundaries
    in cu_seqlens_q (read on the host, as ``block_gqa_attention`` reads
    them). key_cache/value_cache: ``[n_pages, H, block_size, D]``. The
    rest is ``block_gqa_attention``'s contract with groups of one, whose
    body this runs: prefill when ``seq_lens_encoder[i] > 0``, else append
    at ``seq_lens_decoder[i]``; the pools are written in place.

    Returns ``(out [T, H * D], qkv, key_cache, value_cache)``, the pools
    the ones given. The arguments the JAX function ignores are ignored here
    too (``padding_offsets``, ``cum_offsets``, ``cu_seqlens_k``, the
    ``pre_*`` caches); its quantized activations raise as it does; the int8
    pools raise as ``block_gqa_attention``'s do; ``rope_emb``, ``mask`` and
    ``tgt_mask`` are not ported."""
    if qkv_out_scale is not None or out_scale != -1:
        raise NotImplementedError(
            "quantized activation path: use paddle_tpu.quantization")
    if rope_emb is not None or mask is not None or tgt_mask is not None:
        _not_ported("block_multihead_attention",
                    ["rope_emb", "mask", "tgt_mask"])
    token_num = qkv.shape[0]
    nh, hd = key_cache.shape[1], key_cache.shape[3]
    qkv3 = qkv.reshape(token_num, 3, nh, hd)
    if qkv_bias is not None:
        qkv3 = qkv3 + qkv_bias.reshape(1, 3, nh, hd)
    out, kc, vc = block_gqa_attention(
        qkv3[:, 0], qkv3[:, 1], qkv3[:, 2], key_cache, value_cache,
        seq_lens_encoder, seq_lens_decoder, seq_lens_this_time,
        cu_seqlens_q, block_tables, block_size=block_size,
        cache_k_quant_scales=cache_k_quant_scales,
        cache_v_quant_scales=cache_v_quant_scales,
        cache_k_dequant_scales=cache_k_dequant_scales,
        cache_v_dequant_scales=cache_v_dequant_scales,
        use_dynamic_cachekv_quant=use_dynamic_cachekv_quant,
        compute_dynamic_scales=compute_dynamic_scales,
        dynamic_scale_valid=dynamic_scale_valid)
    return out, qkv, kc, vc
