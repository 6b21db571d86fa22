"""The shared incremental-decode loops and the host token pick
(counterparts of ``paddle_tpu/models/gpt.py`` ``_generate_loop``,
``_resolve_s_max``, ``_select_token`` and the paged-state helpers
``_paged_state``, ``_paged_prefill_impl`` and ``_paged_generate_loop``).

``generate_loop`` and ``paged_generate_loop`` are greedy only: sampling in
``generate`` and beam search are not ported yet. ``select_token`` (greedy
or sampled, on the host) is what the serving batchers pick with.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_s_max(config, s, max_new_tokens, s_max):
    """Default and validate the cache length: positions past the RoPE table
    would index out of range, so refuse them."""
    if s_max is None:
        s_max = min(config.max_position_embeddings, s + max_new_tokens)
    if s_max > config.max_position_embeddings:
        raise ValueError(
            f"s_max={s_max} exceeds max_position_embeddings="
            f"{config.max_position_embeddings}")
    if s + max_new_tokens > s_max:
        raise ValueError(f"s_max={s_max} too small for prompt {s} + "
                         f"{max_new_tokens} new tokens")
    return s_max


def generate_loop(prefill_fn, step_fn, input_ids, max_new_tokens,
                  eos_id=None, pad_id=None):
    """Prefill, then step and pick greedily until the budget.

    Greedy selection is ``argmax`` over the last position (the first index
    of a tie) and stays on the device. With ``eos_id``, a row that has
    emitted it emits ``pad_id`` (default: eos_id) from then on, and the loop
    stops once every row has finished; that test is the one host sync per
    step. Returns int64 ids ``[B, S + max_new_tokens]``, right-padded with
    ``pad_id`` when every row finished early.
    """
    b = input_ids.shape[0]
    if pad_id is None:
        pad_id = eos_id
    done = torch.zeros(b, 1, dtype=torch.bool, device=input_ids.device)

    def pick(logits):
        return torch.argmax(logits[:, -1], dim=-1).reshape(b, 1)

    def apply_eos(tok):
        out = torch.where(done, torch.full_like(tok, pad_id), tok)
        done.logical_or_(out == eos_id)
        return out

    logits, caches, t = prefill_fn()
    toks = [input_ids]
    tok = pick(logits)
    if eos_id is not None:
        tok = apply_eos(tok)
    for i in range(max_new_tokens):
        toks.append(tok)
        if i + 1 == max_new_tokens or (eos_id is not None
                                       and bool(done.all())):
            break
        logits, caches, t = step_fn(tok.to(input_ids.dtype), caches, t)
        tok = pick(logits)
        if eos_id is not None:
            tok = apply_eos(tok)
    out = torch.cat([x.long() for x in toks], dim=1)
    short = max_new_tokens - (len(toks) - 1)
    if eos_id is not None and short > 0:
        out = torch.cat([out, out.new_full((b, short), pad_id)], dim=1)
    return out


def select_token(logits_np, do_sample, temperature, top_k, top_p, rng):
    """Next-token selection on host logits [B, V] (``np.random.RandomState``
    ``rng``): the JAX package's ``GPT2ForCausalLM._select_token`` verbatim,
    so the same logits and seed draw the same tokens.

    Greedy unless do_sample; sampling applies temperature, then top-k
    truncation, then nucleus (top-p) truncation, then draws from the
    renormalized distribution."""
    if not do_sample:
        return logits_np.argmax(-1)
    logits = logits_np.astype(np.float64) / max(temperature, 1e-6)
    out = np.empty(logits.shape[0], np.int64)
    for b in range(logits.shape[0]):
        row = logits[b]
        if top_k and 0 < top_k < row.shape[-1]:
            kth = np.partition(row, -top_k)[-top_k]
            row = np.where(row < kth, -np.inf, row)
        probs = np.exp(row - row.max())
        probs /= probs.sum()
        if top_p is not None and 0 < top_p < 1.0:
            order = np.argsort(-probs)
            csum = np.cumsum(probs[order])
            # keep the smallest prefix reaching top_p (always >= 1)
            cutoff = int(np.searchsorted(csum, top_p) + 1)
            keep = order[:cutoff]
            mask = np.zeros_like(probs, bool)
            mask[keep] = True
            probs = np.where(mask, probs, 0.0)
            probs /= probs.sum()
        out[b] = rng.choice(probs.shape[-1], p=probs)
    return out


def paged_state(layers_state, bt, b, s, block_size, blocks_per_seq):
    """The shared paged-decode state: the per-layer ``(kc, vc)`` pools, the
    block table, each sequence's timeline length (``dec_lens``), the block
    size and capacity (Python ints), and the batch-size-only constants the
    decode step passes to the attention, built once: ``cu_b``, the packing
    of one token a sequence, is a tuple of ints, since the attention reads
    it on the host (a captured step keys it by value)."""
    def ints(fill):
        return torch.full((b,), fill, dtype=torch.int32, device=bt.device)
    return {"layers": layers_state, "block_tables": bt,
            "dec_lens": ints(s), "block_size": block_size,
            "capacity": blocks_per_seq * block_size,
            "zeros_b": ints(0), "ones_b": ints(1),
            "cu_b": tuple(range(b + 1))}


def paged_prefill_impl(model, input_ids, block_size, blocks_per_seq):
    """Prefill into a fresh pool: ``blocks_per_seq`` pages a sequence
    (default: enough for ``max_position_embeddings``), an identity block
    table, the model's pool-writing prefill, the state dict."""
    b, s = input_ids.shape
    if blocks_per_seq is None:
        blocks_per_seq = -(-model.config.max_position_embeddings
                           // block_size)
    n_blocks = b * blocks_per_seq
    bt = torch.arange(n_blocks, dtype=torch.int32,
                      device=input_ids.device).view(b, blocks_per_seq)
    layers = model.paged_alloc(n_blocks, block_size)
    logits, layers_state = model.paged_prefill_into(input_ids, layers, bt,
                                                    block_size)
    return logits, paged_state(layers_state, bt, b, s, block_size,
                               blocks_per_seq)


def paged_generate_loop(model, input_ids, max_new_tokens, block_size,
                        blocks_per_seq, decode_fn):
    """Greedy decode over a paged cache: validate the capacity, prefill,
    then step ``decode_fn`` (default ``model.paged_decode_step``) and pick
    with ``argmax`` on the device. Returns int64 ids
    ``[B, S + max_new_tokens]``.

    The state's tensors stay the same across steps: each step's new
    ``dec_lens`` is copied into the state's own, so a step captured as a
    CUDA graph with the state donated (``jit.to_static(...,
    donate_args=(1,))``) is captured once."""
    b, s = input_ids.shape
    needed = s + max_new_tokens
    if needed > model.config.max_position_embeddings:
        # past the RoPE table the positions would clamp and corrupt pages
        raise ValueError(
            f"prompt {s} + {max_new_tokens} new tokens exceeds "
            f"max_position_embeddings="
            f"{model.config.max_position_embeddings}")
    if blocks_per_seq is None:
        blocks_per_seq = -(-needed // block_size)
    elif needed > blocks_per_seq * block_size:
        raise ValueError(
            f"paged cache capacity {blocks_per_seq * block_size} too "
            f"small for prompt {s} + {max_new_tokens} new tokens")
    logits, state = model.paged_prefill(input_ids, block_size,
                                        blocks_per_seq)
    step = decode_fn if decode_fn is not None else model.paged_decode_step
    toks = [input_ids]
    tok = torch.argmax(logits, dim=-1)
    for i in range(max_new_tokens):
        toks.append(tok.view(b, 1))
        if i + 1 == max_new_tokens:
            break
        logits, new_state = step(tok.to(input_ids.dtype), state)
        state["dec_lens"].copy_(new_state["dec_lens"])
        tok = torch.argmax(logits, dim=-1)
    return torch.cat([x.long() for x in toks], dim=1)
