"""The shared incremental-decode driver and the host token pick
(counterparts of ``paddle_tpu/models/gpt.py`` ``_generate_loop``,
``_resolve_s_max`` and ``_select_token``).

``generate_loop`` is greedy only: sampling in ``generate`` and beam search
are not ported yet. ``select_token`` (greedy or sampled, on the host) is
what the serving batcher picks with.
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
