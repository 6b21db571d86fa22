"""The shared incremental-decode driver (counterpart of
``paddle_tpu/models/gpt.py`` ``_generate_loop`` and ``_resolve_s_max``).

Greedy only: sampling and beam search are not ported yet.
"""
from __future__ import annotations

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
