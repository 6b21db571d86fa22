"""The shared incremental-decode drivers and the host token pick
(counterparts of ``paddle_tpu/models/gpt.py`` ``_generate_loop``,
``_beam_loop``, ``_resolve_s_max``, ``_select_token`` and the paged-state
helpers ``_paged_state``, ``_paged_prefill_impl``,
``_paged_generate_loop`` and ``_speculative_loop``), which GPT-2 and Llama
both drive.

``generate_loop`` picks greedily on the device or samples on the host
(``select_token``, also what the serving batchers pick with);
``beam_loop`` is beam search over the dense cache; ``paged_generate_loop``
is greedy over a paged cache; ``speculative_loop`` is greedy draft and
verify over two paged caches.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_s_max(config, s, max_new_tokens, s_max):
    """Default and validate the cache length: positions past the model's
    position table (GPT-2's learned ``wpe``, Llama's RoPE table) would
    index out of range, so refuse them."""
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
                  do_sample=False, temperature=1.0, top_k=0, top_p=None,
                  seed=None, eos_id=None, pad_id=None):
    """Prefill, then step and pick until the budget.

    Greedy selection is ``argmax`` over the last position (the first index
    of a tie) and stays on the device. ``do_sample`` reads each step's
    last-position logits to the host and draws with ``select_token``
    (temperature, top-k, top-p) from ``np.random.RandomState(seed)``, as
    the JAX package does, so the same logits and seed draw the same
    tokens. With ``eos_id``, a row that has emitted it emits ``pad_id``
    (default: eos_id) from then on, and the loop stops once every row has
    finished; that test is the one host sync per greedy step. Returns int64
    ids ``[B, S + max_new_tokens]``, right-padded with ``pad_id`` when
    every row finished early.
    """
    b = input_ids.shape[0]
    rng = np.random.RandomState(seed)
    if pad_id is None:
        pad_id = eos_id
    done = torch.zeros(b, 1, dtype=torch.bool, device=input_ids.device)

    def pick(logits):
        if not do_sample:
            return torch.argmax(logits[:, -1], dim=-1).reshape(b, 1)
        sel = select_token(logits[:, -1].float().cpu().numpy(), True,
                           temperature, top_k, top_p, rng)
        return torch.from_numpy(sel.reshape(b, 1)).to(input_ids.device)

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


def _log_softmax_host(logits):
    """Last-position log-probabilities of logits ``[B, 1, V]`` on the host,
    in float64."""
    x = logits[:, -1].float().cpu().numpy().astype(np.float64)
    x = x - x.max(-1, keepdims=True)
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


def beam_loop(prefill_fn, step_fn, input_ids, max_new_tokens, num_beams,
              length_penalty):
    """Beam search over a dense cache ``[L, 2, B, H, S_max, D]``.

    The prompt is prefilled once at batch B (``prefill_fn(ids)``), then
    the cache and the timelines fan out to B * W rows (the W beams of a
    row share the prompt's K/V), and every step reorders both by the
    source beams with ``index_select`` along the cache's batch axis (2),
    so one decode step at batch B * W serves every step. The W beams start
    at the prompt's W most likely tokens; log-probabilities are summed on
    the host in float64. No EOS: every beam runs the whole budget, and
    each row's best beam by summed log-prob / ``max_new_tokens **
    length_penalty`` wins. Returns int64 ids ``[B, S + max_new_tokens]``.
    """
    b = input_ids.shape[0]
    w = num_beams
    dev = input_ids.device
    logits, caches, t = prefill_fn(input_ids)
    v = logits.shape[-1]
    if w > v:
        raise ValueError(f"num_beams={w} exceeds vocab_size={v}: the "
                         f"seed step cannot pick {w} distinct tokens")
    rep = torch.arange(b, device=dev).repeat_interleave(w)
    caches = caches.index_select(2, rep)
    t = t.index_select(0, rep)
    lp0 = _log_softmax_host(logits)                      # [B, V]
    top0 = np.argsort(-lp0, axis=-1)[:, :w]              # [B, W]
    beam_scores = np.take_along_axis(lp0, top0, -1)      # [B, W]
    beam_tokens = [top0.reshape(b * w, 1)]               # [BW, 1] each
    for _ in range(1, max_new_tokens):
        tok = torch.from_numpy(beam_tokens[-1]).to(dev)
        logits, caches, t = step_fn(tok.to(input_ids.dtype), caches, t)
        total = beam_scores[..., None] + _log_softmax_host(
            logits).reshape(b, w, v)                     # [B, W, V]
        flat = total.reshape(b, w * v)
        best = np.argsort(-flat, axis=-1)[:, :w]         # [B, W]
        beam_scores = np.take_along_axis(flat, best, -1)
        # every beam-carrying structure follows its source beam
        gather = (np.arange(b)[:, None] * w + best // v).reshape(-1)
        gidx = torch.from_numpy(gather).to(dev)
        caches = caches.index_select(2, gidx)
        t = t.index_select(0, gidx)
        beam_tokens = [tk[gather] for tk in beam_tokens]
        beam_tokens.append((best % v).reshape(b * w, 1))
    denom = max_new_tokens ** length_penalty if length_penalty else 1.0
    rows = np.arange(b) * w + (beam_scores / denom).argmax(-1)
    gen = np.concatenate([tk[rows] for tk in beam_tokens], axis=1)
    return torch.cat([input_ids.long(), torch.from_numpy(gen).to(dev)],
                     dim=1)


def generate(model, input_ids, max_new_tokens, s_max=None, decode_fn=None,
             **pick):
    """A model's ``generate``: resolve the cache length, then
    ``generate_loop`` over its ``prefill`` and ``decode_step`` (or
    ``decode_fn``, a captured one for instance), ``pick`` its sampling
    and EOS arguments."""
    s_max = resolve_s_max(model.config, input_ids.shape[1], max_new_tokens,
                          s_max)
    step = decode_fn if decode_fn is not None else model.decode_step
    return generate_loop(lambda: model.prefill(input_ids, s_max), step,
                         input_ids, max_new_tokens, **pick)


def generate_beam(model, input_ids, max_new_tokens, num_beams, s_max,
                  decode_fn, length_penalty):
    """A model's ``generate_beam``: ``beam_loop`` over its ``prefill`` and
    ``decode_step`` (or ``decode_fn``)."""
    s_max = resolve_s_max(model.config, input_ids.shape[1], max_new_tokens,
                          s_max)
    step = decode_fn if decode_fn is not None else model.decode_step
    return beam_loop(lambda ids: model.prefill(ids, s_max), step, input_ids,
                     max_new_tokens, num_beams, length_penalty)


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
    """Greedy decode over a paged cache: validate the capacity (positions
    past the model's position table, learned or RoPE, would be clamped
    and corrupt pages), prefill,
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
        # past the position table (GPT-2's wpe, Llama's RoPE) the
        # positions would clamp and corrupt pages
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


def speculative_loop(target, draft, input_ids, max_new_tokens, draft_k,
                     block_size, eos_id, compile, return_stats):
    """Greedy speculative decoding over the paged cache, one sequence.

    The draft proposes ``draft_k`` tokens a round, one at a time; the
    target scores the pending token and all proposals in one pass
    (``paged_prefill_into(logits_all=True)``), accepts the longest prefix
    that matches its own greedy picks and adds its own next pick. So a
    target pass gives 1 to draft_k + 1 tokens and the output is the
    target's greedy sequence exactly. A rejection costs nothing to undo:
    the host owns each timeline's length, attention reads no row past it,
    and the next append overwrites the stale rows. Any draft that shares
    the target's vocabulary works, across families.

    With ``compile=True`` the target step, the draft step, the verify and
    the draft's catch-up are CUDA graphs (``jit.to_static``, the pools
    donated): one capture a width (the verify's k + 1, the catch-up's 1
    or 2). Returns int64 ids ``[1, L + n]`` on the ids' device and, with
    ``return_stats``, a dict of ``rounds``, ``proposed``, ``matched``,
    ``acceptance_rate`` and ``tokens_per_target_dispatch``.
    """
    if input_ids.shape[0] != 1:
        raise ValueError("speculative decoding is single-sequence "
                         "(batch it at the serving layer)")
    if draft_k < 1:
        raise ValueError("draft_k must be >= 1")
    if draft.config.vocab_size != target.config.vocab_size:
        raise ValueError(
            f"draft vocab {draft.config.vocab_size} != target vocab "
            f"{target.config.vocab_size}")
    _, L = input_ids.shape
    dev = input_ids.device
    if max_new_tokens <= 0:
        # generate(ids, 0) returns the prompt unchanged: match it
        out = input_ids.long().clone()
        if not return_stats:
            return out
        return out, {"rounds": 0, "proposed": 0, "matched": 0,
                     "acceptance_rate": 0.0,
                     "tokens_per_target_dispatch": 0.0}
    needed = L + max_new_tokens
    for m, who in ((target, "target"), (draft, "draft")):
        if needed > m.config.max_position_embeddings:
            raise ValueError(
                f"prompt {L} + {max_new_tokens} exceeds the {who}'s "
                f"max_position_embeddings="
                f"{m.config.max_position_embeddings}")
    if compile and dev.type != "cuda":
        raise ValueError(
            "generate_paged_speculative(compile=True) captures its steps as "
            f"CUDA graphs, which needs the models on the card (the ids are "
            f"on {dev}); pass compile=False to run them eagerly")
    bps = -(-needed // block_size)

    def ids(values):
        return torch.tensor([values], dtype=torch.int64, device=dev)

    def token(value):
        return torch.tensor([value], dtype=torch.int64, device=dev)

    def ints(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    def verify_body(ids_, layers, bt, dec):
        return target.paged_prefill_into(ids_, layers, bt, block_size,
                                         dec_base=dec, logits_all=True)

    def catchup_body(ids_, layers, bt, dec, at):
        # the draft's append of 1 token after a rejection, 2 after a round
        # it matched in full (see d_rows below); the last position's logits
        # are the first proposal
        return draft.paged_prefill_into(ids_, layers, bt, block_size,
                                        dec_base=dec, logits_at=at)

    t_step, d_step = target.paged_decode_step, draft.paged_decode_step
    verify, catchup = verify_body, catchup_body
    if compile:
        from ..jit import to_static
        t_step = to_static(t_step, donate_args=(1,))
        d_step = to_static(d_step, donate_args=(1,))
        verify = to_static(verify, donate_args=(1,))
        catchup = to_static(catchup, donate_args=(1,))

    def pick(logits):
        return int(torch.argmax(logits[0]))

    with torch.no_grad():
        t_logits, t_state = target.paged_prefill(input_ids, block_size, bps)
        _, d_state = draft.paged_prefill(input_ids, block_size, bps)
        # the target's pool holds rows for prompt + accepted[:-1]
        # (accepted[-1] is pending, the next input); the draft's holds
        # correct rows for the first d_rows positions of prompt + accepted.
        # After a round it matched in full it is one row short (the last
        # proposal was never fed back), so each round starts by appending
        # accepted[d_rows - L:] to the draft: 1 token after a rejection, 2
        # after a full match, whose last logits are proposal 1
        accepted = [pick(t_logits)]
        d_rows = L
        rounds = proposed = matched = 0
        while True:
            if eos_id is not None and eos_id in accepted:
                accepted = accepted[:accepted.index(eos_id) + 1]
                break
            remaining = max_new_tokens - len(accepted)
            if remaining <= 0:
                break
            valid = L + len(accepted) - 1
            k = min(draft_k, remaining - 1)
            if k == 0:
                # budget for exactly one more: a plain target step
                t_state["dec_lens"].fill_(valid)
                lg, _ = t_step(token(accepted[-1]), t_state)
                accepted.append(pick(lg))
                continue
            cu = accepted[d_rows - L:]
            dl, _ = catchup(ids(cu), d_state["layers"],
                            d_state["block_tables"], ints([d_rows]),
                            ints([len(cu) - 1]))
            d_rows += len(cu)
            tok = pick(dl)
            props = [tok]
            # k - 1 draft steps propose the rest
            for i in range(k - 1):
                d_state["dec_lens"].fill_(d_rows + i)
                dl, _ = d_step(token(tok), d_state)
                tok = pick(dl)
                props.append(tok)
            d_rows += k - 1                  # rows of props[:k-1]
            vlogits, _ = verify(ids([accepted[-1]] + props),
                                t_state["layers"], t_state["block_tables"],
                                ints([valid]))
            g = torch.argmax(vlogits[0], dim=-1).tolist()      # [k + 1]
            j = 0
            while j < k and props[j] == g[j]:
                j += 1
            accepted += props[:j] + [g[j]]
            rounds += 1
            proposed += k
            matched += j
            # the draft's rows hold at most prompt + accepted[:-1] (a
            # rejected proposal's row is stale); a full match leaves it one
            # short of even that
            d_rows = min(d_rows, L + len(accepted) - 1)
    if eos_id is not None and eos_id in accepted:
        accepted = accepted[:accepted.index(eos_id) + 1]
    out = torch.cat([input_ids.reshape(-1).long(),
                     torch.tensor(accepted, dtype=torch.int64,
                                  device=dev)])[None]
    if not return_stats:
        return out
    return out, {
        "rounds": rounds, "proposed": proposed, "matched": matched,
        "acceptance_rate": matched / max(proposed, 1),
        "tokens_per_target_dispatch":
            len(accepted) / max(rounds, 1) if rounds else 1.0,
    }
