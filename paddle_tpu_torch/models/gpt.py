"""GPT-2: training (``forward(input_ids, labels=)``) with dropout on the
embeddings, the residual branches and the attention probabilities.

Counterpart of ``paddle_tpu/models/gpt.py`` (``GPT2Config`` through
``GPT2ForCausalLM.forward``): pre-norm blocks, learned positions, the
tanh-GELU MLP, a fused ``c_attn`` projection split into q, k and v, and
the LM head tied to ``wte``. Full-sequence attention runs the flash
kernels (forward and backward, with their in-kernel dropout) when the
model lies on the card; LayerNorm, GELU and the residual dropouts are
plain PyTorch, as they were XLA code in the JAX package.

Randomness comes from two generators the model owns, both seeded from its
``seed``: a CPU generator that gives each attention call its int32 seed
(the kernels' hash mask; no device sync), and one on the model's device
for the ``Dropout`` masks. Torch's CPU and CUDA generators draw different
numbers from one seed, but the attention mask is the same hash on both.

Serving (``paddle_tpu/models/gpt.py:64-770, 954-990``): ``prefill(n_valid=)``
and ``decode_step`` over a dense cache ``[L, 2, B, H, s_max, D]``
(``masked_multihead_attention``), ``generate`` (greedy or sampled) and
``generate_beam`` through the drivers Llama shares
(``models/generation.py``), and the paged route (``paged_alloc``,
``paged_prefill_into``, ``paged_prefill``, ``paged_decode_step``,
``paged_fused_step``, ``generate_paged``) over
``block_multihead_attention``: what both batchers
(``inference/serving.py``) drive. The prefill's attention runs the flash
forward on the card; the decode attention is plain PyTorch, as it was XLA
code in the JAX package. Serving applies dropout as the JAX package does,
only while the model trains: serve in eval mode, where nothing draws from
the model's generators. Positions past the ``wpe`` table are clamped to
its last row where the JAX package's gather clamps them (chunk pad rows,
decode past the table). Not ported yet: int8 caches, speculative decode
(``logits_all``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
from torch import nn

from ..device import default_device, to_torch_dtype
from ..incubate.nn.functional.decode_attention import (
    block_multihead_attention, masked_multihead_attention)
from ..nn import functional as F
from ..nn.layers import Dropout, Embedding, LayerNorm, Linear
from . import generation
from .generation import paged_generate_loop, paged_prefill_impl


@dataclass
class GPT2Config:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    layer_norm_epsilon: float = 1e-5
    dropout: float = 0.1
    initializer_range: float = 0.02
    tie_word_embeddings: bool = True
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def gpt2_124m_config(**overrides) -> GPT2Config:
    """GPT-2 124M (hidden 768, 12 layers, 12 heads x 64, vocab 50257)."""
    return dataclasses.replace(GPT2Config(), **overrides)


class GPT2Attention(nn.Module):
    def __init__(self, config: GPT2Config, seeds, generator, *, device,
                 dtype):
        super().__init__()
        e = config.hidden_size
        kw = dict(bias=True, device=device, dtype=dtype)
        self.c_attn = Linear(e, 3 * e, **kw)
        self.c_proj = Linear(e, e, **kw)
        self.resid_dropout = Dropout(config.dropout, generator)
        self.config = config
        self.seeds = seeds

    def forward(self, hidden, return_kv=False):
        """Causal self-attention over [B, S, E]; with ``return_kv`` also
        this call's K and V in the decode cache's layout [B, H, S, D]."""
        b, s, _ = hidden.shape
        h, d = self.config.num_attention_heads, self.config.head_dim
        # strided views of one projection: the attention copies them to the
        # kernels' layout
        q, k, v = self.c_attn(hidden).view(b, s, 3, h, d).unbind(2)
        out = F.scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=self.config.dropout,
            training=self.training, generator=self.seeds)
        out = self.resid_dropout(self.c_proj(out.reshape(b, s, h * d)))
        if return_kv:
            return out, k.transpose(1, 2), v.transpose(1, 2)
        return out


class GPT2MLP(nn.Module):
    def __init__(self, config: GPT2Config, generator, *, device, dtype):
        super().__init__()
        e, i = config.hidden_size, config.intermediate_size
        kw = dict(bias=True, device=device, dtype=dtype)
        self.c_fc = Linear(e, i, **kw)
        self.c_proj = Linear(i, e, **kw)
        self.dropout = Dropout(config.dropout, generator)

    def forward(self, x):
        return self.dropout(self.c_proj(F.gelu(self.c_fc(x),
                                               approximate=True)))


class GPT2Block(nn.Module):
    def __init__(self, config: GPT2Config, seeds, generator, *, device,
                 dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        eps = config.layer_norm_epsilon
        self.ln_1 = LayerNorm(config.hidden_size, eps, **kw)
        self.attn = GPT2Attention(config, seeds, generator, **kw)
        self.ln_2 = LayerNorm(config.hidden_size, eps, **kw)
        self.mlp = GPT2MLP(config, generator, **kw)

    def forward(self, hidden):
        hidden = hidden + self.attn(self.ln_1(hidden))
        return hidden + self.mlp(self.ln_2(hidden))

    def forward_kv(self, hidden):
        """Prefill: the dense causal block plus this layer's K/V
        ([B, H, S, D]) for the decode cache."""
        attn_out, k, v = self.attn(self.ln_1(hidden), return_kv=True)
        hidden = hidden + attn_out
        return hidden + self.mlp(self.ln_2(hidden)), k, v

    def decode(self, hidden, cache_kv, t):
        """One-token decode. hidden [B, 1, E]; cache_kv [2, B, H, S_max, D],
        row t written in place; t [B, 1]. Returns hidden'."""
        b = hidden.shape[0]
        qkv = self.attn.c_attn(self.ln_1(hidden).reshape(b, -1))
        out, _ = masked_multihead_attention(qkv, cache_kv,
                                            sequence_lengths=t)
        hidden = hidden + self.attn.resid_dropout(
            self.attn.c_proj(out.reshape(b, 1, -1)))
        return hidden + self.mlp(self.ln_2(hidden))

    def paged(self, hidden, kc, vc, enc, dec, this, cu, bt, block_size):
        """One block over packed tokens [T, E] through a page pool:
        ``block_multihead_attention`` (the pools written in place; ``cu``
        the packing, read on the host), then the MLP. Returns hidden'."""
        out, _, _, _ = block_multihead_attention(
            self.attn.c_attn(self.ln_1(hidden)), kc, vc, enc, dec, this,
            None, None, cu, cu, bt, block_size=block_size)
        hidden = hidden + self.attn.resid_dropout(self.attn.c_proj(out))
        return hidden + self.mlp(self.ln_2(hidden))


class GPT2Model(nn.Module):
    def __init__(self, config: GPT2Config, seeds, generator, *, device,
                 dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.config = config
        self.wte = Embedding(config.vocab_size, config.hidden_size, **kw)
        self.wpe = Embedding(config.max_position_embeddings,
                             config.hidden_size, **kw)
        self.drop = Dropout(config.dropout, generator)
        self.h = nn.ModuleList(GPT2Block(config, seeds, generator, **kw)
                               for _ in range(config.num_hidden_layers))
        self.ln_f = LayerNorm(config.hidden_size, config.layer_norm_epsilon,
                              **kw)

    def forward(self, input_ids):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)
        hidden = self.drop(self.wte(input_ids) + self.wpe(pos)[None])
        for block in self.h:
            hidden = block(hidden)
        return self.ln_f(hidden)

    def embed(self, ids, pos):
        """Token plus position embeddings, the positions clamped to the
        ``wpe`` table's last row (where the JAX package's gather clamps:
        pad rows of a chunk, a decode block past the table), then the
        embedding dropout."""
        pos = pos.clamp(0, self.config.max_position_embeddings - 1)
        return self.drop(self.wte(ids) + self.wpe(pos))

    def forward_prefill(self, input_ids, s_max):
        """Dense prompt pass that also fills the decode caches. Returns
        (hidden [B, S, E], caches [L, 2, B, H, s_max, D]), the caches zero
        past the prompt."""
        b, s = input_ids.shape
        if s > s_max:
            raise ValueError(f"prompt length {s} exceeds cache size {s_max}")
        cfg = self.config
        hidden = self.embed(input_ids,
                            torch.arange(s, device=input_ids.device))
        caches = hidden.new_zeros(len(self.h), 2, b, cfg.num_attention_heads,
                                  s_max, cfg.head_dim)
        for i, block in enumerate(self.h):
            hidden, k, v = block.forward_kv(hidden)
            caches[i, 0, :, :, :s] = k
            caches[i, 1, :, :, :s] = v
        return self.ln_f(hidden), caches


class GPT2ForCausalLM(nn.Module):
    """GPT-2 for training and serving. Runs on the current CUDA card unless
    ``device`` is given (the tests pass ``device="cpu"``); with no card and
    no device it raises. Weights are drawn from ``generator`` (default: one on the
    model's device seeded with 0) as N(0, initializer_range), biases zero,
    LayerNorms ones and zeros; load transferred weights with
    ``load_state_dict`` (``models.convert.gpt2_state_from_paddle_tpu``).
    ``seed`` seeds the model's two dropout generators."""

    def __init__(self, config: GPT2Config, device=None, generator=None,
                 seed=0):
        super().__init__()
        device = default_device(device)
        dtype = to_torch_dtype(config.dtype)
        self.config = config
        self.attention_seeds = torch.Generator().manual_seed(seed)
        self.dropout_generator = torch.Generator(device=device).manual_seed(
            seed)
        self.transformer = GPT2Model(config, self.attention_seeds,
                                     self.dropout_generator, device=device,
                                     dtype=dtype)
        self.lm_head = (None if config.tie_word_embeddings else
                        Linear(config.hidden_size, config.vocab_size,
                               device=device, dtype=dtype))
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        std = self.config.initializer_range
        for mod in self.modules():
            if isinstance(mod, (Linear, Embedding)):
                mod.weight.normal_(0.0, std, generator=generator)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

    def _logits(self, hidden):
        if self.lm_head is None:
            return F.linear(hidden, self.transformer.wte.weight)
        return self.lm_head(hidden)

    def forward(self, input_ids, labels=None):
        """Logits [B, S, V]; with ``labels`` [B, S] also the mean cross
        entropy over the labels that are not -100, on float32 logits, as
        ``(logits, loss)``. Labels are not shifted, as in the JAX
        package."""
        logits = self._logits(self.transformer(input_ids))
        if labels is None:
            return logits
        loss = F.cross_entropy(
            logits.reshape(-1, self.config.vocab_size).float(),
            labels.reshape(-1))
        return logits, loss

    # -- incremental (KV-cache) decode: the dense serving path ---------------

    @torch.no_grad()
    def prefill(self, input_ids, s_max, n_valid=None):
        """Prompt pass. Returns (last_logits [B, 1, V],
        caches [L, 2, B, H, s_max, D], t [B, 1] int32).

        ``n_valid`` ([B, 1] int, on the ids' device): the true prompt
        lengths when ``input_ids`` is right-padded onto a bucket ladder.
        The last hidden state is gathered at ``n_valid - 1`` and decode
        resumes at ``t = n_valid``. Causality keeps the pad rows out of
        every earlier position, and decode overwrites each pad cache row
        before any step can read it."""
        b, s = input_ids.shape
        hidden, caches = self.transformer.forward_prefill(input_ids, s_max)
        if n_valid is None:
            last = hidden[:, s - 1:s]
            t = torch.full((b, 1), s, dtype=torch.int32,
                           device=input_ids.device)
        else:
            idx = (n_valid.long() - 1).reshape(b, 1, 1).expand(
                b, 1, hidden.shape[-1])
            last = torch.gather(hidden, 1, idx)
            t = n_valid.to(torch.int32)
        return self._logits(last), caches, t

    @torch.no_grad()
    def decode_step(self, tok, caches, t):
        """One token through every layer's cache. tok [B, 1] int; caches
        [L, 2, B, H, S_max, D], updated in place at t; t [B, 1] int32.
        Nothing is read back to the host, so
        ``jit.to_static(model.decode_step, donate_args=(1,))`` serves every
        step with one CUDA graph. Returns (logits [B, 1, V], caches,
        t + 1)."""
        tr = self.transformer
        hidden = tr.embed(tok, t)                            # [B, 1, E]
        for i, block in enumerate(tr.h):
            hidden = block.decode(hidden, caches[i], t)
        return self._logits(tr.ln_f(hidden)), caches, t + 1

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens, s_max=None,
                 decode_fn=None, do_sample=False, temperature=1.0,
                 top_k=0, top_p=None, seed=None, eos_id=None, pad_id=None):
        """Incremental decode over the KV cache: greedy by default (the
        argmax on the device); ``do_sample`` draws on the host with
        temperature, top-k and top-p from ``seed``. With ``eos_id`` a row
        that emitted it continues with ``pad_id`` (default: eos_id), and
        the loop ends once every row has. ``decode_fn`` replaces
        ``decode_step`` (a captured one, for instance). Returns int64 ids
        [B, S + max_new_tokens]."""
        return generation.generate(
            self, input_ids, max_new_tokens, s_max, decode_fn,
            do_sample=do_sample, temperature=temperature, top_k=top_k,
            top_p=top_p, seed=seed, eos_id=eos_id, pad_id=pad_id)

    @torch.no_grad()
    def generate_beam(self, input_ids, max_new_tokens, num_beams=4,
                      s_max=None, decode_fn=None, length_penalty=0.0):
        """Beam search over the KV cache (``generation.beam_loop``).
        Returns the best beam per row, int64 [B, S + max_new_tokens]."""
        return generation.generate_beam(self, input_ids, max_new_tokens,
                                        num_beams, s_max, decode_fn,
                                        length_penalty)

    # -- paged-KV serving route (block table over a page pool) --------------

    def paged_alloc(self, n_pages, block_size=64, cache_dtype=None):
        """The physical page pool: per layer, ``(kc, vc)`` of
        ``[n_pages, H, block_size, D]`` zeros in the model's type on the
        model's device."""
        cfg = self.config
        dtype = to_torch_dtype(cache_dtype or cfg.dtype)
        if dtype == torch.int8:
            raise NotImplementedError(
                "int8 KV pages are not ported yet (ROADMAP, queue 1, "
                "item 3: int8 caches)")
        shape = (n_pages, cfg.num_attention_heads, block_size, cfg.head_dim)
        device = self.transformer.wte.weight.device
        return [(torch.zeros(shape, dtype=dtype, device=device),
                 torch.zeros(shape, dtype=dtype, device=device))
                for _ in range(cfg.num_hidden_layers)]

    @torch.no_grad()
    def paged_prefill_into(self, input_ids, layers, block_tables,
                           block_size=64, dec_base=None, logits_at=None,
                           dynamic_cache_scales=False, cache_scales=None,
                           dynamic_scale_valid=None, logits_all=False):
        """Prompt pass writing K and V into a caller-owned page pool (in
        place). input_ids ``[B, s]``; block_tables ``[B, blocks_per_seq]``
        int on the ids' device. Returns ``(logits [B, V], layers)``: the
        logits of the last position, or, with ``logits_at`` ``[B]``, of
        that position of each row.

        dec_base ``[B]`` int32: chunked-prefill append mode; the ids are
        appended after ``dec_base`` rows already in the pool, at positions
        ``dec_base + local`` (clamped to the ``wpe`` table: a chunk's pad
        rows may run past it).

        Not ported: the int8 pools (``dynamic_cache_scales``,
        ``cache_scales``, ``dynamic_scale_valid``) and speculative verify
        (``logits_all``); they raise ``NotImplementedError``."""
        if dynamic_cache_scales or cache_scales is not None \
                or dynamic_scale_valid is not None:
            raise NotImplementedError(
                "int8 KV pages are not ported yet (ROADMAP, queue 1, "
                "item 3: int8 caches)")
        if logits_all:
            raise NotImplementedError(
                "paged_prefill_into(logits_all=True) is speculative "
                "decode's verify pass, not ported yet (ROADMAP, queue 1, "
                "item 3)")
        b, s = input_ids.shape
        dev = input_ids.device

        def ints(fill):
            return torch.full((b,), fill, dtype=torch.int32, device=dev)
        local = torch.arange(s, device=dev)
        if dec_base is None:
            enc, dec = ints(s), ints(0)
            pos = local.expand(b, s)
        else:
            enc, dec = ints(0), dec_base
            pos = dec_base.reshape(b, 1).long() + local
        cu_q = torch.arange(b + 1, dtype=torch.int32) * s   # on the host
        tr = self.transformer
        hidden = tr.embed(input_ids.reshape(b * s), pos.reshape(b * s))
        layers_state = []
        for block, (kc, vc) in zip(tr.h, layers):
            hidden = block.paged(hidden, kc, vc, enc, dec, ints(s), cu_q,
                                 block_tables, block_size)
            layers_state.append((kc, vc))
        hidden = tr.ln_f(hidden).view(b, s, -1)
        if logits_at is not None:
            # only the requested position through the LM head (the JAX
            # package selects it with a one-hot product, which is exact)
            rows = hidden[torch.arange(b, device=dev),
                          logits_at.reshape(b).long()]
        else:
            rows = hidden[:, s - 1]
        return self._logits(rows), layers_state

    def paged_prefill(self, input_ids, block_size=64, blocks_per_seq=None):
        """Prompt pass through a freshly allocated paged cache. Returns
        ``(last_logits [B, V], state)``, the state in the shared paged
        convention (``generation.paged_state``)."""
        return paged_prefill_impl(self, input_ids, block_size,
                                  blocks_per_seq)

    @torch.no_grad()
    def paged_decode_step(self, tok, state):
        """One token per sequence through the paged cache. tok ``[B]``.
        Writes each sequence's row at ``state["dec_lens"]`` into the pools
        in place and reads nothing back to the host, so
        ``jit.to_static(model.paged_decode_step, donate_args=(1,))`` serves
        every step with one CUDA graph. Returns ``(logits [B, V],
        new_state)``: the same pools, ``dec_lens + 1``."""
        b = tok.shape[0]
        t = state["dec_lens"]
        tr = self.transformer
        hidden = tr.embed(tok.reshape(b), t)                 # [B, E]
        new_layers = []
        for block, (kc, vc) in zip(tr.h, state["layers"]):
            hidden = block.paged(hidden, kc, vc, state["zeros_b"], t,
                                 state["ones_b"], state["cu_b"],
                                 state["block_tables"], state["block_size"])
            new_layers.append((kc, vc))
        logits = self._logits(tr.ln_f(hidden))               # [B, V]
        return logits, dict(state, layers=new_layers, dec_lens=t + 1)

    @torch.no_grad()
    def paged_fused_step(self, tok, chunk_ids, chunk_bt, chunk_dec,
                         chunk_at, state):
        """One packed call that advances every decode slot and one
        admission chunk: B + 1 sequences, B + C tokens, so decode never
        pauses while a prompt prefills.

        tok ``[B]``: this step's decode tokens (parked slots carry garbage).
        chunk_ids ``[C]``: the admission chunk (zeros when idle). chunk_bt
        ``[1, blocks_per_seq]``: the admitting sequence's block-table row
        (all scratch when idle). chunk_dec ``[1]``: rows earlier chunks
        wrote. chunk_at ``[1]``: the place of the last real token in this
        chunk, whose logits are returned. Everything stays on the device
        and the pools are written in place, so one CUDA graph serves every
        occupancy and every prompt length. Returns ``(decode_logits [B, V],
        chunk_logits [1, V], new_state)``, the state's ``dec_lens + 1``.

        The embeddings, norms and products run over all B + C rows at
        once; the attention runs twice a block, the B decode rows as one
        group and the chunk alone (each sequence attends only to its own
        pages, so this is the JAX package's one packed call, without the
        uneven packing that would run it a sequence at a time). The chunk's
        positions ``chunk_dec + local`` are clamped to the ``wpe`` table:
        pad rows may run past it."""
        b, c = tok.shape[0], chunk_ids.shape[0]
        t = state["dec_lens"]
        dev = tok.device
        chunk_enc = torch.zeros(1, dtype=torch.int32, device=dev)
        chunk_this = torch.full((1,), c, dtype=torch.int32, device=dev)
        pos = torch.cat([t.reshape(b).long(), chunk_dec.reshape(1).long()
                         + torch.arange(c, device=dev)])
        tr = self.transformer
        hidden = tr.embed(torch.cat([tok.reshape(b), chunk_ids.reshape(c)]),
                          pos)                               # [B + C, E]
        new_layers = []
        for block, (kc, vc) in zip(tr.h, state["layers"]):
            attn = block.attn
            qkv = attn.c_attn(block.ln_1(hidden))
            out_dec, _, kc, vc = block_multihead_attention(
                qkv[:b], kc, vc, state["zeros_b"], t, state["ones_b"],
                None, None, state["cu_b"], state["cu_b"],
                state["block_tables"], block_size=state["block_size"])
            out_chunk, _, kc, vc = block_multihead_attention(
                qkv[b:], kc, vc, chunk_enc, chunk_dec, chunk_this, None,
                None, (0, c), (0, c), chunk_bt,
                block_size=state["block_size"])
            hidden = hidden + attn.resid_dropout(
                attn.c_proj(torch.cat([out_dec, out_chunk])))
            hidden = hidden + block.mlp(block.ln_2(hidden))
            new_layers.append((kc, vc))
        hidden = tr.ln_f(hidden)
        dec_logits = self._logits(hidden[:b])                # [B, V]
        # the chunk's row picked on the device (the JAX package takes a
        # one-hot product, which is exact)
        chunk_logits = self._logits(
            hidden[b:].index_select(0, chunk_at.reshape(1).long()))
        return (dec_logits, chunk_logits,
                dict(state, layers=new_layers, dec_lens=t + 1))

    @torch.no_grad()
    def generate_paged(self, input_ids, max_new_tokens, block_size=64,
                       blocks_per_seq=None, decode_fn=None):
        """Greedy decode over the paged cache. Returns int64 ids
        ``[B, S + max_new_tokens]``; ``decode_fn`` replaces
        ``paged_decode_step`` (a captured one, for instance)."""
        return paged_generate_loop(self, input_ids, max_new_tokens,
                                   block_size, blocks_per_seq, decode_fn)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


__all__ = ["GPT2Config", "GPT2ForCausalLM", "GPT2Model", "GPT2Block",
           "GPT2Attention", "GPT2MLP", "gpt2_124m_config"]
