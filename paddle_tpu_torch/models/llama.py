"""Llama: training (``forward(input_ids, labels=)``, with per-layer
recompute) and serving (prefill, then greedy, sampled or beam decode over a
dense KV cache, or greedy over a paged one).

Counterpart of ``paddle_tpu/models/llama.py`` (config, RoPE, GQA attention,
the unrolled decoder stack, the LM loss, ``prefill``/``decode_step``/
``generate``/``generate_beam``). The layers train: full-sequence attention
runs the flash kernels (forward and backward) and every norm the RMSNorm
kernels when the model lies on the card. The one-token decode attention is plain PyTorch, as
it was XLA code in the JAX package.

Training and the full forward take an optional additive ``attn_mask``
``[b, 1 | h, s, s]`` (float32 or the model's type), the whole attention
spec: with a mask the attention runs non-causal, as in the JAX package.

``prefill(n_valid=)`` and ``decode_step`` are what the dense serving
batcher (``inference/serving.py``) drives; the paged route
(``paged_alloc``, ``paged_prefill_into``, ``paged_prefill``,
``paged_decode_step``, ``paged_fused_step``, ``generate_paged``) is what
the paged batcher drives, its attention
``incubate.nn.functional.block_gqa_attention`` over a page pool.
``generate`` samples (temperature, top-k, top-p) and ``generate_beam``
searches beams through the drivers GPT-2 shares (``models/generation.py``).
Int8 KV pages: ``calibrate_cachekv_int8`` installs static per-kv-head
scales (then ``paged_alloc`` allocates int8 pools and every paged method
quantizes with them), and ``paged_prefill_into(dynamic_cache_scales=True)``
computes a prompt's own scales, which ``cache_scales=`` and
``state["cache_scales"]`` thread into later chunks and decode steps.
``generate_paged_speculative`` is greedy draft and verify decoding (a
Llama or GPT-2 draft). Not ported yet: MoE and context parallelism.
``scan_layers`` is accepted and
runs the unrolled stack (in the JAX package it is a compile-time device
with the unrolled loop's numerics); selective recompute recomputes whole
layers, as the JAX package's unrolled path does.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..device import default_device, to_torch_dtype
from ..distributed.fleet.recompute import recompute
from ..incubate.nn.functional.decode_attention import (
    block_gqa_attention, cachekv_scale_kwargs, cachekv_scales_from_dense,
    dense_decode)
from ..nn import functional as F
from ..nn.layers import Embedding, Linear, RMSNorm
from . import generation
from .generation import (paged_generate_loop, paged_prefill_impl,
                         speculative_loop)

@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    initializer_range: float = 0.02
    dtype: str = "float32"
    # re-run each decoder layer's forward in the backward instead of keeping
    # its activations (training only)
    use_recompute: bool = False
    # "full" or "selective": both recompute whole layers in the port
    recompute_granularity: str = "full"
    # accepted for the JAX package's configs; the port runs the unrolled
    # stack either way
    scan_layers: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def llama2_7b_config(**overrides) -> LlamaConfig:
    return dataclasses.replace(LlamaConfig(), **overrides)


def llama_tiny_config(**overrides) -> LlamaConfig:
    """Test-scale config (GQA 4/2, two layers)."""
    cfg = LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=176,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=128)
    return dataclasses.replace(cfg, **overrides)


def _rope_cos_sin(seq_len, head_dim, theta, dtype, device):
    """RoPE tables [seq, head_dim // 2], built in float32 with numpy and then
    cast to the model's type (so bf16 models use bf16-rounded tables)."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2,
                                          dtype=np.float32) / head_dim))
    t = np.arange(seq_len, dtype=np.float32)
    freqs = np.outer(t, inv_freq)
    return (torch.from_numpy(np.cos(freqs)).to(device=device, dtype=dtype),
            torch.from_numpy(np.sin(freqs)).to(device=device, dtype=dtype))


def _rotate_pairs(xf, c, s):
    """Rotate interleaved (even, odd) feature pairs of float32 ``xf``."""
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s],
                       dim=-1).flatten(-2)


def apply_rotary_pos_emb(x, cos, sin):
    """Rotate [B, S, H, D] by the (cos, sin) tables ([S, D/2]) in float32,
    interleaved-pair convention, and cast back to x's type."""
    c = cos[None, :, None, :].float()
    s = sin[None, :, None, :].float()
    return _rotate_pairs(x.float(), c, s).to(x.dtype)


def _rope_at(x, cos_tab, sin_tab, t):
    """Rotate [B, H, D] by per-row positions t [B] (decode-step RoPE)."""
    c = cos_tab[t][:, None, :].float()
    s = sin_tab[t][:, None, :].float()
    return _rotate_pairs(x.float(), c, s).to(x.dtype)


def _decode_attn(q, k_new, v_new, cache_k, cache_v, t, cos_tab, sin_tab):
    """One-token GQA attention over the dense cache.

    q [B, H, D] and k_new/v_new [B, KV, D] are pre-RoPE; cache_k/v
    [B, KV, S_max, D] hold post-RoPE rows; t [B] are the write positions.
    RoPE applies at t, then ``dense_decode`` writes the new rows into the
    cache IN PLACE (the JAX package returns new arrays; updating in place
    saves a copy of every layer's cache per token) and scores the grouped
    heads in float32 against positions <= t. Returns ctx [B, H*D].
    """
    return dense_decode(_rope_at(q, cos_tab, sin_tab, t),
                        _rope_at(k_new, cos_tab, sin_tab, t), v_new,
                        cache_k, cache_v, t)


class LlamaAttention(nn.Module):
    """GQA attention with RoPE."""

    def __init__(self, config: LlamaConfig, *, device, dtype):
        super().__init__()
        self.config = config
        h, kv = config.num_attention_heads, config.num_key_value_heads
        d, e = config.head_dim, config.hidden_size
        kw = dict(device=device, dtype=dtype)
        self.q_proj = Linear(e, h * d, **kw)
        self.k_proj = Linear(e, kv * d, **kw)
        self.v_proj = Linear(e, kv * d, **kw)
        self.o_proj = Linear(h * d, e, **kw)

    def forward(self, hidden, cos, sin, attn_mask=None, return_kv=False):
        b, s, _ = hidden.shape
        cfg = self.config
        h, kv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                    cfg.head_dim)
        q = apply_rotary_pos_emb(self.q_proj(hidden).view(b, s, h, d),
                                 cos, sin)
        k = apply_rotary_pos_emb(self.k_proj(hidden).view(b, s, kv, d),
                                 cos, sin)
        v = self.v_proj(hidden).view(b, s, kv, d)
        if return_kv:
            # decode-cache layout [B, KV, S, D], post-RoPE, GQA unexpanded
            kv_out = (k.transpose(1, 2), v.transpose(1, 2))
        if kv != h and not F.flash_eligible(q, k, attn_mask):
            # GQA on the dense path: repeat the kv heads to the full head
            # count (the flash kernel takes GQA natively)
            k, v = (t.repeat_interleave(h // kv, dim=2) for t in (k, v))
        # an explicit mask is the whole attention spec (callers bake
        # causality into it), as in the JAX package
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                             is_causal=attn_mask is None)
        out = self.o_proj(out.reshape(b, s, h * d))
        if return_kv:
            return out, kv_out[0], kv_out[1]
        return out


class LlamaMLP(nn.Module):
    """SwiGLU MLP: down(silu(gate(x)) * up(x))."""

    def __init__(self, config: LlamaConfig, *, device, dtype):
        super().__init__()
        e, i = config.hidden_size, config.intermediate_size
        kw = dict(device=device, dtype=dtype)
        self.gate_proj = Linear(e, i, **kw)
        self.up_proj = Linear(e, i, **kw)
        self.down_proj = Linear(i, e, **kw)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.self_attn = LlamaAttention(config, **kw)
        self.mlp = LlamaMLP(config, **kw)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps, **kw)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps, **kw)

    def forward(self, hidden, cos, sin, attn_mask=None):
        hidden = hidden + self.self_attn(self.input_layernorm(hidden),
                                         cos, sin, attn_mask)
        return hidden + self.mlp(self.post_attention_layernorm(hidden))

    def forward_kv(self, hidden, cos, sin):
        """Prefill: dense forward plus this layer's post-RoPE K/V
        ([B, KV, S, D]) for the decode cache."""
        attn_out, k, v = self.self_attn(self.input_layernorm(hidden),
                                        cos, sin, return_kv=True)
        hidden = hidden + attn_out
        return hidden + self.mlp(self.post_attention_layernorm(hidden)), k, v

    def decode(self, hidden, cache_kv, t, cos_tab, sin_tab):
        """One-token decode. hidden [B, 1, E]; cache_kv [2, B, KV, S_max, D]
        (updated in place at t); t [B]. Returns hidden'."""
        attn = self.self_attn
        cfg = attn.config
        b = hidden.shape[0]
        h, kvh, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
        x = self.input_layernorm(hidden)
        ctx = _decode_attn(attn.q_proj(x).view(b, h, d),
                           attn.k_proj(x).view(b, kvh, d),
                           attn.v_proj(x).view(b, kvh, d),
                           cache_kv[0], cache_kv[1], t, cos_tab, sin_tab)
        hidden = hidden + attn.o_proj(ctx.view(b, 1, h * d))
        return hidden + self.mlp(self.post_attention_layernorm(hidden))


class LlamaModel(nn.Module):
    """The unrolled decoder stack."""

    def __init__(self, config: LlamaConfig, *, device, dtype):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      **kw)
        self.layers = nn.ModuleList(LlamaDecoderLayer(config, **kw)
                                    for _ in range(config.num_hidden_layers))
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)
        cos, sin = _rope_cos_sin(config.max_position_embeddings,
                                 config.head_dim, config.rope_theta,
                                 dtype, device)
        self.register_buffer("_cos", cos, persistent=False)
        self.register_buffer("_sin", sin, persistent=False)

    def forward_prefill(self, input_ids, s_max):
        """Dense prompt pass that also fills the decode caches. Returns
        (hidden [B, S, E], caches [L, 2, B, KV, s_max, D]), the caches
        zero past the prompt."""
        b, s = input_ids.shape
        if s > s_max:
            raise ValueError(f"prompt length {s} exceeds cache size {s_max}")
        cfg = self.config
        hidden = self.embed_tokens(input_ids)
        cos, sin = self._cos[:s], self._sin[:s]
        caches = hidden.new_zeros(len(self.layers), 2, b,
                                  cfg.num_key_value_heads, s_max,
                                  cfg.head_dim)
        for i, layer in enumerate(self.layers):
            hidden, k, v = layer.forward_kv(hidden, cos, sin)
            caches[i, 0, :, :, :s] = k
            caches[i, 1, :, :, :s] = v
        return self.norm(hidden), caches

    def forward(self, input_ids, attn_mask=None):
        s = input_ids.shape[1]
        hidden = self.embed_tokens(input_ids)
        cos, sin = self._cos[:s], self._sin[:s]
        remat = self.config.use_recompute and self.training
        for layer in self.layers:
            hidden = (recompute(layer, hidden, cos, sin, attn_mask) if remat
                      else layer(hidden, cos, sin, attn_mask))
        return self.norm(hidden)


class LlamaForCausalLM(nn.Module):
    """Llama for training and serving. Runs on the current CUDA card unless ``device`` is
    given (the tests pass ``device="cpu"``); with no card and no device it
    raises. Weights are drawn from ``generator`` (default: one on the model's
    device seeded with 0) as N(0, initializer_range), norms set to 1; load
    real or transferred weights with ``load_state_dict``."""

    def __init__(self, config: LlamaConfig, device=None, generator=None):
        super().__init__()
        device = default_device(device)
        dtype = to_torch_dtype(config.dtype)
        self.config = config
        self.model = LlamaModel(config, device=device, dtype=dtype)
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
            elif isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)

    def _lm_logits(self, hidden):
        if self.lm_head is None:
            return F.linear(hidden, self.model.embed_tokens.weight)
        return self.lm_head(hidden)

    def forward(self, input_ids, labels=None, attn_mask=None):
        """Logits [B, S, V] of a full forward pass; with ``labels`` [B, S]
        also the mean cross entropy over the labels that are not -100,
        computed on float32 logits, as ``(logits, loss)``. Labels are not
        shifted: the caller aligns them with the positions, as in the JAX
        package. ``attn_mask`` (additive ``[B, 1 | H, S, S]``, or any mask
        the dense path takes) replaces the causal mask."""
        logits = self._lm_logits(self.model(input_ids, attn_mask))
        if labels is None:
            return logits
        loss = F.cross_entropy(
            logits.reshape(-1, self.config.vocab_size).float(),
            labels.reshape(-1))
        return logits, loss

    # -- incremental (KV-cache) decode: the serving path --------------------

    @torch.no_grad()
    def prefill(self, input_ids, s_max, n_valid=None):
        """Prompt pass. Returns (last_logits [B, 1, V],
        caches [L, 2, B, KV, s_max, D], t [B, 1] int32).

        ``n_valid`` ([B, 1] int, on the ids' device): the true prompt
        lengths when ``input_ids`` is right-padded onto a bucket ladder.
        The last hidden state is gathered at ``n_valid - 1`` and decode
        resumes at ``t = n_valid``. Causality keeps the pad rows out of
        every earlier position, and decode overwrites each pad cache row
        before any step can read it."""
        b, s = input_ids.shape
        hidden, caches = self.model.forward_prefill(input_ids, s_max)
        if n_valid is None:
            last = hidden[:, s - 1:s]
            t = torch.full((b, 1), s, dtype=torch.int32,
                           device=input_ids.device)
        else:
            idx = (n_valid.long() - 1).reshape(b, 1, 1).expand(
                b, 1, hidden.shape[-1])
            last = torch.gather(hidden, 1, idx)
            t = n_valid.to(torch.int32)
        return self._lm_logits(last), caches, t

    @torch.no_grad()
    def decode_step(self, tok, caches, t):
        """One token through every layer's cache. tok [B, 1] int; caches
        [L, 2, B, KV, S_max, D], updated in place at t; t [B, 1] int32.
        Returns (logits [B, 1, V], caches, t + 1)."""
        model = self.model
        hidden = model.embed_tokens(tok)
        t_flat = t.reshape(-1).long()
        for i, layer in enumerate(model.layers):
            hidden = layer.decode(hidden, caches[i], t_flat, model._cos,
                                  model._sin)
        return self._lm_logits(model.norm(hidden)), caches, t + 1

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens, s_max=None,
                 decode_fn=None, do_sample=False, temperature=1.0,
                 top_k=0, top_p=None, seed=None, eos_id=None, pad_id=None):
        """Incremental decode over the KV cache: greedy by default (the
        argmax on the device); ``do_sample`` draws on the host with
        temperature, top-k and top-p from ``seed``. With ``eos_id`` a row
        that emitted it continues with ``pad_id`` (default: eos_id).
        ``decode_fn`` replaces ``decode_step`` (a captured one, for
        instance). Returns int64 ids [B, S + max_new_tokens]."""
        return generation.generate(
            self, input_ids, max_new_tokens, s_max, decode_fn,
            do_sample=do_sample, temperature=temperature, top_k=top_k,
            top_p=top_p, seed=seed, eos_id=eos_id, pad_id=pad_id)

    @torch.no_grad()
    def generate_beam(self, input_ids, max_new_tokens, num_beams=4,
                      s_max=None, decode_fn=None, length_penalty=0.0):
        """Beam search over the GQA KV cache (``generation.beam_loop``).
        Returns the best beam per row, int64 [B, S + max_new_tokens]."""
        return generation.generate_beam(self, input_ids, max_new_tokens,
                                        num_beams, s_max, decode_fn,
                                        length_penalty)

    # -- paged-KV serving route (block table over a page pool, GQA-native) --

    def _check_paged_servable(self):
        if self.config.scan_layers:
            raise ValueError("paged decode needs the unrolled stack: build "
                             "the model with scan_layers=False for serving")

    def paged_alloc(self, n_pages, block_size=64, cache_dtype=None):
        """The physical page pool: per layer, ``(kc, vc)`` of
        ``[n_pages, KV, block_size, D]`` zeros (GQA caches at kv-head
        count) on the model's device: int8 after
        ``calibrate_cachekv_int8``, else the model's type; ``cache_dtype``
        overrides (the dynamic int8 callers pass ``"int8"``)."""
        cfg = self.config
        dtype = to_torch_dtype(cache_dtype or (
            "int8" if self._cachekv_scales is not None else cfg.dtype))
        shape = (n_pages, cfg.num_key_value_heads, block_size, cfg.head_dim)
        device = self.model.embed_tokens.weight.device
        return [(torch.zeros(shape, dtype=dtype, device=device),
                 torch.zeros(shape, dtype=dtype, device=device))
                for _ in range(cfg.num_hidden_layers)]

    # per-layer static int8 scale dicts (calibrate_cachekv_int8), or None
    _cachekv_scales = None

    @torch.no_grad()
    def calibrate_cachekv_int8(self, sample_ids):
        """Install static per-kv-head int8 cache scales from a calibration
        batch ``[B, s]``: the dense prefill (flash attention and RMSNorm
        kernels on the card), then each layer's |K| and |V| amax per head
        over the post-RoPE rows gives ``quant = 127 / amax`` and
        ``dequant = amax / 127``. Afterwards every paged route
        (``generate_paged``, ``PagedContinuousBatcher``) writes and reads
        int8 pages. Returns the per-layer scale dicts; ``None`` disables
        them again."""
        if sample_ids is None:
            self._cachekv_scales = None
            return None
        _, caches = self.model.forward_prefill(sample_ids,
                                               sample_ids.shape[1])
        self._cachekv_scales = cachekv_scales_from_dense(caches)
        return self._cachekv_scales

    def _layer_cache_scales(self, li):
        """``block_gqa_attention``'s keyword arguments for layer li's static
        int8 pages (empty when none are calibrated)."""
        return cachekv_scale_kwargs(self._cachekv_scales, li)

    @torch.no_grad()
    def paged_prefill_into(self, input_ids, layers, block_tables,
                           block_size=64, dec_base=None, logits_at=None,
                           dynamic_cache_scales=False, cache_scales=None,
                           dynamic_scale_valid=None, logits_all=False):
        """Prompt pass writing post-RoPE K and raw V into a caller-owned
        page pool (in place). input_ids ``[B, s]``; block_tables
        ``[B, blocks_per_seq]`` int on the ids' device. Returns
        ``(logits [B, V], layers)``: the logits of the last position, or,
        with ``logits_at`` ``[B]``, of that position of each row.

        dec_base ``[B]`` int32: chunked-prefill append mode; the ids are
        appended after ``dec_base`` rows already in the pool, at RoPE
        positions ``dec_base + local``.

        Int8 pages: with static scales calibrated, the pools are written
        with them. ``dynamic_cache_scales=True`` (int8 pools) computes each
        row's per-kv-head scales from this call's rows (``dynamic_scale_valid``
        ``[B]``: only each row's leading rows count) and returns them as a
        third element, a per-layer list of ``{"kq", "vq", "kdq", "vdq"}``
        dicts of ``[B, KV]`` tensors; ``cache_scales`` (such a list)
        quantizes a later chunk with a first chunk's scales.

        ``logits_all=True`` is speculative decode's verify pass: the
        logits of every appended position, ``[B, s, V]``."""
        if dynamic_cache_scales and cache_scales is not None:
            raise ValueError("dynamic_cache_scales computes scales; "
                             "cache_scales consumes them — pass one")
        self._check_paged_servable()
        cfg = self.config
        b, s = input_ids.shape
        h, kvh, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
        dev = input_ids.device

        def ints(fill):
            return torch.full((b,), fill, dtype=torch.int32, device=dev)
        if dec_base is None:
            enc, dec = ints(s), ints(0)
        else:
            enc, dec = ints(0), dec_base
        this = ints(s)
        cu_q = torch.arange(b + 1, dtype=torch.int32) * s   # on the host
        model = self.model
        hidden = model.embed_tokens(input_ids)               # [B, s, E]
        layers_state = []
        scales_out = [] if dynamic_cache_scales else None
        for li, (layer, (kc, vc)) in enumerate(zip(model.layers, layers)):
            attn = layer.self_attn
            x = layer.input_layernorm(hidden)
            if dynamic_cache_scales:
                extra = dict(use_dynamic_cachekv_quant=True,
                             compute_dynamic_scales=True,
                             dynamic_scale_valid=dynamic_scale_valid)
            else:
                extra = cachekv_scale_kwargs(
                    cache_scales if cache_scales is not None
                    else self._cachekv_scales, li)
            res = block_gqa_attention(
                attn.q_proj(x).reshape(b * s, h, d),
                attn.k_proj(x).reshape(b * s, kvh, d),
                attn.v_proj(x).reshape(b * s, kvh, d), kc, vc, enc, dec,
                this, cu_q, block_tables, block_size=block_size,
                rope_cos=model._cos, rope_sin=model._sin, **extra)
            if dynamic_cache_scales:
                kq, vq, kdq, vdq = res[3]
                scales_out.append({"kq": kq, "vq": vq, "kdq": kdq,
                                   "vdq": vdq})
            out = res[0]
            hidden = hidden + attn.o_proj(out.reshape(b, s, h * d))
            hidden = hidden + layer.mlp(
                layer.post_attention_layernorm(hidden))
            layers_state.append((kc, vc))
        hidden = model.norm(hidden)
        if logits_all:
            rows = hidden
        elif logits_at is not None:
            # only the requested position through the LM head (the JAX
            # package selects it with a one-hot product, which is exact)
            rows = hidden[torch.arange(b, device=dev),
                          logits_at.reshape(b).long()]
        else:
            rows = hidden[:, s - 1]
        if dynamic_cache_scales:
            return self._lm_logits(rows), layers_state, scales_out
        return self._lm_logits(rows), layers_state

    def paged_prefill(self, input_ids, block_size=64, blocks_per_seq=None):
        """Prompt pass through a freshly allocated paged cache. Returns
        ``(last_logits [B, V], state)``, the state in the shared paged
        convention (``generation.paged_state``)."""
        return paged_prefill_impl(self, input_ids, block_size,
                                  blocks_per_seq)

    @torch.no_grad()
    def paged_decode_step(self, tok, state):
        """One token per sequence through the paged GQA cache. tok ``[B]``.
        Writes each sequence's row at ``state["dec_lens"]`` into the pools
        in place and reads nothing back to the host, so
        ``jit.to_static(model.paged_decode_step, donate_args=(1,))`` serves
        every step with one CUDA graph. Int8 pages quantize with the
        calibrated static scales, or with ``state["cache_scales"]`` (the
        per-layer ``[B, KV]`` dicts of dynamic int8) when it is set.
        Returns ``(logits [B, V], new_state)``: the same pools,
        ``dec_lens + 1``."""
        self._check_paged_servable()
        cfg = self.config
        b = tok.shape[0]
        h, kvh, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
        t = state["dec_lens"]
        model = self.model
        hidden = model.embed_tokens(tok.reshape(b, 1))       # [B, 1, E]
        dyn = state.get("cache_scales")
        new_layers = []
        for li, (layer, (kc, vc)) in enumerate(zip(model.layers,
                                                   state["layers"])):
            attn = layer.self_attn
            x = layer.input_layernorm(hidden)
            if dyn is not None:
                # dynamic int8: each slot's scales, fixed by its prefill
                kwargs = dict(cachekv_scale_kwargs(dyn, li),
                              use_dynamic_cachekv_quant=True)
            else:
                kwargs = self._layer_cache_scales(li)
            out, kc, vc = block_gqa_attention(
                attn.q_proj(x).reshape(b, h, d),
                attn.k_proj(x).reshape(b, kvh, d),
                attn.v_proj(x).reshape(b, kvh, d), kc, vc,
                state["zeros_b"], t, state["ones_b"], state["cu_b"],
                state["block_tables"], block_size=state["block_size"],
                rope_cos=model._cos, rope_sin=model._sin, **kwargs)
            hidden = hidden + attn.o_proj(out.reshape(b, 1, h * d))
            hidden = hidden + layer.mlp(
                layer.post_attention_layernorm(hidden))
            new_layers.append((kc, vc))
        logits = self._lm_logits(model.norm(hidden)[:, 0])  # [B, V]
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

        The norms and products run over all B + C rows at once; the
        attention runs twice a layer, the B decode rows as one group and
        the chunk alone (each sequence attends only to its own pages, so
        this is the JAX package's one packed call, without the uneven
        packing that would run it a sequence at a time)."""
        self._check_paged_servable()
        if state.get("cache_scales") is not None:
            # the chunk sequence (row B) has no per-slot scale row; the
            # batcher refuses this combination up front
            raise NotImplementedError(
                "fused admission + dynamic cachekv quant: use static "
                "calibration (calibrate_cachekv_int8)")
        cfg = self.config
        b, c = tok.shape[0], chunk_ids.shape[0]
        h, kvh, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
        t = state["dec_lens"]
        dev = tok.device
        chunk_enc = torch.zeros(1, dtype=torch.int32, device=dev)
        chunk_this = torch.full((1,), c, dtype=torch.int32, device=dev)
        model = self.model
        hidden = model.embed_tokens(torch.cat([tok.reshape(b),
                                               chunk_ids.reshape(c)]))
        new_layers = []
        for li, (layer, (kc, vc)) in enumerate(zip(model.layers,
                                                   state["layers"])):
            attn = layer.self_attn
            x = layer.input_layernorm(hidden)                 # [B + C, E]
            q = attn.q_proj(x).reshape(b + c, h, d)
            k = attn.k_proj(x).reshape(b + c, kvh, d)
            v = attn.v_proj(x).reshape(b + c, kvh, d)
            sc = self._layer_cache_scales(li)
            out_dec, kc, vc = block_gqa_attention(
                q[:b], k[:b], v[:b], kc, vc, state["zeros_b"], t,
                state["ones_b"], state["cu_b"], state["block_tables"],
                block_size=state["block_size"], rope_cos=model._cos,
                rope_sin=model._sin, **sc)
            out_chunk, kc, vc = block_gqa_attention(
                q[b:], k[b:], v[b:], kc, vc, chunk_enc, chunk_dec,
                chunk_this, (0, c), chunk_bt, block_size=state["block_size"],
                rope_cos=model._cos, rope_sin=model._sin, **sc)
            hidden = hidden + attn.o_proj(torch.cat([out_dec, out_chunk]))
            hidden = hidden + layer.mlp(
                layer.post_attention_layernorm(hidden))
            new_layers.append((kc, vc))
        hidden = model.norm(hidden)
        dec_logits = self._lm_logits(hidden[:b])              # [B, V]
        # the chunk's row picked on the device (the JAX package takes a
        # one-hot product, which is exact)
        chunk_logits = self._lm_logits(
            hidden[b:].index_select(0, chunk_at.reshape(1).long()))
        return (dec_logits, chunk_logits,
                dict(state, layers=new_layers, dec_lens=t + 1))

    @torch.no_grad()
    def generate_paged(self, input_ids, max_new_tokens, block_size=64,
                       blocks_per_seq=None, decode_fn=None):
        """Greedy decode over the paged GQA cache (int8 pages after
        ``calibrate_cachekv_int8``). Returns int64 ids
        ``[B, S + max_new_tokens]``; ``decode_fn`` replaces
        ``paged_decode_step`` (a captured one, for instance)."""
        return paged_generate_loop(self, input_ids, max_new_tokens,
                                   block_size, blocks_per_seq, decode_fn)

    def generate_paged_speculative(self, input_ids, max_new_tokens,
                                   draft_model, draft_k=4, block_size=64,
                                   eos_id=None, compile=True,
                                   return_stats=False):
        """Greedy speculative decoding (the loop GPT-2 shares): any draft
        sharing this model's vocabulary, a GPT-2 one too, proposes and this
        model verifies; the tokens equal ``generate_paged``'s. See
        ``generation.speculative_loop``."""
        return speculative_loop(self, draft_model, input_ids,
                                max_new_tokens, draft_k, block_size, eos_id,
                                compile, return_stats)


__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "llama2_7b_config", "llama_tiny_config", "apply_rotary_pos_emb"]
