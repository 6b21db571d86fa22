"""Llama: training (``forward(input_ids, labels=)``, with per-layer
recompute) and serving (prefill, then greedy decode over a dense KV cache).

Counterpart of ``paddle_tpu/models/llama.py`` (config, RoPE, GQA attention,
the unrolled decoder stack, the LM loss, ``prefill``/``decode_step``/
``generate``). The layers train: full-sequence attention runs the flash
kernels (forward and backward) and every norm the RMSNorm kernels when the
model lies on the card. The one-token decode attention is plain PyTorch, as
it was XLA code in the JAX package.

Not ported yet: MoE, context parallelism, the paged routes, beam search,
sampling, int8 caches and attention masks. ``scan_layers`` is accepted and
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
from ..nn import functional as F
from ..nn.layers import Embedding, Linear, RMSNorm
from .generation import generate_loop, resolve_s_max

NEG_INF = -1e30


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
    RoPE applies at t, the new rows are written into the cache IN PLACE
    (the JAX package returns new arrays; updating in place saves a copy of
    every layer's cache per token), and the grouped heads score in float32
    against positions <= t. Returns ctx [B, H*D].
    """
    b, h, d = q.shape
    kvh, s_max = cache_k.shape[1], cache_k.shape[2]
    q = _rope_at(q, cos_tab, sin_tab, t)
    k_new = _rope_at(k_new, cos_tab, sin_tab, t)
    b_idx = torch.arange(b, device=q.device)
    cache_k[b_idx, :, t] = k_new.to(cache_k.dtype)
    cache_v[b_idx, :, t] = v_new.to(cache_v.dtype)
    qg = q.reshape(b, kvh, h // kvh, d).float()
    scale = 1.0 / (d ** 0.5)
    scores = torch.einsum("bgrd,bgsd->bgrs", qg, cache_k.float()) * scale
    pos = torch.arange(s_max, device=q.device)
    scores = torch.where(pos[None, None, None, :] <= t[:, None, None, None],
                         scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bgrs,bgsd->bgrd", probs, cache_v.float())
    return ctx.reshape(b, h * d).to(q.dtype)


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

    def forward(self, hidden, cos, sin, return_kv=False):
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
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
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

    def forward(self, hidden, cos, sin):
        hidden = hidden + self.self_attn(self.input_layernorm(hidden),
                                         cos, sin)
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

    def forward(self, input_ids):
        s = input_ids.shape[1]
        hidden = self.embed_tokens(input_ids)
        cos, sin = self._cos[:s], self._sin[:s]
        remat = self.config.use_recompute and self.training
        for layer in self.layers:
            hidden = (recompute(layer, hidden, cos, sin) if remat
                      else layer(hidden, cos, sin))
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

    def forward(self, input_ids, labels=None):
        """Logits [B, S, V] of a full forward pass; with ``labels`` [B, S]
        also the mean cross entropy over the labels that are not -100,
        computed on float32 logits, as ``(logits, loss)``. Labels are not
        shifted: the caller aligns them with the positions, as in the JAX
        package."""
        logits = self._lm_logits(self.model(input_ids))
        if labels is None:
            return logits
        loss = F.cross_entropy(
            logits.reshape(-1, self.config.vocab_size).float(),
            labels.reshape(-1))
        return logits, loss

    # -- incremental (KV-cache) decode: the serving path --------------------

    @torch.no_grad()
    def prefill(self, input_ids, s_max):
        """Prompt pass. Returns (last_logits [B, 1, V],
        caches [L, 2, B, KV, s_max, D], t [B, 1] int32)."""
        b, s = input_ids.shape
        hidden, caches = self.model.forward_prefill(input_ids, s_max)
        t = torch.full((b, 1), s, dtype=torch.int32, device=input_ids.device)
        return self._lm_logits(hidden[:, s - 1:s]), caches, t

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
    def generate(self, input_ids, max_new_tokens, s_max=None, eos_id=None,
                 pad_id=None):
        """Greedy incremental decode over the KV cache. Returns int64 ids
        [B, S + max_new_tokens]; with ``eos_id`` a row that emitted it
        continues with ``pad_id`` (default: eos_id)."""
        s = input_ids.shape[1]
        s_max = resolve_s_max(self.config, s, max_new_tokens, s_max)
        return generate_loop(lambda: self.prefill(input_ids, s_max),
                             self.decode_step, input_ids, max_new_tokens,
                             eos_id=eos_id, pad_id=pad_id)


__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "llama2_7b_config", "llama_tiny_config", "apply_rotary_pos_emb"]
