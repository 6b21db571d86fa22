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

Not ported yet: serving (``prefill``, ``decode_step``, ``generate`` over
``masked_multihead_attention``), the paged methods, beam search and int8.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
from torch import nn

from ..device import default_device, to_torch_dtype
from ..nn import functional as F
from ..nn.layers import Dropout, Embedding, LayerNorm, Linear


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

    def forward(self, hidden):
        b, s, _ = hidden.shape
        h, d = self.config.num_attention_heads, self.config.head_dim
        # strided views of one projection: the attention copies them to the
        # kernels' layout
        q, k, v = self.c_attn(hidden).view(b, s, 3, h, d).unbind(2)
        out = F.scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=self.config.dropout,
            training=self.training, generator=self.seeds)
        return self.resid_dropout(self.c_proj(out.reshape(b, s, h * d)))


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


class GPT2ForCausalLM(nn.Module):
    """GPT-2 for training. Runs on the current CUDA card unless ``device``
    is given (the tests pass ``device="cpu"``); with no card and no device
    it raises. Weights are drawn from ``generator`` (default: one on the
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

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


__all__ = ["GPT2Config", "GPT2ForCausalLM", "GPT2Model", "GPT2Block",
           "GPT2Attention", "GPT2MLP", "gpt2_124m_config"]
