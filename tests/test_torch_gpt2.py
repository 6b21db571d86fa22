"""The port's GPT-2 training path (paddle_tpu_torch.models.GPT2ForCausalLM
with LayerNorm, tanh-GELU, biases, the tied LM head and dropout; AdamW,
amp.decorate O2 and jit.TrainStep) against the JAX package's, on a tiny
config (vocab 256, hidden 64, 2 layers, 4 heads), on the CPU.

Weights move across with models/convert.py (``gpt2_state_from_paddle_tpu``:
the projections transposed), with drawn biases and LayerNorm weights so the
mapping is seen; inputs are explicit int64 numpy arrays, labels include
-100. Tolerances are those of ``test_torch_llama_train.py``:

- float32 with dropout 0: logits, loss and every grad within 1e-5 of the
  largest magnitude (relative for the loss): one summation order against
  another;
- a three-step O2 bf16 ``TrainStep`` trajectory: losses within 5e-3
  relative; each parameter's update, from its float32 master, within 16% in
  norm of the JAX package's, no element further than the Adam bound (2 lr
  a step) plus one bf16 ulp of the final bf16 parameters. The frameworks
  round bf16 at different places (the JAX package's CPU attention
  multiplies scores in bf16; the port's rounds once from float32). The
  key part of ``c_attn``'s bias is held to the Adam bound alone: adding a
  constant to every key of a row leaves its softmax unchanged, so that
  bias's exact gradient is zero and both frameworks step it by the sign of
  their rounding noise (its update lay 64-73% apart in norm, the query and
  value parts at most 8%).

With dropout the JAX model draws its attention mask with
``jax.random.bernoulli`` on the CPU (its kernel route is the TPU's), so
model-level dropout parity is not asked; the kernels' hash mask is held to
the JAX interpret path in ``test_torch_flash_attention_dropout.py``. Here
dropout must be reproducible from the model's seed and must run attention
through the flash route's dropout.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPT2Config as JaxGPT2Config
from paddle_tpu.models import GPT2ForCausalLM as JaxGPT2
from paddle_tpu_torch import amp as port_amp
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPT2Config, GPT2ForCausalLM,
                                     gpt2_124m_config,
                                     gpt2_state_from_paddle_tpu)
from paddle_tpu_torch.ops.hopper import FlashAttentionFunction
from paddle_tpu_torch.optimizer import AdamW

REL = 1e-5
B, S = 2, 16
LR, STEPS = 1e-3, 3
TINY = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=128)


@pytest.fixture(scope="module")
def state():
    """A JAX tiny model's float32 state with drawn biases and LayerNorms."""
    paddle.seed(0)
    jm = JaxGPT2(JaxGPT2Config(initializer_range=0.2, dropout=0.0, **TINY))
    rng = np.random.RandomState(0)
    out = {}
    for k, v in jm.state_dict().items():
        a = np.asarray(v.numpy(), np.float32)
        if k.endswith(".bias"):
            a = (0.2 * rng.randn(*a.shape)).astype(np.float32)
        elif ".ln_" in k:
            a = (1.0 + 0.3 * rng.randn(*a.shape)).astype(np.float32)
        out[k] = a
    return out


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 256, (B, S)).astype(np.int64)
    labels = rng.randint(0, 256, (B, S)).astype(np.int64)
    labels[0, :4] = -100
    return ids, labels


def _jax_model(state):
    jm = JaxGPT2(JaxGPT2Config(initializer_range=0.2, dropout=0.0, **TINY))
    jm.set_state_dict(state)
    return jm


def _port_model(state, dropout=0.0, seed=0):
    pm = GPT2ForCausalLM(GPT2Config(initializer_range=0.2, dropout=dropout,
                                    **TINY), device="cpu", seed=seed)
    pm.load_state_dict(gpt2_state_from_paddle_tpu(state))
    return pm


def _assert_close_rel(got, ref, rel, what):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * float(np.abs(ref).max()),
                               err_msg=what)


def test_config_and_parameters_mirror_the_jax_model(state):
    cfg = gpt2_124m_config()
    assert (cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads,
            cfg.head_dim, cfg.vocab_size, cfg.dropout) == \
        (768, 12, 12, 64, 50257, 0.1)
    pm = _port_model(state)
    names = [n for n, _ in pm.named_parameters()]
    assert names == list(state)             # 4 + 12 a layer (148 at 124M)
    assert len(names) == 4 + 12 * TINY["num_hidden_layers"]
    assert pm.num_params() == sum(a.size for a in state.values())
    assert pm.transformer.h[0].attn.c_attn.weight.shape == (192, 64)
    # construction draws N(0, std) weights, zero biases, unit LayerNorms
    fresh = GPT2ForCausalLM(GPT2Config(**TINY), device="cpu")
    assert not fresh.transformer.h[0].mlp.c_fc.bias.any()
    assert bool((fresh.transformer.ln_f.weight == 1).all())
    assert abs(float(fresh.transformer.wte.weight.detach().std()) - 0.02) \
        < 2e-3


def test_eval_logits_loss_and_every_grad_match_jax(state, batch):
    # one forward and backward a side, in eval mode (dropout 0 on both)
    ids, labels = batch
    jm, pm = _jax_model(state), _port_model(state)
    jm.eval()
    pm.eval()
    ref_logits, ref_loss = jm(paddle.to_tensor(ids),
                              labels=paddle.to_tensor(labels))
    ref_loss.backward()
    ref_grads = gpt2_state_from_paddle_tpu(
        {n: np.asarray(p.grad.numpy(), np.float32)
         for n, p in jm.named_parameters()})
    logits, loss = pm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    _assert_close_rel(logits.detach().numpy(), ref_logits.numpy(), REL,
                      "logits")
    loss, ref_loss = float(loss.detach()), float(ref_loss)
    assert abs(loss - ref_loss) <= REL * abs(ref_loss)
    for name, p in pm.named_parameters():
        assert p.grad is not None, name
        _assert_close_rel(p.grad.numpy(), ref_grads[name], REL, name)


def test_o2_bf16_trajectory_matches_jax_train_step(state, batch):
    ids, labels = batch
    jm = _jax_model(state)
    jopt = paddle.optimizer.AdamW(learning_rate=LR, weight_decay=0.01,
                                  parameters=jm.parameters(),
                                  multi_precision=True)
    jm, jopt = paddle.amp.decorate(jm, jopt, level="O2", dtype="bfloat16")
    jstep = paddle.jit.TrainStep(lambda i, lab: jm(i, labels=lab)[1], jopt)
    ref_losses = [float(jstep(paddle.to_tensor(ids),
                              paddle.to_tensor(labels)))
                  for _ in range(STEPS)]
    ref_masters = gpt2_state_from_paddle_tpu(
        {n: np.asarray(jopt._master_weights[id(p)])
         for n, p in jm.named_parameters()})
    ref_params = gpt2_state_from_paddle_tpu(
        {n: np.asarray(p.numpy().astype(np.float32))
         for n, p in jm.named_parameters()})

    pm = _port_model(state)
    opt = AdamW(learning_rate=LR, weight_decay=0.01,
                parameters=pm.parameters(), multi_precision=True)
    pm, opt = port_amp.decorate(pm, opt, level="O2", dtype="bfloat16")
    step = TrainStep(lambda i, lab: pm(i, labels=lab)[1], opt)
    losses = [float(step(torch.from_numpy(ids), torch.from_numpy(labels)))
              for _ in range(STEPS)]
    np.testing.assert_allclose(losses, ref_losses, rtol=5e-3, atol=0)
    assert losses[-1] < losses[0]
    start = {n: t.to(torch.bfloat16).float()
             for n, t in gpt2_state_from_paddle_tpu(state).items()}
    bound = 2 * LR * STEPS
    e = TINY["hidden_size"]
    for name, p in pm.named_parameters():
        master = opt._master_weights[id(p)]
        step_, ref_step = (master - start[name]).numpy(), \
            (ref_masters[name] - start[name]).numpy()
        assert np.abs(step_ - ref_step).max() <= bound, name
        if name.endswith("c_attn.bias"):        # q and v parts only
            step_, ref_step = (np.r_[x[:e], x[2 * e:]]
                               for x in (step_, ref_step))
        rel = np.linalg.norm(step_ - ref_step) / np.linalg.norm(ref_step)
        assert rel <= 0.16, (name, rel)
        assert torch.equal(p.detach(), master.to(torch.bfloat16))
        ref = ref_params[name].numpy()
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert np.all(np.abs(p.detach().float().numpy() - ref)
                      <= bound + ulp), name


def _flash_nodes(loss):
    """The flash-attention backward nodes of the autograd graph."""
    seen, todo, found = set(), [loss.grad_fn], []
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if isinstance(node, FlashAttentionFunction._backward_cls):
            found.append(node)
        todo.extend(n for n, _ in node.next_functions)
    return found


def test_dropout_is_reproducible_and_runs_the_flash_dropout(state, batch):
    ids, labels = (torch.from_numpy(x) for x in batch)

    def losses(seed, steps=2):
        pm = _port_model(state, dropout=0.1, seed=seed)
        opt = AdamW(learning_rate=LR, parameters=pm.parameters())
        out = []
        for _ in range(steps):
            _, loss = pm(ids, labels=labels)
            nodes = _flash_nodes(loss)
            assert len(nodes) == TINY["num_hidden_layers"]
            assert all(n.dropout[0] == 0.1 for n in nodes)
            loss.backward()
            opt.step()
            opt.clear_grad()
            out.append(float(loss.detach()))
        return out

    first = losses(3)
    assert losses(3) == first
    assert losses(4) != first
    pm = _port_model(state)
    with torch.no_grad():
        _, undropped = pm(ids, labels=labels)
    assert float(undropped) != first[0]
    # eval mode applies no dropout at all
    pm = _port_model(state, dropout=0.1, seed=3).eval()
    with torch.no_grad():
        _, loss = pm(ids, labels=labels)
    assert float(loss) == float(undropped)
