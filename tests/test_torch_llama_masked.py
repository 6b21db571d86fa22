"""The port's Llama under an attention mask (packed documents) against the
JAX package's, on llama_tiny_config, on the CPU.

A packed-document mask puts several documents into one row and lets each
token attend only to the earlier tokens of its own document: float32
``[b, 1, s, s]``, 0 or -1e9. With a mask the JAX package's Llama runs
non-causal under it, and on the CPU it takes its dense route (repeating
the kv heads for GQA); the port takes the flash route (the kernels' plain
versions here) with GQA native. Tolerances:

- float32 logits, loss and every grad within 1e-5 of the largest
  magnitude: one summation order against another;
- O2 (bf16) with the mask, at ``tests/test_torch_llama_train.py``'s O2
  limits: the loss within 5e-3 relative; every grad of one backward within
  16% in norm of the JAX package's (the frameworks round bf16 at
  different places; 4.7% seen, and 147% without the mask); after one
  TrainStep(ids, labels, mask), each float32 master moved as the JAX
  package's moved it wherever the grad is large enough that its sign is
  certain.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny_config as jax_tiny_config
from paddle_tpu_torch import amp as port_amp
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (LlamaForCausalLM,
                                     llama_state_from_paddle_tpu,
                                     llama_tiny_config)
from paddle_tpu_torch.optimizer import AdamW

REL = 1e-5
O2_REL = 0.16
B, S, LR = 2, 32, 1e-3


def _packed_mask(seed):
    """Documents of 3-12 tokens packed into each row; float32
    [B, 1, S, S], 0 where a token may attend and -1e9 elsewhere."""
    rng = np.random.RandomState(seed)
    doc = np.zeros((B, S), np.int64)
    for r in range(B):
        start, i = 0, 0
        while start < S:
            n = rng.randint(3, 13)
            doc[r, start:start + n] = i
            start, i = start + n, i + 1
    keep = (doc[:, :, None] == doc[:, None, :]) & np.tril(
        np.ones((S, S), bool))
    return np.where(keep, 0.0, -1e9).astype(np.float32)[:, None]


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 128, (B, S)).astype(np.int64)
    labels = rng.randint(0, 128, (B, S)).astype(np.int64)
    labels[0, :3] = -100
    return ids, labels, _packed_mask(2)


def _state(kv_heads, seed=0):
    paddle.seed(seed)
    jm = JaxLlama(jax_tiny_config(initializer_range=0.2,
                                  num_key_value_heads=kv_heads))
    rng = np.random.RandomState(seed)
    state = {k: np.asarray(v.numpy(), np.float32)
             for k, v in jm.state_dict().items()}
    for k in state:
        if k.endswith("norm.weight"):
            state[k] = (1.0 + 0.3 * rng.randn(*state[k].shape)
                        ).astype(np.float32)
    return state


def _models(kv_heads):
    state = _state(kv_heads)
    jm = JaxLlama(jax_tiny_config(initializer_range=0.2,
                                  num_key_value_heads=kv_heads))
    jm.set_state_dict(state)
    pm = LlamaForCausalLM(llama_tiny_config(initializer_range=0.2,
                                            num_key_value_heads=kv_heads),
                          device="cpu")
    pm.load_state_dict(llama_state_from_paddle_tpu(state))
    return jm, pm, state


def _close(got, ref, rel, what):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=rel * float(np.abs(ref).max()),
                               err_msg=what)


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_logits_loss_and_grads_with_packed_mask_match_jax(batch, kv_heads):
    ids, labels, mask = batch
    jm, pm, _ = _models(kv_heads)
    logits_j, loss_j = jm(paddle.to_tensor(ids),
                          labels=paddle.to_tensor(labels),
                          attn_mask=paddle.to_tensor(mask))
    loss_j.backward()
    logits, loss = pm(torch.from_numpy(ids), labels=torch.from_numpy(labels),
                      attn_mask=torch.from_numpy(mask))
    loss.backward()
    _close(logits.detach().numpy(), logits_j.numpy(), REL, "logits")
    assert abs(float(loss.detach()) - float(loss_j)) <= \
        REL * abs(float(loss_j))
    grads_j = llama_state_from_paddle_tpu(
        {n: np.asarray(p.grad.numpy(), np.float32)
         for n, p in jm.named_parameters()})
    for name, p in pm.named_parameters():
        _close(p.grad.numpy(), grads_j[name], REL, name)
    # the mask matters: without it the logits differ
    unmasked = pm(torch.from_numpy(ids)).detach().numpy()
    assert np.abs(unmasked - logits.detach().numpy()).max() > 0.1


def _rel_norm(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(a - ref) / np.linalg.norm(ref)


def test_o2_train_step_with_packed_mask_matches_jax(batch):
    ids, labels, mask = batch
    jm, pm, state = _models(2)
    jopt = paddle.optimizer.AdamW(learning_rate=LR, weight_decay=0.01,
                                  parameters=jm.parameters(),
                                  multi_precision=True)
    jm, jopt = paddle.amp.decorate(jm, jopt, level="O2", dtype="bfloat16")
    opt = AdamW(learning_rate=LR, weight_decay=0.01,
                parameters=pm.parameters(), multi_precision=True)
    pm, opt = port_amp.decorate(pm, opt, level="O2", dtype="bfloat16")
    jargs = [paddle.to_tensor(a) for a in (ids, labels, mask)]
    targs = [torch.from_numpy(a) for a in (ids, labels, mask)]

    # the grads of one backward
    _, loss_j = jm(jargs[0], labels=jargs[1], attn_mask=jargs[2])
    loss_j.backward()
    _, loss = pm(targs[0], labels=targs[1], attn_mask=targs[2])
    loss.backward()
    assert abs(float(loss.detach()) - float(loss_j)) <= \
        5e-3 * abs(float(loss_j))
    grads_j = {n: g.numpy() for n, g in llama_state_from_paddle_tpu(
        {n: np.asarray(p.grad.numpy().astype(np.float32))
         for n, p in jm.named_parameters()}).items()}
    for name, p in pm.named_parameters():
        assert _rel_norm(p.grad.float().numpy(), grads_j[name]) <= O2_REL, \
            name
    jopt.clear_grad()
    opt.clear_grad()

    # one TrainStep(ids, labels, mask) each, from the same state: the port's
    # loss equals its own forward's above. Adam's first step moves a master
    # by lr * g / (|g| + eps) plus the decay, so where the JAX package's
    # grad is over a tenth of its tensor's largest, both move it by the
    # same lr * sign(g) (bf16 noise cannot flip those signs); 5% of lr
    # allows for how each framework forms the decay and bias corrections
    step_j = paddle.jit.TrainStep(
        lambda i, lab, m: jm(i, labels=lab, attn_mask=m)[1], jopt)
    step = TrainStep(lambda i, lab, m: pm(i, labels=lab, attn_mask=m)[1],
                     opt)
    loss_j = float(step_j(*jargs))
    assert float(step(*targs)) == float(loss.detach())
    assert abs(float(loss.detach()) - loss_j) <= 5e-3 * abs(loss_j)
    start = {n: t.to(torch.bfloat16).float().numpy()
             for n, t in llama_state_from_paddle_tpu(state).items()}
    masters_j = llama_state_from_paddle_tpu(
        {n: np.asarray(jopt._master_weights[id(p)])
         for n, p in jm.named_parameters()})
    for name, p in pm.named_parameters():
        update = opt._master_weights[id(p)].numpy() - start[name]
        ref = np.asarray(masters_j[name]) - start[name]
        strong = np.abs(grads_j[name]) > 0.1 * np.abs(grads_j[name]).max()
        assert strong.sum() >= 1, name
        assert np.abs(update - ref)[strong].max() <= 0.05 * LR, name
