"""The port's Llama training path (paddle_tpu_torch: forward(labels=),
recompute, AdamW, amp.decorate O2, jit.TrainStep, gradient clipping)
against the JAX package's, on llama_tiny_config (GQA 4/2, two layers), on
the CPU.

Weights move across with models/convert.py (unrolled and scanned layouts);
inputs are explicit int64 numpy arrays, labels include -100. Tolerances:

- float32 loss within 1e-5 relative, every grad within 1e-5 of its largest
  magnitude: one summation order against another;
- float32 three-step trajectories: losses within 1e-5 relative; each
  parameter's update (final minus initial) within 0.5% in norm of the JAX
  package's (0.1% seen). Adam's normalized step m / sqrt(v) is as large
  for a grad of 1e-9 as for one of 1, so the last-bit noise of a near-zero
  grad moves a few elements by up to lr per step; the update norm is the
  measure that sees through that, and no element may move further from
  the reference than that Adam bound (2 lr per step);
- O2 bf16 trajectory: losses within 5e-3 relative (2.2e-3 seen); each
  parameter's update, from its float32 master, within 16% in norm of the
  JAX package's (13% seen); final bf16 parameters within the Adam bound
  plus one bf16 ulp. The frameworks round bf16 at different places (the
  port's RMSNorm and attention round once from float32; the JAX package's
  XLA fallbacks round twice and multiply scores in bf16): the JAX
  package's own O2 updates lie 20% in that norm from its float32 ones, and
  the port's 16% from its own. The port's float32 run lies 20% from the
  JAX package's O2 one, and the test checks that it misses the limit, so
  the limit tells O2 numerics from float32 ones.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny_config as jax_tiny_config
from paddle_tpu.optimizer.clip import \
    ClipGradByGlobalNorm as JaxClipGradByGlobalNorm
from paddle_tpu_torch import amp as port_amp
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (LlamaForCausalLM,
                                     llama_state_from_paddle_tpu,
                                     llama_tiny_config)
from paddle_tpu_torch.nn import functional as port_F
from paddle_tpu_torch.ops.hopper import (FlashAttentionFunction,
                                         RMSNormFunction)
from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm

REL = 1e-5
B, S = 2, 16
LR, STEPS = 1e-3, 3
O2_UPDATE_REL = 0.16


def _jax_state(scan_layers=False, seed=0):
    """A JAX model's float32 state with drawn norm weights."""
    paddle.seed(seed)
    jm = JaxLlama(jax_tiny_config(initializer_range=0.2,
                                  scan_layers=scan_layers))
    rng = np.random.RandomState(seed)
    state = {k: np.asarray(v.numpy(), np.float32)
             for k, v in jm.state_dict().items()}
    for k in state:
        if k.endswith("norm.weight") or k.endswith("ln1_w") or \
                k.endswith("ln2_w"):
            state[k] = (1.0 + 0.3 * rng.randn(*state[k].shape)
                        ).astype(np.float32)
    return state


@pytest.fixture(scope="module")
def state():
    return _jax_state()


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 128, (B, S)).astype(np.int64)
    labels = rng.randint(0, 128, (B, S)).astype(np.int64)
    labels[0, :5] = -100
    labels[1, -2:] = -100
    return ids, labels


def _jax_model(state, scan_layers=False):
    jm = JaxLlama(jax_tiny_config(initializer_range=0.2,
                                  scan_layers=scan_layers))
    jm.set_state_dict(state)
    return jm


def _port_model(state, **cfg):
    pm = LlamaForCausalLM(llama_tiny_config(initializer_range=0.2, **cfg),
                          device="cpu")
    pm.load_state_dict(llama_state_from_paddle_tpu(state))
    return pm


def _jax_loss_and_grads(jm, ids, labels):
    _, loss = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    loss.backward()
    grads = {n: np.asarray(p.grad.numpy(), np.float32)
             for n, p in jm.named_parameters()}
    return float(loss), llama_state_from_paddle_tpu(grads)


def _port_loss_and_grads(pm, ids, labels):
    _, loss = pm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    return float(loss.detach()), {n: p.grad
                                  for n, p in pm.named_parameters()}


def _assert_close_rel(got, ref, rel, what):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * float(np.abs(ref).max()),
                               err_msg=what)


def _assert_grads_match(got, ref):
    assert set(got) == set(ref)
    for name, g in got.items():
        assert g is not None, name
        _assert_close_rel(g.numpy(), ref[name], REL, name)


def test_loss_and_every_grad_match_jax(state, batch):
    ids, labels = batch
    ref_loss, ref_grads = _jax_loss_and_grads(_jax_model(state), ids, labels)
    loss, grads = _port_loss_and_grads(_port_model(state), ids, labels)
    assert abs(loss - ref_loss) <= REL * abs(ref_loss)
    _assert_grads_match(grads, ref_grads)


def test_recompute_gives_the_same_loss_and_grads(state, batch):
    ids, labels = batch
    plain = _port_loss_and_grads(_port_model(state), ids, labels)
    remat = _port_loss_and_grads(_port_model(state, use_recompute=True),
                                 ids, labels)
    assert remat[0] == plain[0]
    for name, g in plain[1].items():
        assert torch.equal(remat[1][name], g), name


def test_scanned_jax_model_converts_to_the_same_loss_and_grads(batch):
    ids, labels = batch
    scanned = _jax_state(scan_layers=True, seed=3)
    assert "model.layers_scanned.q_w" in scanned
    ref_loss, ref_grads = _jax_loss_and_grads(
        _jax_model(scanned, scan_layers=True), ids, labels)
    pm = _port_model(scanned, scan_layers=True)
    loss, grads = _port_loss_and_grads(pm, ids, labels)
    assert abs(loss - ref_loss) <= REL * abs(ref_loss)
    _assert_grads_match(grads, ref_grads)


def test_cross_entropy_means_over_valid_labels_only():
    logits = torch.tensor([[2.0, 0.0], [0.0, 1.0], [5.0, -5.0]])
    labels = torch.tensor([0, -100, 1])
    per = -torch.log_softmax(logits, -1)[[0, 2], [0, 1]]
    assert torch.allclose(port_F.cross_entropy(logits, labels), per.mean())
    assert port_F.cross_entropy(logits, torch.full((3,), -100)) == 0.0


def _jax_trajectory(state, ids, labels, *, lr, o2=False, clip=None,
                    steps=STEPS):
    jm = _jax_model(state)
    opt = paddle.optimizer.AdamW(
        learning_rate=lr, weight_decay=0.01, parameters=jm.parameters(),
        multi_precision=o2,
        grad_clip=None if clip is None else JaxClipGradByGlobalNorm(clip))
    if o2:
        jm, opt = paddle.amp.decorate(jm, opt, level="O2", dtype="bfloat16")

    def loss_fn(i, lab):
        return jm(i, labels=lab)[1]

    step = paddle.jit.TrainStep(loss_fn, opt)
    losses = [float(step(paddle.to_tensor(ids), paddle.to_tensor(labels)))
              for _ in range(steps)]
    params = {n: np.asarray(p.numpy().astype(np.float32))
              for n, p in jm.named_parameters()}
    masters = {n: np.asarray(opt._master_weights[id(p)])
               for n, p in jm.named_parameters()} if o2 else params
    return losses, llama_state_from_paddle_tpu(params), \
        llama_state_from_paddle_tpu(masters)


def _port_trajectory(state, ids, labels, *, lr, o2=False, clip=None,
                     steps=STEPS):
    pm = _port_model(state)
    opt = AdamW(learning_rate=lr, weight_decay=0.01,
                parameters=pm.parameters(), multi_precision=o2,
                grad_clip=None if clip is None else ClipGradByGlobalNorm(clip))
    if o2:
        pm, opt = port_amp.decorate(pm, opt, level="O2", dtype="bfloat16")
    step = TrainStep(lambda i, lab: pm(i, labels=lab)[1], opt)
    losses = [float(step(torch.from_numpy(ids), torch.from_numpy(labels)))
              for _ in range(steps)]
    params = {n: p.detach().float() for n, p in pm.named_parameters()}
    masters = {n: opt._master_weights[id(p)]
               for n, p in pm.named_parameters()} if o2 else params
    return losses, params, masters


@pytest.mark.parametrize("clip", [None, 0.5])
def test_float32_trajectory_matches_jax_train_step(state, batch, clip):
    ids, labels = batch
    if clip is not None:
        # the clip must bind: the first step's global grad norm exceeds it
        _, grads = _port_loss_and_grads(_port_model(state), ids, labels)
        norm = float(torch.sqrt(sum(g.square().sum()
                                    for g in grads.values())))
        assert norm > 2 * clip
    ref_losses, ref_params, _ = _jax_trajectory(state, ids, labels, lr=LR,
                                                clip=clip)
    losses, params, _ = _port_trajectory(state, ids, labels, lr=LR,
                                         clip=clip)
    np.testing.assert_allclose(losses, ref_losses, rtol=REL, atol=0)
    assert losses[-1] < losses[0]
    _assert_updates_match(params, ref_params, llama_state_from_paddle_tpu(
        state), 5e-3, 2 * LR * STEPS)


def _update_rel_err(p, start, ref, ref_start):
    """||update - reference update|| / ||reference update||, and the
    updates' difference."""
    step, ref_step = (p - start).numpy(), (ref - ref_start).numpy()
    diff = step - ref_step
    return np.linalg.norm(diff) / np.linalg.norm(ref_step), diff


def _assert_updates_match(got, ref, start, rel_norm, bound):
    for name, p in got.items():
        rel, diff = _update_rel_err(p, start[name], ref[name], start[name])
        assert rel <= rel_norm, name
        assert np.abs(diff).max() <= bound, name


def test_o2_bf16_trajectory_matches_jax_train_step(state, batch):
    ids, labels = batch
    ref_losses, ref_params, ref_masters = _jax_trajectory(
        state, ids, labels, lr=LR, o2=True)
    losses, params, masters = _port_trajectory(state, ids, labels, lr=LR,
                                               o2=True)
    np.testing.assert_allclose(losses, ref_losses, rtol=5e-3, atol=0)
    assert losses[-1] < losses[0]
    # masters start from the bf16-rounded weights
    start = {n: t.to(torch.bfloat16).float()
             for n, t in llama_state_from_paddle_tpu(state).items()}
    _assert_updates_match(masters, ref_masters, start, O2_UPDATE_REL,
                          2 * LR * STEPS)
    # the limit tells O2 from float32: the port's float32 run misses it
    _, f32_params, _ = _port_trajectory(state, ids, labels, lr=LR)
    f32_start = llama_state_from_paddle_tpu(state)
    assert max(_update_rel_err(p, f32_start[n], ref_masters[n], start[n])[0]
               for n, p in f32_params.items()) > O2_UPDATE_REL
    for name, p in params.items():
        assert torch.equal(p, masters[name].to(torch.bfloat16).float())
        ref = ref_params[name].numpy()
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert np.all(np.abs(p.numpy() - ref) <= 2 * LR * STEPS + ulp), name


def test_norm_and_attention_outputs_carry_the_port_functions():
    # the same autograd Functions launch the kernels on the card
    x = torch.randn(2, 5, 64, requires_grad=True)
    w = torch.ones(64, requires_grad=True)
    y = port_F.rms_norm(x, w, 1e-5)
    assert isinstance(y.grad_fn, RMSNormFunction._backward_cls)
    q = torch.randn(2, 5, 4, 16, requires_grad=True)
    kv = torch.randn(2, 5, 2, 16, requires_grad=True)
    out = port_F.scaled_dot_product_attention(q, kv, kv, is_causal=True)
    assert isinstance(out.grad_fn, FlashAttentionFunction._backward_cls)


def test_every_parameter_is_trainable_and_receives_a_grad(state, batch):
    ids, labels = batch
    pm = _port_model(state, use_recompute=True)
    params = dict(pm.named_parameters())
    assert len(params) == 21 and all(p.requires_grad
                                     for p in params.values())
    _, grads = _port_loss_and_grads(pm, ids, labels)
    for name, g in grads.items():
        assert g is not None and bool(g.abs().sum() > 0), name


def test_serving_builds_no_graph(state):
    pm = _port_model(state)
    ids = torch.from_numpy(np.arange(6, dtype=np.int64).reshape(1, 6))
    logits, caches, t = pm.prefill(ids, 8)
    assert not logits.requires_grad and not caches.requires_grad
    logits, caches, _ = pm.decode_step(logits[:, -1].argmax(-1, True),
                                       caches, t)
    assert not logits.requires_grad and not caches.requires_grad


def test_train_step_refuses_unported_options():
    opt = AdamW(parameters=[torch.nn.Parameter(torch.zeros(2))])
    for kw in ({"amp": {"level": "O1"}}, {"donate": False},
               {"mesh_plan": object()}):
        with pytest.raises(NotImplementedError):
            TrainStep(lambda: None, opt, **kw)
