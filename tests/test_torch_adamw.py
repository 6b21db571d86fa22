"""The port's AdamW (paddle_tpu_torch.ops.hopper.adamw_plain / adamw_ and the
optimizer.AdamW that drives it) against the JAX package: the Pallas kernel
adamw_pallas in interpret mode, the XLA update AdamW._update, and the
eager AdamW optimizer with and without amp.decorate O2. Also the port's
Adam (coupled L2 decay) and its three gradient clips against the JAX
package's.

Tolerances, float32: 2e-6 of each array's largest magnitude (a few ulps:
one order of float32 operations against another). Against the Pallas
kernel the second moment is held to 2e-5 relative instead: that kernel
forms 1 - beta2 in float32, where 1 - 0.999 loses 1.3e-5 of its value to
cancellation, while the port and the XLA update round the double-precision
difference once. bf16 parameter copies: within one bf16 ulp of the
reference (a one-ulp float32 difference may straddle a bf16 rounding edge).
Clipped bf16 grads: within one bf16 ulp of the JAX package's (both scale in
float32 and round once).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Parameter, Tensor
from paddle_tpu.ops.pallas.fused_ops import adamw_pallas
from paddle_tpu.optimizer import clip as jax_clip
from paddle_tpu_torch import amp as port_amp
from paddle_tpu_torch.ops.hopper import adamw_, adamw_plain
from paddle_tpu_torch.optimizer import Adam as PortAdam
from paddle_tpu_torch.optimizer import AdamW as PortAdamW
from paddle_tpu_torch.optimizer import clip as port_clip

B1, B2, EPS, LR = 0.9, 0.999, 1e-8, 1e-3
SHAPE = (37, 29)   # 1073 elements: no multiple of the TPU's (8, 128) tile


def _close(a, b, rel=2e-6):
    b = np.asarray(b, np.float32)
    np.testing.assert_allclose(np.asarray(a, np.float32), b, rtol=0,
                               atol=rel * float(np.abs(b).max()))


def _within_bf16_ulp(a, ref):
    a, ref = np.asarray(a, np.float32), np.asarray(ref, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert np.all(np.abs(a - ref) <= ulp)


def _trajectory(seed, steps=3):
    rng = np.random.RandomState(seed)
    p0 = rng.randn(*SHAPE).astype(np.float32)
    grads = [(rng.randn(*SHAPE) * 0.1).astype(np.float32)
             for _ in range(steps)]
    return p0, grads


class _Holder:
    """The smallest 'model' amp.decorate takes: something with
    parameters()."""

    def __init__(self, params):
        self._params = params

    def parameters(self):
        return self._params


@pytest.mark.parametrize("wd", [0.01, 0.0])
def test_plain_matches_pallas_and_xla_update_over_three_steps(wd):
    p0, grads = _trajectory(1)
    jax_opt = paddle.optimizer.AdamW(LR, parameters=[Parameter(
        jnp.asarray(p0))], weight_decay=wd)
    pal = [jnp.asarray(p0), jnp.zeros(SHAPE, jnp.float32),
           jnp.zeros(SHAPE, jnp.float32)]
    xla_p = jnp.asarray(p0)
    xla_state = {"moment1": jnp.zeros(SHAPE, jnp.float32),
                 "moment2": jnp.zeros(SHAPE, jnp.float32),
                 "beta1_pow": jnp.asarray(1.0, jnp.float32),
                 "beta2_pow": jnp.asarray(1.0, jnp.float32)}
    port = [torch.from_numpy(p0), torch.zeros(SHAPE), torch.zeros(SHAPE)]
    b1p = b2p = np.float32(1.0)
    for g in grads:
        b1p, b2p = b1p * np.float32(B1), b2p * np.float32(B2)
        pal = adamw_pallas(*pal, jnp.asarray(g), lr=LR, beta1=B1, beta2=B2,
                           eps=EPS, weight_decay=wd, beta1_pow=b1p,
                           beta2_pow=b2p, interpret=True)
        xla_p, xla_state = jax_opt._update(xla_p, jnp.asarray(g), xla_state,
                                           LR)
        port = adamw_plain(*port, torch.from_numpy(g), lr=LR, beta1=B1,
                           beta2=B2, eps=EPS, weight_decay=wd,
                           bc1=np.float32(1) - b1p, bc2=np.float32(1) - b2p)
        for got, ref_pal, ref_xla, rel_pal in zip(
                port, pal, (xla_p, xla_state["moment1"],
                            xla_state["moment2"]), (2e-6, 2e-6, 2e-5)):
            _close(got.numpy(), ref_pal, rel_pal)
            _close(got.numpy(), ref_xla)


def test_in_place_wrapper_writes_bf16_copy_and_does_not_launch():
    p0, (g, *_) = _trajectory(2)
    p, m, v = torch.from_numpy(p0.copy()), torch.zeros(SHAPE), \
        torch.zeros(SHAPE)
    lowp = torch.empty(SHAPE, dtype=torch.bfloat16)
    hyper = dict(lr=LR, beta1=B1, beta2=B2, eps=EPS, weight_decay=0.01,
                 bc1=1 - B1, bc2=1 - B2)
    ref = adamw_plain(torch.from_numpy(p0), torch.zeros(SHAPE),
                      torch.zeros(SHAPE), torch.from_numpy(g), **hyper)
    gb = torch.from_numpy(g).to(torch.bfloat16)
    assert adamw_(p, m, v, torch.from_numpy(g), p_lowp=lowp, **hyper) is p
    assert adamw_.launches == 0
    assert torch.equal(p, ref[0]) and torch.equal(m, ref[1]) and \
        torch.equal(v, ref[2])
    assert torch.equal(lowp, ref[0].to(torch.bfloat16))
    with pytest.raises(ValueError, match="one size"):
        adamw_(p, m, v, gb[:3], **hyper)


def _jax_adamw(p0, grads, multi_precision, decay_fun=None):
    param = Parameter(jnp.asarray(p0))
    opt = paddle.optimizer.AdamW(LR, parameters=[param], weight_decay=0.01,
                                 apply_decay_param_fun=decay_fun)
    if multi_precision:
        paddle.amp.decorate(_Holder([param]), opt, level="O2",
                            dtype="bfloat16")
    for g in grads:
        param.grad = Tensor(jnp.asarray(g, param.dtype))
        opt.step()
    pid = id(param)
    master = opt._master_weights.get(pid, param._data)
    return (np.asarray(param._data.astype(jnp.float32)),
            np.asarray(master.astype(jnp.float32)),
            np.asarray(opt._accumulators["moment1"][pid]),
            np.asarray(opt._accumulators["moment2"][pid]))


def _port_adamw(p0, grads, multi_precision, decay_fun=None):
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = PortAdamW(LR, parameters=[param], weight_decay=0.01,
                    apply_decay_param_fun=decay_fun)
    if multi_precision:
        port_amp.decorate(_Holder([param]), opt, level="O2",
                          dtype="bfloat16")
        assert param.dtype == torch.bfloat16
    for g in grads:
        param.grad = torch.from_numpy(g).to(param.dtype)
        opt.step()
    pid = id(param)
    master = opt._master_weights.get(pid, param.detach())
    return (param.detach().float().numpy(), master.numpy(),
            opt._accumulators["moment1"][pid].numpy(),
            opt._accumulators["moment2"][pid].numpy())


def test_optimizer_matches_jax_adamw_float32():
    p0, grads = _trajectory(3)
    got, ref = _port_adamw(p0, grads, False), _jax_adamw(p0, grads, False)
    for a, r in zip(got, ref):
        _close(a, r)


def test_optimizer_after_decorate_matches_jax_o2_masters_and_moments():
    # bf16 parameters with float32 masters made from the bf16-rounded
    # values at the first step; grads arrive in bf16 and are cast up
    p0, grads = _trajectory(4)
    got, ref = _port_adamw(p0, grads, True), _jax_adamw(p0, grads, True)
    _within_bf16_ulp(got[0], ref[0])
    for a, r in zip(got[1:], ref[1:]):
        _close(a, r)
    assert not np.array_equal(got[1], p0)   # the master moved


def test_apply_decay_param_fun_sees_empty_name():
    seen = []

    def no_decay(name):
        seen.append(name)
        return False

    p0, grads = _trajectory(5, steps=2)
    got = _port_adamw(p0, grads, False, no_decay)
    ref = _jax_adamw(p0, grads, False, no_decay)
    assert seen and set(seen) == {""}
    for a, r in zip(got, ref):
        _close(a, r)


def test_state_dict_round_trip_continues_the_trajectory():
    p0, grads = _trajectory(6, steps=3)
    full = _port_adamw(p0, grads, True)

    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = PortAdamW(LR, parameters=[param], weight_decay=0.01)
    port_amp.decorate(_Holder([param]), opt)
    for g in grads[:2]:
        param.grad = torch.from_numpy(g).to(param.dtype)
        opt.step()
    state = opt.state_dict()
    assert set(state) == {"@step"} | {f"param_0.{n}" for n in (
        "moment1", "moment2", "beta1_pow", "beta2_pow", "master_weight")}
    fresh = PortAdamW(LR, parameters=[param], weight_decay=0.01,
                      multi_precision=True)
    fresh.set_state_dict(state)
    param.grad = torch.from_numpy(grads[2]).to(param.dtype)
    fresh.step()
    assert np.array_equal(fresh._master_weights[id(param)].numpy(), full[1])
    assert fresh.get_lr() == LR and fresh.state_dict()["@step"] == 3


@pytest.mark.parametrize("wd", [0.05, None])
def test_adam_coupled_decay_matches_jax_adam(wd):
    # Adam's float weight_decay is L2 decay added to the grad before the
    # moments, not AdamW's decoupled decay
    p0, grads = _trajectory(7)
    param = Parameter(jnp.asarray(p0))
    jax_opt = paddle.optimizer.Adam(LR, parameters=[param], weight_decay=wd)
    port_param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    port_opt = PortAdam(LR, parameters=[port_param], weight_decay=wd)
    for g in grads:
        param.grad = Tensor(jnp.asarray(g))
        jax_opt.step()
        port_param.grad = torch.from_numpy(g)
        port_opt.step()
    _close(port_param.detach().numpy(), np.asarray(param._data))
    for name in ("moment1", "moment2"):
        _close(port_opt._accumulators[name][id(port_param)].numpy(),
               np.asarray(jax_opt._accumulators[name][id(param)]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [
    ("ClipGradByValue", (0.05,)), ("ClipGradByValue", (0.1, -0.02)),
    ("ClipGradByNorm", (0.5,)), ("ClipGradByGlobalNorm", (1.0,))])
def test_clips_match_jax(clip, dtype):
    # three grads, one of them small enough that ByNorm leaves it alone,
    # and a parameter without a grad
    name, args = clip
    rng = np.random.RandomState(8)
    grads = [(rng.randn(*shape) * scale).astype(np.float32)
             for shape, scale in (((37, 29), 0.1), ((64,), 0.01),
                                  ((5, 3), 0.3))]
    jax_params = [Parameter(jnp.zeros(g.shape)) for g in grads] + \
        [Parameter(jnp.zeros(4))]
    tdtype = getattr(torch, dtype)
    port_params = [torch.nn.Parameter(torch.zeros(g.shape, dtype=tdtype))
                   for g in grads + [np.zeros(4)]]
    for jp, pp, g in zip(jax_params, port_params, grads):
        jp.grad = Tensor(jnp.asarray(g).astype(dtype))
        pp.grad = torch.tensor(g).to(tdtype)
    getattr(jax_clip, name)(*args)(jax_params)
    getattr(port_clip, name)(*args)(port_params)
    assert port_params[-1].grad is None
    changed = False
    for jp, pp, g in zip(jax_params, port_params, grads):
        assert pp.grad.dtype == tdtype
        ref = np.asarray(jp.grad._data.astype(jnp.float32))
        got = pp.grad.float().numpy()
        if dtype == "float32":
            _close(got, ref)
        else:
            _within_bf16_ulp(got, ref)
        changed |= not np.array_equal(
            got, torch.from_numpy(g).to(tdtype).float().numpy())
    assert changed     # the clip bound
