"""Quantization-aware training of the port against the JAX package on the
CPU: the reference's six cases of tests/test_qat.py on the same micro
models (weights carried across by the bridge), each held against the JAX
result where the JAX package computes one, plus the fake quant itself.

Tolerances: the fake quant's scales and codes are bitwise the serving
path's and the reference's (f32 and bf16 masters); a float forward of the
two frameworks within 2e-4 of the largest output (summation order), the
reference's own 1e-6 and 1e-4 between a QAT forward and its int8 serving
forward."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tlxcv_tpu.nn as jnn
from tlxcv_tpu.core import pure, split
from tlxcv_tpu.core.module import Module
from tlxcv_tpu.nn.layers import _fake_quant_w as j_fake_quant_w
from tlxcv_tpu.ops import quant as JQ
from tlxcv_tpu_torch import nn
from tlxcv_tpu_torch.nn.layers import _fake_quant_w
from tlxcv_tpu_torch.ops.quant import (calibrate_activations, disable_qat,
                                       enable_qat, qat_serving_convert,
                                       quantize_weights)
from tlxcv_tpu_torch.train import Trainer, optimizers
from tlxcv_tpu_torch.utils import load_jax_params


class JConvNet(Module):
    def __init__(self):
        self.conv1 = jnn.Conv2d(3, 8, 3, padding=1)
        self.conv2 = jnn.Conv2d(8, 8, 3, padding=1)
        self.head = jnn.Linear(8, 4)

    def __call__(self, x):
        x = jnn.relu(self.conv1(x))
        x = jnn.relu(self.conv2(x))
        return self.head(jnp.mean(x, axis=(1, 2)))


class JMLP(Module):
    def __init__(self):
        self.fc1 = jnn.Linear(8, 32)
        self.fc2 = jnn.Linear(32, 4)

    def __call__(self, x):
        return self.fc2(jnn.relu(self.fc1(x)))


class ConvNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 8, 3, padding=1, device="cpu")
        self.conv2 = nn.Conv2d(8, 8, 3, padding=1, device="cpu")
        self.head = nn.Linear(8, 4, device="cpu")

    def forward(self, x):
        x = torch.relu(self.conv1(x))
        x = torch.relu(self.conv2(x))
        return self.head(x.mean((1, 2)))


class MLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(8, 32, device="cpu")
        self.fc2 = nn.Linear(32, 4, device="cpu")

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def _pair(jcls, tcls):
    jm, tm = jcls(), tcls()
    params, state = split(jm)
    load_jax_params(tm, {k: np.asarray(v) for k, v in
                         {**params, **state}.items()}, strict=True)
    return jm, tm


def _close(got, want, rel=2e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max())


def _run(tm, x):
    with torch.no_grad():
        return tm(torch.from_numpy(np.asarray(x, np.float32))).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quant_is_the_reference_s_and_the_serving_codes(rng, dtype):
    """The weight fake quant on an OIHW weight against the reference's on
    the same weight in HWIO, bitwise, in f32 and on bf16 masters (the
    Trainer's bf16 policy); in f32 the fake-quantized weight is the served
    codes times the served scale."""
    w = rng.normal(size=(5, 4, 3, 3)).astype(np.float32)  # OIHW
    w[2] = 0.0  # a channel of zeros: the 1e-12 floor
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    jw = jnp.asarray(w.transpose(2, 3, 1, 0)).astype(getattr(jnp, dtype))
    got = _fake_quant_w(tw).float().numpy()
    want = np.asarray(j_fake_quant_w(jw).astype(jnp.float32))
    np.testing.assert_array_equal(got, want.transpose(3, 2, 0, 1))
    if dtype == "float32":
        conv = nn.Conv2d(4, 5, 3, device="cpu")
        with torch.no_grad():
            conv.weight.copy_(tw)
        quantize_weights(conv)
        served = (conv._unpacked().float()
                  * conv.w_scale[:, None, None, None]).numpy()
        np.testing.assert_array_equal(got, served)


def test_qat_weight_fakequant_bit_aligned_with_serving(rng):
    """QAT (weights only) forward == weight-only int8 serving forward, and
    both match the JAX package's."""
    jm, tm = _pair(JConvNet, ConvNet)
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    assert enable_qat(tm, act=False) == JQ.enable_qat(jm, act=False) == 3
    y_qat = _run(tm, x)
    _close(y_qat, jm(jnp.asarray(x)))
    assert qat_serving_convert(tm) == JQ.qat_serving_convert(jm) == 3
    assert tm.conv1.weight.dtype == torch.int8
    y_int8 = _run(tm, x)
    np.testing.assert_allclose(y_qat, y_int8, rtol=1e-6, atol=1e-6)
    _close(y_int8, jm(jnp.asarray(x)))


def test_qat_act_fakequant_matches_full_int8_path(rng):
    """With the activation fake quant on, the QAT forward mirrors the full
    int8 x int8 -> int32 serving path; the calibrated scales are the
    reference's; both forwards match the JAX package's."""
    jm, tm = _pair(JConvNet, ConvNet)
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    enable_qat(tm, act=True)
    JQ.enable_qat(jm, act=True)
    cal = [rng.normal(size=(4, 8, 8, 3)).astype(np.float32)]
    assert calibrate_activations(tm, cal) == JQ.calibrate_activations(
        jm, cal) == 3
    for name in ("conv1", "conv2", "head"):
        np.testing.assert_allclose(
            getattr(tm, name).a_scale.numpy(),
            np.asarray(getattr(jm, name).a_scale.value), rtol=1e-6)
    y_qat = _run(tm, x)
    _close(y_qat, jm(jnp.asarray(x)))
    qat_serving_convert(tm)
    JQ.qat_serving_convert(jm)
    y_int8 = _run(tm, x)  # a_scale carried over: the full int8 path
    np.testing.assert_allclose(y_qat, y_int8, rtol=1e-4, atol=1e-5)
    _close(y_int8, jm(jnp.asarray(x)))


def test_qat_ste_gradients(rng):
    """The straight-through estimator passes the loss gradient to the
    float masters (the JAX package's gradients); the frozen ``a_scale``
    gets exactly zero gradient and stays as it was through a fine-tune."""
    jm, tm = _pair(JMLP, MLP)
    JQ.enable_qat(jm, act=True)
    enable_qat(tm, act=True)
    cal = [rng.normal(size=(16, 8)).astype(np.float32)]
    JQ.calibrate_activations(jm, cal)
    calibrate_activations(tm, cal)
    x = rng.normal(size=(8, 8)).astype(np.float32)
    params, state = split(jm)

    def jloss(p):
        y, _ = pure(jm)(p, state, jnp.asarray(x))
        return jnp.sum(y ** 2)

    want = jax.grad(jloss)(params)
    scales = [tm.fc1.a_scale, tm.fc2.a_scale]
    for s in scales:
        s.requires_grad_(True)
    loss = (tm(torch.from_numpy(x)) ** 2).sum()
    ps = list(tm.parameters())
    grads = torch.autograd.grad(loss, ps + scales, allow_unused=True,
                                materialize_grads=True)
    for s, g in zip(scales, grads[len(ps):]):
        assert g.shape == s.shape and not g.any()
        s.requires_grad_(False)
    got = dict(zip((k for k, _ in tm.named_parameters()), grads))
    assert got["fc1.weight"].abs().max() > 0
    for k in ("fc1.weight", "fc2.weight", "fc1.bias", "fc2.bias"):
        w = np.asarray(want[k.replace(".", "/")])
        g = got[k].numpy()
        _close(g.T if g.ndim == 2 else g, w)

    before = [s.clone() for s in scales]
    trainer = Trainer(tm, loss_fn=lambda o, t: (o ** 2).sum(),
                      optimizer=optimizers.Adam(1e-2), device="cpu")
    trainer.train(1, [(x, x[:, :4])] * 3, print_freq=2)
    assert all(torch.equal(b, s) for b, s in zip(before, scales))


def _make_task():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(8, 4))
    x = rng.normal(size=(512, 8)).astype(np.float32)
    y = np.argmax(x @ w + 0.3 * rng.normal(size=(512, 4)), axis=1)
    return x, y


def _acc(model, x, y):
    return float((np.argmax(_run(model, x), 1) == y).mean())


def _finetune(model, x, y, steps=500, lr=3e-3):
    """Full-batch Adam on the softmax cross-entropy, through the Trainer
    (optax's arithmetic), as the reference's ``_finetune``."""
    trainer = Trainer(model, loss_fn=lambda o, t: torch.nn.functional
                      .cross_entropy(o, t), optimizer=optimizers.Adam(lr),
                      device="cpu")
    batch = trainer._put_batch((x, y))
    for _ in range(steps):
        trainer._train_step(*batch)
    trainer._sync_to_network()


def test_qat_recovers_ptq_accuracy_loss():
    """The reference's quantization-sensitive fixture, from the JAX
    package's initial weights: after float training, 3 hidden channels
    are scaled x120 with exact compensation downstream, so the per-tensor
    scale of fc2's input is set by the outliers and PTQ loses accuracy;
    QAT fine-tuning under the same frozen ``a_scale`` recovers it, and the
    converted int8 model scores as the QAT forward."""
    from tlxcv_tpu.core.init import set_seed

    set_seed(0)
    _, m = _pair(JMLP, MLP)
    x, y = _make_task()
    _finetune(m, x, y)
    a_float = _acc(m, x, y)
    assert a_float >= 0.95

    k = 120.0
    with torch.no_grad():
        for j in (3, 11, 19):
            m.fc1.weight[j] *= k
            m.fc1.bias[j] *= k
            m.fc2.weight[:, j] /= k
    assert _acc(m, x, y) == a_float  # the function is kept
    cal = [x[:64]]
    sd = m.state_dict()

    m_ptq = MLP()
    m_ptq.load_state_dict(sd)
    quantize_weights(m_ptq)
    calibrate_activations(m_ptq, cal)
    a_ptq = _acc(m_ptq, x, y)
    assert a_ptq <= a_float - 0.15

    m_qat = MLP()
    m_qat.load_state_dict(sd)
    enable_qat(m_qat, act=True)
    calibrate_activations(m_qat, cal)
    assert _acc(m_qat, x, y) == a_ptq  # the fake quant is the int8 path
    _finetune(m_qat, x, y)
    a_qat = _acc(m_qat, x, y)
    qat_serving_convert(m_qat)
    a_int8 = _acc(m_qat, x, y)
    assert a_int8 == a_qat
    assert a_int8 >= a_ptq + 0.10
    assert a_int8 >= a_float - 0.10


def test_disable_qat_keeps_scales(rng):
    jm, m = _pair(JMLP, MLP)
    enable_qat(m, act=True)
    JQ.enable_qat(jm, act=True)
    cal = [rng.normal(size=(4, 8)).astype(np.float32)]
    calibrate_activations(m, cal)
    JQ.calibrate_activations(jm, cal)
    assert disable_qat(m) == JQ.disable_qat(jm) == 2
    assert getattr(m.fc1, "a_scale", None) is not None
    assert not getattr(m.fc1, "_qat", False)
    x = rng.normal(size=(2, 8)).astype(np.float32)
    y_plain = _run(m, x)
    _close(y_plain, jm(jnp.asarray(x)))
    enable_qat(m, act=True)
    y_qat = _run(m, x)
    assert np.abs(y_plain - y_qat).max() > 0
    assert disable_qat(m, keep_scales=False) == 2
    assert getattr(m.fc1, "a_scale", None) is None


def test_qat_serving_convert_respects_enable_include(rng):
    """A layer that ``enable_qat(include=...)`` left float stays float
    after ``qat_serving_convert``; an explicit ``include`` converts it."""
    jm, m = _pair(JConvNet, ConvNet)
    skip_linear = (lambda p, mod: not isinstance(mod, nn.Linear))
    n = enable_qat(m, act=False, include=skip_linear)
    assert n == JQ.enable_qat(jm, act=False, include=lambda p, mod: not
                              isinstance(mod, jnn.Linear)) == 2
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    y_qat = _run(m, x)
    assert qat_serving_convert(m) == JQ.qat_serving_convert(jm) == 2
    assert m.conv1.weight.dtype == m.conv2.weight.dtype == torch.int8
    assert m.head.weight.dtype != torch.int8
    y_int8 = _run(m, x)
    np.testing.assert_allclose(y_qat, y_int8, rtol=1e-6, atol=1e-6)
    _close(y_int8, jm(jnp.asarray(x)))
    assert qat_serving_convert(m, include=lambda p, mod: True) == 1
    assert m.head.weight.dtype == torch.int8
