"""The port's 3-D layers, I3D and the video task against the JAX package
on the CPU.

Layers: ``Conv3d`` at "SAME" (lax's rule: the odd pixel after) with
strides 1 and 2 on odd and even T, H, W, at explicit and integer pads,
with and without a bias; ``MaxPool3d`` and ``AvgPool3d`` (padding out of
the count) with pads; ``Embedding``; the bridge's DHWIO -> OIDHW layout.
I3D at its full width (it has no width knob) on a ``[1, 8, 32, 32, 3]``
clip: eval logits, a train-mode forward's logits and BatchNorm
statistics (dropout off on both sides), the BCE loss and ``predict``.
Weights are the JAX model's, copied by the bridge, every BatchNorm's
statistics and affine drawn first.  Tolerance: f32 within 2e-4 of the
largest magnitude (``tests/test_parity_resnet.py:91``); pools and the
embedding bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tlxcv_tpu.nn as jnn
import tlxcv_tpu_torch.nn as T
from tests.test_torch_cls_attention import _few_threads  # noqa: F401
from tests.test_torch_cls_classic import zero_init  # noqa: F401
from tests.test_torch_seg_zoo import _close, _flat, _no_dropout, _random_bn
from tlxcv_tpu.config import create_model as jax_create_model
from tlxcv_tpu.core import pure, split
from tlxcv_tpu.models.video_classification import InceptionI3d as JI3D
from tlxcv_tpu.tasks import VideoClassification as JVideo
from tlxcv_tpu_torch import create_model
from tlxcv_tpu_torch.models.video_classification import InceptionI3d
from tlxcv_tpu_torch.tasks import VideoClassification
from tlxcv_tpu_torch.utils import load_jax_params


def _layer_pair(jm, tm):
    load_jax_params(tm, _flat(jm))
    return tm


@pytest.mark.parametrize("shape,kernel,stride,padding,bias", [
    ((2, 8, 16, 16, 3), 7, 2, "SAME", False),      # I3D's stem, even sides
    ((1, 7, 9, 11, 3), 7, 2, "SAME", True),        # odd sides
    ((2, 5, 6, 7, 4), (3, 1, 2), (1, 2, 1), "SAME", True),
    ((1, 4, 8, 8, 8), 3, 1, "SAME", False),        # I3D's 3x3x3
    ((1, 6, 7, 8, 3), (3, 3, 2), (2, 1, 2), ((1, 2), (0, 1), (2, 0)), True),
    ((1, 5, 6, 7, 3), 3, 2, 1, True),              # integer pads
    ((1, 5, 6, 7, 3), (2, 3, 3), 1, "VALID", True),
])
def test_conv3d_matches_jax(rng, shape, kernel, stride, padding, bias):
    cin = shape[-1]
    jm = jnn.Conv3d(cin, 5, kernel, stride=stride, padding=padding,
                    bias=bias)
    if bias:
        jm.bias.value = jnp.asarray(rng.normal(size=(5,)), jnp.float32)
    tm = _layer_pair(jm, T.Conv3d(cin, 5, kernel, stride=stride,
                                  padding=padding, bias=bias, device="cpu"))
    x = rng.normal(size=shape).astype(np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got, jm(jnp.asarray(x)))


def test_bridge_takes_conv3d_weights_dhwio_to_oidhw(rng):
    jm = jnn.Conv3d(3, 4, (2, 3, 5), bias=True)
    tm = _layer_pair(jm, T.Conv3d(3, 4, (2, 3, 5), device="cpu"))
    w = np.asarray(jm.weight.value)
    assert w.shape == (2, 3, 5, 3, 4)
    np.testing.assert_array_equal(tm.weight.detach().numpy(),
                                  w.transpose(4, 3, 0, 1, 2))


@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("shape,window,stride,padding", [
    ((2, 8, 9, 10, 3), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ((1, 7, 8, 9, 2), 3, 2, 1),
    ((1, 6, 6, 6, 2), 3, 1, 1),
    ((1, 4, 5, 6, 2), (2, 2, 2), (2, 2, 2), 0),
    ((1, 5, 7, 6, 2), 3, 2, "SAME"),
])
def test_pool3d_matches_jax(rng, kind, shape, window, stride, padding):
    jcls, tcls = ((jnn.MaxPool3d, T.MaxPool3d) if kind == "max"
                  else (jnn.AvgPool3d, T.AvgPool3d))
    x = rng.normal(size=shape).astype(np.float32)
    want = jcls(window, stride, padding)(jnp.asarray(x))
    got = tcls(window, stride, padding)(torch.from_numpy(x))
    if kind == "max":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def test_embedding_matches_jax(rng):
    jm = jnn.Embedding(11, 6)
    tm = _layer_pair(jm, T.Embedding(11, 6, device="cpu"))
    ids = rng.integers(0, 11, size=(3, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        tm(torch.from_numpy(ids)).detach().numpy(),
        np.asarray(jm(jnp.asarray(ids))))
    assert tuple(tm.weight.shape) == (11, 6)


@pytest.fixture(scope="module")
def i3d():
    """I3D at full width, 7 classes, its BatchNorms drawn, dropout off on
    both sides, and its port; the JAX forward jitted in eval and in train
    mode."""
    rng = np.random.default_rng(11)
    jm = JVideo(JI3D(num_classes=7))
    _random_bn(jm, rng)
    tm = VideoClassification(InceptionI3d(num_classes=7, device="cpu"))
    load_jax_params(tm, _flat(jm))
    _no_dropout(jm, tm)
    fwd = pure(jm)
    return (jm, tm, jax.jit(lambda p, s, x: fwd(p, s, x)[0]),
            jax.jit(lambda p, s, x: fwd(p, s, x, training=True)))


def test_i3d_eval_logits_loss_and_predict_match_jax(rng, i3d):
    jm, tm, fwd, _ = i3d
    x = rng.normal(size=(1, 8, 32, 32, 3)).astype(np.float32)
    want = fwd(*split(jm), jnp.asarray(x))
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
        pred = tm.predict(torch.from_numpy(x))
    assert got.shape == (1, 1, 7)
    _close(got, want)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jnp.argmax(
        want, -1)))
    y = (rng.uniform(size=want.shape) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        tm.loss_fn(got, torch.from_numpy(y)).item(),
        float(jm.loss_fn(want, jnp.asarray(y))), rtol=1e-5)


def test_i3d_train_mode_statistics_match_jax(rng, i3d):
    jm, tm, _, train = i3d
    x = rng.normal(size=(1, 8, 32, 32, 3)).astype(np.float32)
    params, state = split(jm)
    want, new_state = train(params, state, jnp.asarray(x))
    tm.train()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
        buffers = {k: b.clone() for k, b in tm.named_buffers()}
    tm.load_state_dict({k.replace("/", "."): torch.tensor(np.asarray(v))
                        for k, v in state.items()}, strict=False)
    tm.eval()
    _close(got, want)
    assert len(new_state) == len(buffers) == 2 * 57
    for path, value in new_state.items():
        _close(buffers[path.replace("/", ".")], value)


def test_i3d_registry_builds(zero_init):
    """``create_model("i3d")`` under the JAX name with the JAX model's
    parameter count, 400 classes by default."""
    model = create_model("i3d", device="cpu")
    count = sum(a.size for a in _flat(jax_create_model("i3d")).values())
    assert sum(p.numel() for p in model.state_dict().values()) == count
    assert model.logits.conv.weight.shape[0] == 400
