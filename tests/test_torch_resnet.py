"""The port's ResNet slice against the JAX package on the CPU: BatchNorm,
the pools, Sequential and Activation, then resnet18 and resnet50 at full
width (64 px), with the JAX model's weights copied across by the bridge."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlxcv_tpu import nn as jnn
from tlxcv_tpu.core import call_context, pure, split
from tlxcv_tpu.models.classification import resnet as JR
from tlxcv_tpu_torch import create_model, list_models
from tlxcv_tpu_torch.models.classification import resnet as TR
from tlxcv_tpu_torch.nn import layers as T
from tlxcv_tpu_torch.utils import load_jax_params


def _flat(jax_module):
    params, state = split(jax_module)
    return {k: np.asarray(v) for k, v in {**params, **state}.items()}


def _random_bn_stats(jax_model, rng):
    """Non-trivial running statistics (fresh ones are mean 0 / var 1), as
    tests/test_quant.py sets them."""
    for _, mod in jax_model.modules():
        if isinstance(mod, jnn.BatchNorm):
            c = mod.running_mean.value.shape[0]
            mod.running_mean.value = jnp.asarray(
                rng.normal(scale=0.2, size=(c,)), jnp.float32)
            mod.running_var.value = jnp.asarray(
                rng.uniform(0.5, 2.0, size=(c,)), jnp.float32)


def _bn_pair(rng, c=12):
    jb = jnn.BatchNorm(c)
    jb.weight.value = jnp.asarray(rng.normal(size=c), jnp.float32)
    jb.bias.value = jnp.asarray(rng.normal(size=c), jnp.float32)
    jb.running_mean.value = jnp.asarray(rng.normal(size=c), jnp.float32)
    jb.running_var.value = jnp.asarray(rng.uniform(0.5, 2, c), jnp.float32)
    tb = T.BatchNorm(c, device="cpu")
    load_jax_params(tb, _flat(jb))
    return jb, tb


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_batchnorm_eval_matches_jax(rng, dtype):
    jb, tb = _bn_pair(rng)
    x = (rng.normal(size=(2, 5, 5, 12)) * 2 + 1).astype(np.float32)
    want = jb(jnp.asarray(x, dtype))
    with torch.no_grad():
        got = tb.eval()(torch.from_numpy(x).to(
            torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32))
    atol = 1e-5 if dtype == jnp.float32 else 5e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol)


def test_batchnorm_training_step_matches_jax(rng):
    """One training step: batch statistics normalise, and the running ones
    keep 0.9 of themselves (the JAX convention) with the unbiased
    variance."""
    jb, tb = _bn_pair(rng)
    x = (rng.normal(size=(3, 4, 4, 12)) * 3 - 1).astype(np.float32)
    params, state = split(jb)
    want, new_state = pure(jb)(params, state, jnp.asarray(x), training=True)
    got = tb.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    for name in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(tb, name).numpy(),
                                   np.asarray(new_state[name]), rtol=1e-6,
                                   atol=1e-6)


def test_folded_batchnorm_returns_its_input_object():
    bn = T.BatchNorm(4, device="cpu").eval()
    bn._folded = True
    x = torch.randn(1, 2, 2, 4)
    assert bn(x) is x
    with pytest.raises(RuntimeError):
        bn.train()(x)


@pytest.mark.parametrize("kind,k,s,p,hw", [
    ("max", 3, 2, 1, 9),        # the ResNet stem pool
    ("max", 2, None, 0, 8),
    ("max", 3, 2, "SAME", 10),
    ("avg", 3, 1, 1, 7),        # padding left out of the count
    ("avg", 2, 2, 0, 8),
    ("avg", 3, 2, "SAME", 9),
])
def test_pools_match_jax(rng, kind, k, s, p, hw):
    x = rng.normal(size=(2, hw, hw, 5)).astype(np.float32)
    jcls, tcls = {"max": (jnn.MaxPool2d, T.MaxPool2d),
                  "avg": (jnn.AvgPool2d, T.AvgPool2d)}[kind]
    want = np.asarray(jcls(k, s, p)(jnp.asarray(x)))
    got = tcls(k, s, p)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_maxpool_takes_int8_codes(rng):
    """int8 input, padded with the type's least value as the reference."""
    x = rng.integers(-127, 128, size=(2, 7, 7, 3)).astype(np.int8)
    want = np.asarray(jnn.MaxPool2d(3, 2, 1)(jnp.asarray(x)))
    got = T.MaxPool2d(3, 2, 1)(torch.from_numpy(x))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("out,hw", [((2, 2), 8), ((3, 3), 8), (1, 7)])
def test_adaptive_and_global_pools_match_jax(rng, out, hw):
    x = rng.normal(size=(2, hw, hw, 4)).astype(np.float32)
    want = np.asarray(jnn.AdaptiveAvgPool2d(out)(jnp.asarray(x)))
    got = T.AdaptiveAvgPool2d(out)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    for keep in (False, True):
        want = np.asarray(jnn.GlobalAvgPool2d(keep)(jnp.asarray(x)))
        got = T.GlobalAvgPool2d(keep)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_sequential_and_activation_keep_the_jax_paths(rng):
    jseq = jnn.Sequential(jnn.Linear(6, 5), jnn.Activation("relu"),
                          jnn.Linear(5, 3))
    tseq = T.Sequential(T.Linear(6, 5, device="cpu"), T.Activation("relu"),
                        T.Linear(5, 3, device="cpu"))
    flat = _flat(jseq)
    assert "layers/0/weight" in flat
    load_jax_params(tseq, flat)
    x = rng.normal(size=(4, 6)).astype(np.float32)
    with torch.no_grad():
        got = tseq(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jseq(jnp.asarray(x))),
                               atol=1e-6)
    assert len(tseq) == 3 and isinstance(tseq[1], T.Activation)


def _resnet_pair(name, rng, **kw):
    jm = getattr(JR, name)(**kw)
    _random_bn_stats(jm, rng)
    tm = create_model(name, device="cpu", **kw)
    load_jax_params(tm, _flat(jm))
    return jm, tm.eval()


@pytest.mark.parametrize("name,kw", [
    ("resnet18", {"num_classes": 10}),
    ("resnet50", {}),              # full width, 1000 classes
])
def test_resnet_matches_jax(rng, name, kw):
    """f32 logits and the C2-C5 features within 2e-4, as
    tests/test_parity_resnet.py holds the JAX ResNet against torch."""
    jm, tm = _resnet_pair(name, rng, **kw)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    want, _ = pure(jm)(*split(jm), jnp.asarray(x))
    with call_context(training=False):
        want_feats = jm.features(jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
        feats = tm.features(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)
    assert [f.shape[-1] for f in feats] == tm.feat_channels
    for f, w in zip(feats, want_feats):
        np.testing.assert_allclose(f.numpy(), np.asarray(w), atol=2e-4,
                                   rtol=2e-4)


def test_registry_holds_the_resnet_factories():
    resnets = [n for n in list_models()  # not resnest50, res2net*, se_*
               if n.startswith(("resnet", "resnext", "wide_resnet"))]
    assert resnets == sorted(JR.__all__[1:])
    for name in ("resnet34", "resnext50_32x4d"):  # basic / grouped blocks
        tm = create_model(name, device="cpu", num_classes=3)
        jm = getattr(JR, name)(num_classes=3)
        assert sorted(k.replace(".", "/") for k in tm.state_dict()) == \
            sorted(_flat(jm)), name


def test_resnet_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; ResNet() would use it")
    with pytest.raises(RuntimeError):
        TR.resnet18()
