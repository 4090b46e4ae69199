"""The port's MobileNetV2, MobileNetV3 (small and large), EfficientNet
and GhostNet against the JAX package on the CPU.

Micro size: the JAX package's own frames (``tests/test_classifiers.py:
10-74``: 64 px, EfficientNet at 96) at half width (``scale`` 0.5;
EfficientNet's ``width_mult`` and ``depth_mult`` 0.5), 10 classes, b2.
Weights are the JAX model's, copied by the bridge, every BatchNorm's
statistics and affine drawn from a numpy seed first
(``tests/test_torch_cls_attention.py``).  The JAX side runs under
``jax.jit``.

Tolerance: logits in f32 within 2e-4 of their largest magnitude
(``tests/test_parity_resnet.py:91``); the bridge's keys exactly.
"""
import numpy as np
import pytest

from tests.test_torch_cls_attention import (_few_threads, _pair,  # noqa
                                            check_bridge_keys, check_logits,
                                            check_registry_builds,
                                            pairs_fixture)

MODELS = {
    "mobilenet_v2": (*_pair("mobilenet_v2", scale=0.5), 64),
    "mobilenet_v3_small": (*_pair("mobilenet_v3_small", scale=0.5), 64),
    "mobilenet_v3_large": (*_pair("mobilenet_v3_large", scale=0.5), 64),
    "efficientnet_half": (*_pair("EfficientNet", width_mult=0.5,
                                 depth_mult=0.5), 96),
    "ghostnet": (*_pair("ghostnet", scale=0.5), 64),
}


@pytest.fixture(scope="module")
def pairs():
    return pairs_fixture(MODELS)


@pytest.mark.parametrize("name", list(MODELS))
def test_logits_match_jax(rng, pairs, name):
    jm, tm = pairs(name)
    size = MODELS[name][2]
    check_logits(jm, tm, rng.normal(size=(2, size, size, 3)).astype(
        np.float32))


@pytest.mark.parametrize("name", list(MODELS))
def test_bridge_fills_every_key(pairs, name):
    check_bridge_keys(*pairs(name))


@pytest.mark.parametrize("name", ["mobilenet_v2", "mobilenet_v3_small",
                                  "mobilenet_v3_large", "ghostnet",
                                  *(f"efficientnet_b{i}" for i in range(8))])
def test_registry_builds(name):
    check_registry_builds(name)
