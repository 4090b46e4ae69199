"""The port's ConvNeXt, VAN and RedNet against the JAX package on the CPU,
and ``ops.image.unfold``, RedNet's im2col, on its own.

Micro size, the JAX package's own (``tests/test_classifiers.py:10-74``):
``convnext_micro``, ``van_b0`` and ``rednet26`` at 64 px, 10 classes, b2.
Weights are the JAX model's, copied by the bridge, after the parameters
that start at or near zero are drawn at O(1) from a numpy seed
(``tests/test_torch_cls_attention.py``): ConvNeXt's layer scale ``gamma``
(1e-6 at init), VAN's ``ls1`` and ``ls2`` (1e-2), every BatchNorm's
statistics and affine; RedNet's statistics then come from one train-mode
forward of two images, with its bottlenecks' last BatchNorm scale at
0.1.  The JAX side runs under ``jax.jit``.

Tolerance: logits in f32 within 2e-4 of their largest magnitude
(``tests/test_parity_resnet.py:91``); ``unfold`` and the bridge's keys
exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_cls_attention import (_few_threads, _pair,  # noqa
                                            check_bridge_keys, check_logits,
                                            check_registry_builds,
                                            pairs_fixture)
from tlxcv_tpu.models.classification import rednet as JR
from tlxcv_tpu.ops.image import unfold as jax_unfold
from tlxcv_tpu_torch.ops.image import unfold

MODELS = {
    "convnext_micro": (*_pair("ConvNeXt", depths=(1, 1, 2, 1),
                              dims=(16, 32, 64, 128)), 64),
    "van_b0": (*_pair("van_b0"), 64),
    "rednet26": (*_pair("rednet26"), 64),
}


def _damp_residual_branches(jm):
    """Each RedNet bottleneck's last BatchNorm scale at 0.1."""
    for _, mod in jm.modules():
        if isinstance(mod, JR.BottleneckRed):
            bn = mod.conv3.layers[1]
            bn.weight.value = jnp.full_like(bn.weight.value, 0.1)


@pytest.fixture(scope="module")
def pairs():
    # Involution multiplies a pixel's neighbours by weights made from the
    # pixel: a random RedNet squares any deviation from the images its
    # statistics came from, block after block (1e31 at 64 px on drawn
    # statistics, 1e12 on data ones), so its BatchNorms normalise data and
    # its residual branches start small, as chip_smoke.py's RedNet-50
    return pairs_fixture(MODELS, bn_from_data=("rednet26",),
                         prepare={"rednet26": _damp_residual_branches})


@pytest.mark.parametrize("name", list(MODELS))
def test_logits_match_jax(rng, pairs, name):
    jm, tm = pairs(name)
    size = MODELS[name][2]
    check_logits(jm, tm, rng.normal(size=(2, size, size, 3)).astype(
        np.float32))


@pytest.mark.parametrize("name", list(MODELS))
def test_bridge_fills_every_key(pairs, name):
    check_bridge_keys(*pairs(name))


def test_layer_scales_were_drawn(pairs):
    """The parity above ran with ConvNeXt's and VAN's layer scales at
    O(1), not at their 1e-6 and 1e-2 starts."""
    for name, attr in (("convnext_micro", "gamma"), ("van_b0", "ls1"),
                       ("van_b0", "ls2")):
        scales = [p for n, p in pairs(name)[1].named_parameters()
                  if n.endswith(attr)]
        assert scales
        assert min(float(p.detach().abs().mean()) for p in scales) > 0.3


@pytest.mark.parametrize("k,stride,padding,dilation", [
    (3, 1, 1, 1), (3, 2, 1, 1), (7, 1, 3, 1), (7, 2, 3, 1), (2, 2, 0, 1),
    (3, 1, 2, 2)])
def test_unfold_matches_jax(rng, k, stride, padding, dilation):
    """[N, L, C*kh*kw] with the values of a patch channel-major, as the
    reference's code returns them (its docstring says channel-last)."""
    x = rng.normal(size=(2, 9, 11, 5)).astype(np.float32)
    got, hw = unfold(torch.from_numpy(x), k, stride, padding, dilation)
    want, jhw = jax_unfold(jnp.asarray(x), k, stride, padding, dilation)
    assert hw == tuple(jhw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unfold_is_channel_major():
    """Value (c, i, j) of a patch sits at c*k*k + i*k + j."""
    x = torch.arange(4 * 4 * 3, dtype=torch.float32).reshape(1, 4, 4, 3)
    got, _ = unfold(x, 2, stride=2)
    first = got[0, 0].reshape(3, 2, 2)  # the top-left patch
    assert torch.equal(first, x[0, :2, :2].permute(2, 0, 1))


@pytest.mark.parametrize("name", ["convnext_tiny", "convnext_small",
                                  "convnext_base", "convnext_large", "van_b0",
                                  "van_b1", "rednet26", "rednet50",
                                  "rednet101"])
def test_registry_builds(name):
    check_registry_builds(name)
