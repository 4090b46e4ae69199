"""The port's classic CNNs, the second half of the classification zoo
(AlexNet, VGG, SqueezeNet, GoogLeNet, Inception-v3, DenseNet, Xception and
its DeepLab variant, ShuffleNetV2, ESNet, PP-LCNetV2, MixNet, ReXNet,
PeleeNet, HarDNet, DPN, DLA, CSPDarkNet and DarkNet-53), against the JAX
package on the CPU, and their helpers each on its own: the channel
shuffle, MixNet's splits, ReXNet's shortcut, HarDNet's links.

Micro size: the JAX package's own frames (``tests/test_classifiers.py:
10-74``, ``tests/test_classifier_variants.py:16-24``: 96 px, AlexNet 128,
the variants 64) at their published widths, which these models do not
scale; Inception-v3 at its published 299 px.  10 classes, b2.  Weights
are the JAX model's, copied by the bridge, every BatchNorm's statistics
and affine drawn from a numpy seed first
(``tests/test_torch_cls_attention.py``).  The JAX side runs under
``jax.jit``.

Tolerance: logits in f32 within 2e-4 of their largest magnitude
(``tests/test_parity_resnet.py:91``); the bridge's keys, the channel
shuffle, the splits, the shortcut and the links exactly.  The registry's
models are built at full size and hold the JAX model's parameter count.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_cls_attention import (_few_threads, _pair,  # noqa
                                            check_bridge_keys, check_logits,
                                            pairs_fixture)
from tests.test_torch_seg_zoo import _flat
from tlxcv_tpu.config import create_model as jax_create_model
from tlxcv_tpu.core import init as jax_init
from tlxcv_tpu.models.classification import mixnet as JMX
from tlxcv_tpu.models.classification import rexnet as JRX
from tlxcv_tpu.models.classification import shufflenetv2 as JSH
from tlxcv_tpu_torch import create_model
from tlxcv_tpu_torch.core import init as torch_init
from tlxcv_tpu_torch.models.classification import mixnet as TMX
from tlxcv_tpu_torch.models.classification import rexnet as TRX
from tlxcv_tpu_torch.models.classification import shufflenetv2 as TSH
from tlxcv_tpu_torch.utils import load_jax_params

# the packages export a factory named as the module
JPL = importlib.import_module("tlxcv_tpu.models.classification.peleenet")
TPL = importlib.import_module("tlxcv_tpu_torch.models.classification.peleenet")

MODELS = {
    "alexnet": (*_pair("alexnet"), 128),
    "vgg11_bn": (*_pair("vgg11", batch_norm=True), 96),
    "squeezenet1_0": (*_pair("squeezenet1_0"), 96),
    "squeezenet1_1": (*_pair("squeezenet1_1"), 96),
    "googlenet": (*_pair("googlenet"), 96),
    "inception_v3": (*_pair("inception_v3"), 299),
    "densenet121": (*_pair("densenet121"), 96),
    "xception41": (*_pair("xception41"), 96),
    "xception41_deeplab": (*_pair("xception41_deeplab"), 64),
    "shufflenet_v2_x0_5": (*_pair("shufflenet_v2_x0_5"), 96),
    "esnet_x0_5": (*_pair("esnet_x0_5"), 64),
    "pp_lcnet_v2": (*_pair("pp_lcnet_v2"), 64),
    "mixnet_s": (*_pair("mixnet_s"), 64),
    "rexnet_1_0": (*_pair("rexnet_1_0"), 64),
    "peleenet": (*_pair("peleenet"), 64),
    "hardnet39": (*_pair("hardnet39"), 64),
    "hardnet68": (*_pair("hardnet68"), 64),
    "dpn68": (*_pair("dpn68"), 64),
    "dla34": (*_pair("dla34"), 64),
    "dla102": (*_pair("dla102"), 64),
    "cspdarknet53": (*_pair("cspdarknet53"), 64),
    "darknet53_cls": (*_pair("darknet53_cls"), 64),
}

# every factory of the second half, and the JAX package's aliases
FACTORIES = ["alexnet", "vgg11", "vgg13", "vgg16", "vgg19", "googlenet",
             "squeezenet1_0", "squeezenet1_1", "densenet121", "densenet161",
             "densenet169", "densenet201", "densenet264", "inception_v3",
             "xception", "xception41", "xception65", "xception_deeplab",
             "xception41_deeplab", "xception65_deeplab",
             "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
             "shufflenet_v2_x0_5", "shufflenet_v2_x1_0",
             "shufflenet_v2_x1_5", "shufflenet_v2_x2_0", "esnet_x0_5",
             "esnet_x1_0", "pp_lcnet_v2", "mixnet_s", "mixnet_m",
             "rexnet_1_0", "rexnet_1_3", "peleenet", "hardnet39",
             "hardnet68", "hardnet85", "dpn68", "dpn107", "dla34", "dla102",
             "cspdarknet53", "darknet53_cls", "darknet53", "rexnet"]


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


class _ZeroRng:
    """Stands in for the JAX package's numpy initializer stream: zeros of
    each shape asked for."""

    def __getattr__(self, _):
        return lambda *a, size=None, **k: np.zeros(size, np.float32)


def _zeros(shape, *args, generator=None, device=None, **kwargs):
    return torch.zeros(shape, device=device)


@pytest.fixture
def zero_init(monkeypatch):
    """Both packages' random initializers give zeros: a parameter count
    does not read the values, and drawing the full-size models' weights
    (VGG's 130M, DPN-107's 87M) would take most of a registry test."""
    monkeypatch.setattr(jax_init, "_rng", _ZeroRng())
    for name in ("normal", "uniform", "truncated_normal"):
        monkeypatch.setattr(torch_init, name, _zeros)


@pytest.mark.parametrize("name", FACTORIES)
def test_registry_builds(zero_init, name):
    """``create_model`` builds the factory on the CPU under the JAX name,
    with the JAX model's parameter count."""
    model = create_model(name, device="cpu", num_classes=10)
    assert next(model.parameters()).device.type == "cpu"
    count = sum(a.size for a in _flat(jax_create_model(name,
                                                       num_classes=10)).values())
    assert sum(p.numel() for p in model.state_dict().values()) == count


@pytest.mark.parametrize("groups,c", [(2, 4), (2, 116), (3, 12), (4, 8)])
def test_channel_shuffle_is_bitwise_the_references(rng, groups, c):
    x = rng.normal(size=(2, 3, 5, c)).astype(np.float32)
    got = TSH.channel_shuffle(torch.from_numpy(x), groups)
    want = np.asarray(JSH.channel_shuffle(jnp.asarray(x), groups))
    np.testing.assert_array_equal(got.numpy(), want)
    # output channel j * groups + g is input channel g * c / groups + j
    np.testing.assert_array_equal(got.numpy()[..., 1],
                                  x[..., c // groups])


@pytest.mark.parametrize("channels,kernels", [
    (16, (3,)), (144, (3, 5, 7)), (240, (3, 5)), (360, (3, 5, 7, 9)),
    (722, (3, 5, 7, 9, 11)), (1200, (3, 5, 7, 9))])
def test_mixnet_splits_are_the_references(rng, channels, kernels):
    """Uneven splits give the first group the remainder; the mixed conv
    on drawn weights matches the JAX one."""
    jm = JMX.MixedDWConv(channels, kernels)
    tm = TMX.MixedDWConv(channels, kernels, device="cpu")
    assert tm.splits == jm.splits == TMX.split_channels(channels,
                                                        len(kernels))
    assert sum(tm.splits) == channels
    load_jax_params(tm, _flat(jm))
    x = rng.normal(size=(1, 9, 9, channels)).astype(np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    want = np.asarray(jm(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("cin,cout", [(16, 16), (16, 27), (38, 50)])
def test_rexnet_shortcut_pads_channels(rng, cin, cout):
    """The shortcut adds the input onto the first ``cin`` output
    channels and leaves the rest, as the JAX block does."""
    out = rng.normal(size=(2, 4, 4, cout)).astype(np.float32)
    x = rng.normal(size=(2, 4, 4, cin)).astype(np.float32)
    got = TRX.channel_pad_add(torch.from_numpy(out),
                              torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got[..., :cin], out[..., :cin] + x)
    np.testing.assert_array_equal(got[..., cin:], out[..., cin:])
    jb = JRX.LinearBottleneck(cin, cout, 6, 1)
    tb = TRX.LinearBottleneck(cin, cout, 6, 1, device="cpu")
    assert tb.use_shortcut == jb.use_shortcut


@pytest.mark.parametrize("n_layers,depthwise", [(4, True), (8, False),
                                                (16, False)])
def test_hardnet_links_are_the_references(n_layers, depthwise):
    jb = JPL.HarDBlock(48, 16, 1.7, n_layers, depthwise=depthwise)
    tb = TPL.HarDBlock(48, 16, 1.7, n_layers, depthwise=depthwise,
                       device="cpu")
    assert tb.links == jb.links
    assert tb.out_channels == jb.out_channels


def test_mixnet_m_fails_as_the_reference_does(zero_init, rng):
    """A defect of the reference kept on purpose: ``mixnet_m``'s 24-channel
    stem feeds a first block built for 16, whose depthwise conv (16
    groups) cannot take 24 channels.  Both packages build the model and
    fail in its forward, at any size (on zero weights: the failure is one
    of shapes)."""
    x = rng.normal(size=(1, 64, 64, 3)).astype(np.float32)
    jm = jax_create_model("mixnet_m", num_classes=10)
    assert jm.stem[0].weight.value.shape[-1] == 24
    with pytest.raises(Exception, match="16"):
        jm(jnp.asarray(x))
    tm = create_model("mixnet_m", device="cpu", num_classes=10).eval()
    assert tm.blocks[0].dw.convs[0].weight.shape == (16, 1, 3, 3)
    with pytest.raises(RuntimeError, match="groups=16.*24 channels"):
        with torch.no_grad():
            tm(torch.from_numpy(x))
