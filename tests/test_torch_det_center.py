"""The port's CenterNet and TTFNet against the JAX package on the CPU: the
heads, the decoded peaks and ``loss_fn`` at two frames, and the helpers
each on its own: ``gaussian_radius`` and both models' Gaussian targets.

Micro size, the JAX package's own (``tests/test_det_zoo4.py:68-95``):
CenterNet on a ResNet-18 trunk, TTFNet on its full DarkNet-53, 5 classes,
the top 20 peaks.  Weights are the JAX model's, copied by the bridge
(the deconvs' HWIO kernels onto torch's transposed layout); BatchNorm
statistics are drawn from a numpy seed.  The heads' last convs are
redrawn: the heatmaps at std 0.1 (CenterNet's also above its 0.1
threshold), the sizes at 0.5 (at their normal(0.01) init every box would
be a point), the offsets and TTFNet's distances at 0.1.  CenterNet runs at
64 px and 80 x 104 (a frame that is no multiple of 32); TTFNet, whose up
blocks add the backbone's levels at twice the size of the one below, only
at multiples of 32: 64 px and 96 x 160.  The JAX side runs under
``jax.jit``, one build per model and frame.

Tolerance: f32 within 2e-4 of the largest magnitude
(``tests/test_parity_resnet.py:91``); the loss within 2e-4 relative;
detections' labels and counts equal; the targets' cells equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_det_anchor import (bridged, check_stages, run_jax,
                                         run_port)
from tests.test_torch_fcos import _images, _targets
from tests.test_torch_seg_zoo import _close
from tlxcv_tpu.models.classification.resnet import ResNet as JResNet
from tlxcv_tpu.models.detection import centernet as JC
from tlxcv_tpu.models.detection import ttfnet as JT
from tlxcv_tpu_torch import create_model
from tlxcv_tpu_torch.models.classification.resnet import ResNet
from tlxcv_tpu_torch.models.detection import centernet as TC
from tlxcv_tpu_torch.models.detection import ttfnet as TT


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: these micro models' small ops gain nothing
    from more, and several test processes share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _center_draws(m):
    return ((m.hm_head.pred, 0.1), (m.wh_head.pred, 0.5),
            (m.off_head.pred, 0.1))


def _ttf_draws(m):
    return ((m.hm_head.pred, 0.1), (m.wh_head.pred, 0.1))


def _center(m, x, tg):
    hm, wh, off = m.head_outputs(x)
    return ((hm, wh, off), m.decode(hm, wh, off),
            m.loss_fn({"hm": hm, "wh": wh, "off": off}, tg))


def _ttf(m, x, tg):
    hm, wh = m.head_outputs(x)
    return (hm, wh), m.decode(hm, wh), m.loss_fn({"hm": hm, "wh": wh}, tg)


MODELS = {
    "centernet": (
        lambda: JC.CenterNet(num_classes=5, top_k=20, backbone=JResNet(
            depth=18, num_classes=0, with_pool=False)),
        lambda: TC.CenterNet(num_classes=5, top_k=20, device="cpu",
                             backbone=ResNet(depth=18, num_classes=0,
                                             with_pool=False, device="cpu")),
        _center_draws, _center, [(64, 64), (80, 104)]),
    "ttfnet": (lambda: JT.TTFNet(num_classes=5, top_k=20),
               lambda: TT.TTFNet(num_classes=5, top_k=20, device="cpu"),
               _ttf_draws, _ttf, [(64, 64), (96, 160)]),
}
CASES = [(name, hw) for name, spec in MODELS.items() for hw in spec[4]]


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(name):
        if name not in cache:
            jf, tf, draws = MODELS[name][:3]
            cache[name] = bridged(jf(), tf(),
                                  np.random.default_rng(len(cache) + 41),
                                  draws)
        return cache[name]
    return get


@pytest.mark.parametrize("name,hw", CASES,
                         ids=[f"{n}-{h}x{w}" for n, (h, w) in CASES])
def test_detector_matches_jax(rng, pairs, name, hw):
    """The heads, the top peaks decoded and ``loss_fn``."""
    jm, tm = pairs(name)
    fn = MODELS[name][3]
    x = _images(rng, hw)
    tg = _targets(rng, hw=hw)
    check_stages(run_port(tm, fn, x, tg), run_jax(jm, fn, x, tg))


def test_gaussian_radius_matches_jax():
    """Degenerate to large boxes, square and elongated."""
    h, w = (np.array(v, np.float32).reshape(-1) for v in np.meshgrid(
        [0, 1, 3, 4, 17, 64, 300], [0, 2, 4, 9, 64, 500]))
    want = JC.gaussian_radius(jnp.asarray(h), jnp.asarray(w))
    got = TC.gaussian_radius(torch.from_numpy(h), torch.from_numpy(w))
    _close(got, want, bound=1e-6)
    assert got[0] == 0 and got.max() > 30


def _gts():
    boxes = np.array([[[10, 10, 50, 50], [70, 30, 110, 90], [0, 0, 0, 0]],
                      [[3, 40, 9, 44], [20, 20, 120, 60], [0, 0, 0, 0]]],
                     np.float32)
    return (boxes, np.array([[0, 2, 0], [4, 1, 0]], np.int32),
            np.array([[1, 1, 0], [1, 1, 0]], np.float32))


@pytest.mark.parametrize("name", ["centernet", "ttfnet"])
def test_targets_match_jax(pairs, name):
    """Each model's Gaussian targets on a 32 x 32 map of a 128 px frame,
    one GT smaller than a cell: a 1.0 at the first image's GTs' cells
    (TTFNet's normalised peak), nothing for the padded GT's class.  TTFNet's box target is compared where its
    weight is not 0: far from every GT the Gaussians fall to subnormal
    values, which XLA's CPU flushes to 0 and torch keeps, so the owner of
    a cell of weight 0 may differ (the loss reads no such cell)."""
    jm, tm = pairs(name)
    boxes, labels, valid = _gts()
    want = [np.asarray(j) for j in jax.jit(
        lambda b, l, v: jm._targets(b, l, v, (32, 32)))(
            *map(jnp.asarray, (boxes, labels, valid)))]
    got = [t.numpy() for t in tm._targets(
        torch.from_numpy(boxes), torch.from_numpy(labels).long(),
        torch.from_numpy(valid), (32, 32))]
    if name == "ttfnet":
        live = want[2] > 0
        assert live.sum() > 20
        got[1], want[1] = got[1][live], want[1][live]
    for t, j in zip(got, want):
        if j.dtype.kind == "i":
            np.testing.assert_array_equal(t, j)
        else:
            _close(t, j, bound=1e-6)
    pos = np.asarray(want[0]) >= 1 - 1e-4
    assert pos[0, ..., 0].sum() >= 1 and pos[0, ..., 2].sum() >= 1
    assert pos[0, ..., 3].sum() == 0


def test_registry_builds_both():
    cn = create_model("centernet", device="cpu", num_classes=3)
    ttf = create_model("ttfnet", device="cpu", num_classes=3)
    assert cn.hm_head.pred.weight.shape[0] == 3
    assert ttf.wh_head.pred.weight.shape[0] == 4
    assert tuple(ttf.backbone.out_channels) == (256, 512, 1024)
    # the deconvs: torch's (in, out, kh, kw) layout, 4x4 at stride 2
    assert cn.deconvs[0].up.weight.shape == (256, 256, 4, 4)
