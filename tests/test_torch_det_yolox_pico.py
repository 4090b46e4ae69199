"""The port's YOLOX and PicoDet against the JAX package on the CPU: the
head outputs, the detections and ``loss_fn`` at 64 px and at 80 x 104 (a
frame whose pyramid levels are not in 2:1 ratios, where the necks' nearest
resize is the half-pixel rule), and the helpers each on its own:
``simota_assign`` (a GT with no candidate, tied costs, random
predictions), ``_focus`` and PP-LCNet.

Micro size, the JAX package's own (``tests/test_det_zoo3.py``,
``tests/test_det_zoo4.py:101``): ``yolox_nano`` and ``PicoDet(scale=0.25,
neck_ch=32)``, 5 classes.  Weights are the JAX model's, copied by the
bridge; BatchNorm statistics are drawn from a numpy seed; the prediction
convs are redrawn (YOLOX's class and objectness at std 0.1, its box at
0.05; PicoDet's at 1.0 with its bias at -1), so that scores and boxes
spread.  The JAX side runs under ``jax.jit``, one build per model and
frame.

Tolerance: f32 within 2e-4 of the largest magnitude
(``tests/test_parity_resnet.py:91``); the loss within 2e-4 relative;
detections' labels and counts equal; assignments equal.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_det_anchor import (bridged, check_stages, run_jax,
                                         run_port)
from tests.test_torch_fcos import _images, _targets
from tests.test_torch_seg_zoo import _close, _flat, _random_bn
from tlxcv_tpu.core import pure, split
from tlxcv_tpu.models.detection import picodet as JP
from tlxcv_tpu_torch import create_model
from tlxcv_tpu_torch.models.detection import picodet as TP
from tlxcv_tpu_torch.models.detection import tood as TT
from tlxcv_tpu_torch.ops.space_to_depth import block_space_to_depth
from tlxcv_tpu_torch.utils import load_jax_params

# the packages export factories named as these modules: reach the modules
JY, TY, JL, TL = (importlib.import_module(f"{pkg}.models.{mod}") for pkg, mod
                  in (("tlxcv_tpu", "detection.yolox"),
                      ("tlxcv_tpu_torch", "detection.yolox"),
                      ("tlxcv_tpu", "classification.pp_lcnet"),
                      ("tlxcv_tpu_torch", "classification.pp_lcnet")))

FRAMES = [(64, 64), (80, 104)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: these micro models' small ops gain nothing
    from more, and several test processes share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _yolox_draws(m):
    h = m.head
    return ([(c, 0.1) for c in h.cls_preds] + [(c, 0.1) for c in h.obj_preds]
            + [(c, 0.05) for c in h.reg_preds])


def _pico_draws(m):
    for c in m.head.preds:  # the prior's -4.6 keeps every score under 0.03
        c.bias.value = jnp.full(c.bias.value.shape, -1.0, jnp.float32)
    return [(c, 1.0) for c in m.head.preds]


def _stages(m, x, tg):
    """Head outputs, detections and the loss on the eval-mode outputs."""
    outs, hws = m.head_outputs(x)
    return outs, m(x), m.loss_fn({"outs": outs, "feat_hws": hws}, tg)


MODELS = {
    "yolox_nano": (lambda: JY.yolox("yolox_nano", num_classes=5),
                   lambda: TY.yolox("yolox_nano", num_classes=5,
                                    device="cpu"), _yolox_draws),
    "picodet": (lambda: JP.PicoDet(num_classes=5, scale=0.25, neck_ch=32),
                lambda: TP.PicoDet(num_classes=5, scale=0.25, neck_ch=32,
                                   device="cpu"), _pico_draws),
}


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(name):
        if name not in cache:
            jf, tf, draws = MODELS[name]
            cache[name] = bridged(jf(), tf(),
                                  np.random.default_rng(len(cache) + 31),
                                  draws)
        return cache[name]
    return get


@pytest.mark.parametrize("hw", FRAMES, ids=["64x64", "80x104"])
@pytest.mark.parametrize("name", list(MODELS))
def test_detector_matches_jax(rng, pairs, name, hw):
    jm, tm = pairs(name)
    x = _images(rng, hw)
    tg = _targets(rng, hw=hw)
    check_stages(run_port(tm, _stages, x, tg), run_jax(jm, _stages, x, tg))


# ------------------------------------------------------------------ SimOTA
def _simota(*args, num_classes=2):
    want = jax.jit(JY.simota_assign, static_argnums=8)(
        *map(jnp.asarray, args), num_classes)
    got = TY.simota_assign(*map(torch.from_numpy, args), num_classes)
    for t, j in zip(got, want):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    return [t.numpy() for t in got]


def _grid(n=3):
    pts = np.array([[8.0, 8.0], [40.0, 40.0], [200.0, 200.0]],
                   np.float32)[:n]
    boxes = np.concatenate([pts - 4, pts + 4], -1).astype(np.float32)
    return pts, np.full(n, 8.0, np.float32), boxes


def test_simota_picks_the_covered_point():
    """The JAX package's own case (``tests/test_det_zoo3.py:80``)."""
    pts, strides, boxes = _grid()
    best, fg = _simota(boxes, np.array([[0.9, 0.1], [0.1, 0.9], [0.5, 0.5]],
                                       np.float32),
                       np.full(3, 0.9, np.float32), pts, strides,
                       np.array([[2, 2, 14, 14]], np.float32),
                       np.array([0], np.int32), np.array([1.0], np.float32))
    assert fg[0] and not fg[2] and best[0] == 0


def test_simota_zero_candidate_gt_selects_nothing():
    """A valid GT off the grid (``tests/test_det_zoo3.py:100``): no
    candidate, no foreground, though its 1e5-inflated costs rank."""
    pts, strides, boxes = _grid(2)
    _, fg = _simota(boxes, np.full((2, 2), 0.5, np.float32),
                    np.full(2, 0.5, np.float32), pts, strides,
                    np.array([[500, 500, 510, 510]], np.float32),
                    np.array([0], np.int32), np.array([1.0], np.float32))
    assert fg.sum() == 0


def test_simota_breaks_ties_in_index_order():
    """Twelve points with one box and one prediction between them: every
    cost ties, the dynamic k of 10 top IoUs of 0.25 is 2, and both
    frameworks take the first two, in index order."""
    pts = np.stack([np.full(12, 20.0), np.full(12, 20.0)], -1).astype(
        np.float32)
    boxes = np.tile(np.array([[10, 10, 30, 30]], np.float32), (12, 1))
    gt = np.array([[15, 15, 25, 25], [0, 0, 0, 0]], np.float32)
    best, fg = _simota(boxes, np.full((12, 2), 0.3, np.float32),
                       np.full(12, 0.8, np.float32), pts,
                       np.full(12, 8.0, np.float32), gt,
                       np.array([1, 0], np.int32),
                       np.array([1.0, 0.0], np.float32))
    assert fg.tolist() == [True, True] + [False] * 10
    assert not best[fg].any()


def test_simota_random_predictions_match_jax(rng):
    """Every cell of a 64 px yolox grid, random boxes and probabilities,
    three GTs, one padded; points two GTs claim go to the cheaper."""
    hws = ((8, 8), (4, 4), (2, 2))
    pts, strides = TT._points(hws, TY.STRIDES)  # YOLOX's cell centres
    jp, js = JY._grid_centers(hws)
    np.testing.assert_array_equal(pts, np.asarray(jp))
    np.testing.assert_array_equal(strides, np.asarray(js))
    p = len(pts)
    wh = rng.uniform(4, 40, size=(p, 2)).astype(np.float32)
    boxes = np.concatenate([pts - wh / 2, pts + wh / 2], -1)
    gt = np.array([[4, 4, 40, 36], [20, 10, 60, 50], [30, 30, 34, 34],
                   [0, 0, 0, 0]], np.float32)
    best, fg = _simota(boxes, rng.uniform(size=(p, 5)).astype(np.float32),
                       rng.uniform(size=p).astype(np.float32), pts,
                       strides, gt, np.array([0, 3, 4, 0], np.int32),
                       np.array([1, 1, 1, 0], np.float32), num_classes=5)
    assert fg.sum() > 3 and set(best[fg]) <= {0, 1, 2}


# ----------------------------------------------------------- the backbones
def test_focus_is_the_blocked_space_to_depth(rng):
    x = rng.normal(size=(2, 6, 10, 3)).astype(np.float32)
    got = TY._focus(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JY._focus(jnp.asarray(x))))
    assert torch.equal(got, block_space_to_depth(torch.from_numpy(x), 2, 2))


def test_pp_lcnet_matches_jax(rng):
    """The classifier PicoDet's backbone taps, with its squeeze-excites."""
    jm = JL.PPLCNet(scale=0.25, num_classes=7)
    _random_bn(jm, rng)
    tm = TL.PPLCNet(scale=0.25, num_classes=7, device="cpu")
    load_jax_params(tm, _flat(jm))
    x = _images(rng, (64, 64))
    want, _ = jax.jit(pure(jm))(*split(jm), jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    _close(got, want)


def test_registry_sizes_yolox_and_picodet():
    m = create_model("yolox_s", device="cpu", num_classes=3)
    assert m.backbone.out_channels == (128, 256, 512)
    assert len(m.backbone.dark3[1].blocks) == 3   # round(9 x 0.33)
    pico = create_model("picodet_lcnet", device="cpu", num_classes=3)
    assert pico.backbone.out_channels == (96, 192, 384)
    assert pico.head.preds[3].weight.shape[0] == 3 + 4 * 8
