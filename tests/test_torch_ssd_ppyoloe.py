"""The port's SSD-MobileNetV1 and PP-YOLOE against the JAX package on the
CPU, on the reference's own micro detectors (tests/test_ssd.py:
``SSD(num_classes=5, image_size=(96, 96), keep_top_k=10)`` at 96^2;
tests/test_ppyoloe.py: ``ppyoloe("ppyoloe_s", num_classes=4)`` at 64^2),
with random BatchNorm statistics and weights carried across by
``load_jax_params(strict=True)``.  PP-YOLOE's prediction convs are zero
at init (every score 0.01, every box alike), so both copies get them drawn
from a seeded normal first.  Features and head outputs within 2e-4 of each
stage's largest value (f32, other summation orders); priors and anchors
exact; the NMS equal on the same decoded inputs.  Also MobileNetV1 alone,
``ops/anchors.py``, ``ops/post_process.py`` and the nearest 2x route."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlxcv_tpu import nn as jnn
from tlxcv_tpu.core import pure, split
from tlxcv_tpu.models.classification.mobilenetv1 import \
    mobilenet_v1 as j_mobilenet_v1
from tlxcv_tpu.models.detection import ssd as jssd
from tlxcv_tpu.ops import anchors as janchors
from tlxcv_tpu.ops import multiclass_nms as j_multiclass_nms
from tlxcv_tpu.ops import post_process as jpost
from tlxcv_tpu_torch import create_model, list_models
from tlxcv_tpu_torch.models.classification import mobilenet_v1
from tlxcv_tpu_torch.models.detection import ssd as tssd
from tlxcv_tpu_torch.ops import anchors as tanchors
from tlxcv_tpu_torch.ops import post_process as tpost
from tlxcv_tpu_torch.ops.image import interpolate
from tlxcv_tpu_torch.tasks import ObjectDetection
from tlxcv_tpu_torch.utils import load_jax_params

# the packages export a function ``ppyoloe`` under the module's name
jppyoloe = importlib.import_module("tlxcv_tpu.models.detection.ppyoloe")
tppyoloe = importlib.import_module("tlxcv_tpu_torch.models.detection.ppyoloe")

REL = 2e-4
SSD_CFG = dict(num_classes=5, image_size=(96, 96), keep_top_k=10)
PPYOLOE_NMS = dict(score_threshold=0.01, nms_threshold=0.6, nms_top_k=200,
                   keep_top_k=10)


def _flat(jax_module):
    params, state = split(jax_module)
    return {k: np.asarray(v) for k, v in {**params, **state}.items()}


def _random_bn_statistics(jm, rng):
    for _, mod in jm.modules():
        if isinstance(mod, jnn.BatchNorm):
            c = mod.running_mean.value.shape[0]
            mod.running_mean.value = jnp.asarray(
                rng.normal(scale=0.2, size=(c,)), jnp.float32)
            mod.running_var.value = jnp.asarray(
                rng.uniform(0.5, 2.0, size=(c,)), jnp.float32)


def _assert_rel(got, want, rel=REL, what=""):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (what, err)


def _t(x):
    return torch.from_numpy(np.array(x))


def _run(jm, fn, x):
    return jax.jit(lambda p, s, v: pure(jm, fn)(p, s, v)[0])(
        *split(jm), jnp.asarray(x))


def _assert_same_dets(got, want):
    """Equal on the same inputs: counts, labels, scores and boxes."""
    (gd, gc), (wd, wc) = got, want
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


@pytest.fixture(scope="module")
def ssd_pair():
    rng = np.random.default_rng(0)
    jm = jssd.SSD(**SSD_CFG)
    _random_bn_statistics(jm, rng)
    tm = tssd.SSD(**SSD_CFG, device="cpu")
    load_jax_params(tm, _flat(jm), strict=True)
    tm.eval()
    x = rng.normal(size=(2, 96, 96, 3)).astype(np.float32)
    feats = _run(jm, lambda m, v: m.backbone(v), x)
    heads = _run(jm, lambda m, v: m.ssd_head(m.backbone(v)), x)
    return jm, tm, x, feats, heads


@pytest.fixture(scope="module")
def ppyoloe_pair():
    rng = np.random.default_rng(1)
    jm = jppyoloe.ppyoloe("ppyoloe_s", num_classes=4, nms_cfg=PPYOLOE_NMS)
    _random_bn_statistics(jm, rng)
    head = jm.yolo_head
    for conv in (*head.pred_cls, *head.pred_reg):  # zero at init: redraw
        conv.weight.value = jnp.asarray(rng.normal(
            scale=0.02, size=conv.weight.value.shape), jnp.float32)
        conv.bias.value = jnp.asarray(rng.normal(
            scale=0.5, size=conv.bias.value.shape), jnp.float32)
    tm = tppyoloe.ppyoloe("ppyoloe_s", num_classes=4, nms_cfg=PPYOLOE_NMS,
                          device="cpu")
    load_jax_params(tm, _flat(jm), strict=True)
    tm.eval()
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    want = {"backbone": _run(jm, lambda m, v: m.backbone(v), x),
            "neck": _run(jm, lambda m, v: m.neck(m.backbone(v)), x),
            "head": _run(jm, lambda m, v: m.yolo_head(
                m.neck(m.backbone(v)))[:2], x)}
    return jm, tm, x, want


# ---------------------------------------------------------------- shared
def test_mobilenet_v1_logits_match_jax():
    rng = np.random.default_rng(2)
    jm = j_mobilenet_v1(num_classes=10)
    _random_bn_statistics(jm, rng)
    tm = mobilenet_v1(num_classes=10, device="cpu")
    load_jax_params(tm, _flat(jm), strict=True)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    want = _run(jm, lambda m, v: m(v), x)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    _assert_rel(got, want, what="logits")
    assert tm.blocks[0].dw.conv.groups == 32


def test_anchor_functions_are_the_reference():
    hws = [(19, 19), (10, 10), (5, 5), (3, 3), (2, 2), (1, 1)]
    np.testing.assert_array_equal(tanchors.ssd_prior_boxes(hws, (300, 300)),
                                  janchors.ssd_prior_boxes(hws, (300, 300)))
    for kw in (dict(clip=True), dict(min_max_aspect_ratios_order=True),
               dict(flip=True, steps=(8.0, 8.0))):
        got = tanchors.ssd_prior_box((7, 5), (64, 48), [16.0], [32.0],
                                     (2.0, 3.0), **kw)
        want = janchors.ssd_prior_box((7, 5), (64, 48), [16.0], [32.0],
                                      (2.0, 3.0), **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    args = ([(8, 8), (4, 4), (2, 2)], (8, 16, 32))
    for g, w in zip(tanchors.anchor_points(*args),
                    janchors.anchor_points(*args)):
        np.testing.assert_array_equal(g, w)
    got, want = (m.grid_cell_anchors(*args) for m in (tanchors, janchors))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nearest_2x_route_is_bitwise_jax_resize(dtype):
    """PP-YOLOE's and YOLOv3's top-down route: ``interpolate`` nearest 2x
    equals ``jax.image.resize(..., "nearest")`` bit for bit."""
    x = np.random.default_rng(3).normal(size=(2, 5, 7, 6)).astype(
        np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jax.image.resize(jnp.asarray(x, jdt), (2, 10, 14, 6), "nearest")
    got = interpolate(torch.from_numpy(x).to(dtype), size=(10, 14),
                      mode="nearest")
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_post_process_matches_jax():
    rng = np.random.default_rng(4)
    dets = np.zeros((2, 5, 6), np.float32)
    dets[..., 0] = rng.integers(0, 3, size=(2, 5))
    dets[..., 1] = rng.uniform(size=(2, 5))
    xy = rng.uniform(-20, 140, size=(2, 5, 2, 2))
    dets[..., 2:] = np.sort(xy, axis=2).reshape(2, 5, 4)
    dets[0, 3] = [-1, 0, 0, 0, 0, 0]
    dets[1, 1, 4] = dets[1, 1, 2]  # zero width
    counts = np.asarray([4, 5], np.int32)
    scale = np.asarray([[0.5, 0.8], [1.25, 1.0]], np.float32)
    orig = np.asarray([[200, 150], [96, 128]], np.int32)
    for hw in (None, orig):
        want = jpost.rescale_dets(jnp.asarray(dets), jnp.asarray(counts),
                                  jnp.asarray(scale),
                                  None if hw is None else jnp.asarray(hw))
        got = tpost.rescale_dets(_t(dets), _t(counts), _t(scale),
                                 None if hw is None else _t(hw))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-6, atol=0)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        for g, w in zip(tpost.cvt_results(*got),
                        jpost.cvt_results(*want)):
            assert g.keys() == w.keys()
            for key in g:
                np.testing.assert_allclose(g[key], w[key], rtol=1e-6)
                assert g[key].dtype == w[key].dtype


def test_registry_lists_the_detectors():
    names = set(list_models())
    assert {"ssd", "detr", "mobilenet_v1", "ppyoloe_s", "ppyoloe_m",
            "ppyoloe_l", "ppyoloe_x"} <= names
    m = create_model("ppyoloe_m", device="cpu", num_classes=3)
    assert m.neck.out_channels == [576, 288, 144]
    assert m.yolo_head.pred_cls[0].weight.shape[0] == 3


# ------------------------------------------------------------------- SSD
def test_ssd_bridge_carries_every_tensor(ssd_pair):
    jm, tm = ssd_pair[:2]
    assert sorted(k.replace(".", "/") for k in tm.state_dict()) == \
        sorted(_flat(jm))


def test_ssd_backbone_features_match_jax(ssd_pair):
    _, tm, x, want, _ = ssd_pair
    with torch.no_grad():
        got = tm.backbone(torch.from_numpy(x))
    assert [tuple(g.shape[1:]) for g in got] == [
        (6, 6, 512), (3, 3, 1024), (2, 2, 512), (1, 1, 256), (1, 1, 256),
        (1, 1, 128)]
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_rel(g, w, what=f"level {i}")


def test_ssd_head_outputs_match_jax(ssd_pair):
    _, tm, x, _, want = ssd_pair
    with torch.no_grad():
        boxes, scores, priors = tm.head_outputs(torch.from_numpy(x))
    _assert_rel(boxes, want[0], what="box deltas")
    _assert_rel(scores, want[1], what="class logits")
    assert priors.shape == (boxes.shape[1], 4)


def test_ssd_priors_are_the_reference(ssd_pair):
    """Exact at the micro size and at SSD300's 1917 priors; built once per
    feature sizes and device."""
    _, tm, x, feats, _ = ssd_pair
    hws = [f.shape[1:3] for f in feats]
    got = tm.priors(hws, "cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  jssd.build_ssd_priors(hws, (96, 96)))
    assert tm.priors(hws, torch.device("cpu")) is got
    hws300 = [(19, 19), (10, 10), (5, 5), (3, 3), (2, 2), (1, 1)]
    p300 = tssd.build_ssd_priors(hws300)
    assert p300.shape == (1917, 4)
    np.testing.assert_array_equal(p300, jssd.build_ssd_priors(hws300))


def _jax_ssd_decode(jm, heads, hw):
    """The reference's eval path up to NMS (ssd.py:227-232)."""
    boxes, scores = heads
    priors = jssd.build_ssd_priors(
        [(6, 6), (3, 3), (2, 2), (1, 1), (1, 1), (1, 1)], jm.image_size)
    h, w = hw
    decoded = jssd.ssd_decode(boxes, priors) * jnp.asarray([w, h, w, h],
                                                           jnp.float32)
    return decoded, jax.nn.softmax(scores, -1)[..., :-1]


def test_ssd_decode_and_nms_match_jax(ssd_pair):
    """From the JAX model's head outputs: boxes within 1e-4 px and
    probabilities within 1e-6; the NMS on the JAX decode equal."""
    jm, tm, x, _, heads = ssd_pair
    want = _jax_ssd_decode(jm, heads, (96, 96))
    priors = tm.priors([(6, 6), (3, 3), (2, 2), (1, 1), (1, 1), (1, 1)],
                       "cpu")
    got = tm.decode(_t(heads[0]), _t(heads[1]), priors, (96, 96))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=1e-6)
    wd = j_multiclass_nms(*want, **jm.nms_cfg)
    gd = tm.nms(_t(want[0]), _t(want[1]))
    assert gd[0].shape == (2, 10, 6) and int(gd[1].min()) > 0
    _assert_same_dets(gd, wd)


def test_ssd_predict_is_its_stages(ssd_pair):
    _, tm, x, _, _ = ssd_pair
    xt = torch.from_numpy(x)
    with torch.no_grad():
        dets, counts = ObjectDetection(tm).predict(xt)
        staged = tm.nms(*tm.decode(*tm.head_outputs(xt), (96, 96)))
    assert dets.shape == (2, 10, 6) and int(counts.min()) > 0
    _assert_same_dets((dets, counts), staged)


# -------------------------------------------------------------- PP-YOLOE
def test_ppyoloe_bridge_carries_every_tensor(ppyoloe_pair):
    jm, tm = ppyoloe_pair[:2]
    assert sorted(k.replace(".", "/") for k in tm.state_dict()) == \
        sorted(_flat(jm))


def test_ppyoloe_backbone_and_neck_match_jax(ppyoloe_pair):
    _, tm, x, want = ppyoloe_pair
    with torch.no_grad():
        feats = tm.backbone(torch.from_numpy(x))
        neck = tm.neck(feats)
    assert [tuple(f.shape[1:]) for f in neck] == [
        (2, 2, 384), (4, 4, 192), (8, 8, 96)]
    for i, (g, w) in enumerate(zip(feats, want["backbone"])):
        _assert_rel(g, w, what=f"backbone {i}")
    for i, (g, w) in enumerate(zip(neck, want["neck"])):
        _assert_rel(g, w, what=f"neck {i}")


def test_ppyoloe_head_outputs_match_jax(ppyoloe_pair):
    _, tm, x, want = ppyoloe_pair
    with torch.no_grad():
        scores, dists, hws = tm.head_outputs(torch.from_numpy(x))
    assert hws == ((2, 2), (4, 4), (8, 8))
    _assert_rel(scores, want["head"][0], what="scores")
    _assert_rel(dists, want["head"][1], what="distance logits")
    spread = float(scores.std())
    assert spread > 0.05, spread  # the redrawn heads score apart


def test_ppyoloe_anchors_are_the_reference(ppyoloe_pair):
    jm, tm = ppyoloe_pair[:2]
    hws = ((2, 2), (4, 4), (8, 8))
    got = tm.yolo_head._anchors(hws, torch.device("cpu"))
    want = jm.yolo_head._anchors(hws)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[3] == want[3] == [4, 16, 64]
    assert tm.yolo_head._anchors(hws, torch.device("cpu")) is got


def test_ppyoloe_decode_and_nms_match_jax(ppyoloe_pair):
    """From the JAX model's head outputs: boxes within 1e-4 px; the NMS on
    the JAX decode equal."""
    jm, tm, _, want = ppyoloe_pair
    scores, dists = want["head"]
    hws = ((2, 2), (4, 4), (8, 8))
    head = jm.yolo_head
    _, points, strides, _ = head._anchors(hws)
    wboxes = head._bbox_decode(points / strides, dists) * strides
    gboxes, gscores = tm.yolo_head.decode((_t(scores), _t(dists), hws))
    np.testing.assert_allclose(gboxes.numpy(), np.asarray(wboxes), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(gscores.numpy(), np.asarray(scores))
    wd = j_multiclass_nms(wboxes, scores, **head.nms_cfg)
    gd = tm.yolo_head.nms(_t(wboxes), _t(scores))
    assert gd[0].shape == (2, 10, 6) and int(gd[1].min()) > 0
    _assert_same_dets(gd, wd)


def test_ppyoloe_predict_is_its_stages(ppyoloe_pair):
    _, tm, x, _ = ppyoloe_pair
    xt = torch.from_numpy(x)
    with torch.no_grad():
        dets, counts = ObjectDetection(tm).predict(xt)
        staged = tm.yolo_head.nms(*tm.yolo_head.decode(tm.head_outputs(xt)))
    assert int(counts.min()) > 0
    _assert_same_dets((dets, counts), staged)


@pytest.mark.parametrize("which", ["ssd_pair", "ppyoloe_pair"])
def test_losses_raise_until_training_is_ported(request, which):
    """Training is ported (tests/test_torch_ppyoloe_ssd_train.py): each
    ``loss_fn`` takes its model's training outputs, built here from the
    eval-mode head so the fixtures' statistics stay, and returns a finite
    loss."""
    _, tm, x = request.getfixturevalue(which)[:3]
    x = torch.from_numpy(x)
    with torch.no_grad():
        if which == "ssd_pair":
            boxes, scores, priors = tm.head_outputs(x)
            out = {"boxes": boxes, "scores": scores, "priors": priors}
            gt = [[0.2, 0.2, 0.6, 0.7]]
        else:
            out = {"head_outs": tm.head_outputs(x), "epoch_id": 0}
            gt = [[8.0, 10.0, 40.0, 50.0]]
        loss = tm.loss_fn(out, {"boxes": torch.tensor([gt, gt]),
                                "class_labels": torch.tensor([[1], [2]])})
    assert loss.ndim == 0 and torch.isfinite(loss)
