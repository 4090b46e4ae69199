"""The port's Faster R-CNN and Cascade R-CNN against the JAX package on the
CPU: the FPN, the RPN and its proposals, every box stage's logits and
deltas, the detections and ``loss_fn`` at 64 px and at 80 x 104 (a frame
whose pyramid levels are not in 2:1 ratios).

Micro size, the JAX package's own (``tests/test_det_zoo2.py:164-186``): a
ResNet-18 trunk, 5 classes, 32 proposals from the top 64, 8 detections,
every box score kept (``box_score_thresh=0``: a random head's class
probabilities sit near 1/6).  Weights are the JAX model's, copied by the
bridge (Cascade's three stages are lists, as FCOS's towers are);
BatchNorm statistics are drawn from a numpy seed.  The JAX side runs under
``jax.jit``, one build per model and frame.

Tolerance: f32 within 2e-4 of the largest magnitude
(``tests/test_parity_resnet.py:91``); the loss within 2e-4 relative;
proposal slots, detections' labels and counts equal.
"""
import numpy as np
import pytest
import torch

from tests.test_torch_det_anchor import (bridged, check_dets, leaves,
                                         run_jax, run_port)
from tests.test_torch_fcos import _images, _targets
from tests.test_torch_seg_zoo import _close
from tlxcv_tpu.models.classification.resnet import ResNet as JResNet
from tlxcv_tpu.models.detection import cascade_rcnn as JC
from tlxcv_tpu_torch import create_model
from tlxcv_tpu_torch.models.classification.resnet import ResNet
from tlxcv_tpu_torch.models.detection import cascade_rcnn as TC

FRAMES = [(64, 64), (80, 104)]
MICRO = dict(num_classes=5, num_proposals=32, pre_nms_top_k=64,
             detections_per_image=8, box_score_thresh=0.0)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: these micro models' small ops gain nothing
    from more, and several test processes share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _train_outputs(m, x):
    feats, logits, deltas, anchors, props, pmask = m.forward_features(x)
    return {"feats": feats, "rpn_logits": logits, "rpn_deltas": deltas,
            "anchors": anchors, "proposals": props, "proposal_mask": pmask}


def _faster(m, x, tg):
    out = _train_outputs(m, x)
    cls, deltas = (m.box_logits(out["feats"], out["proposals"])
                   if hasattr(m, "box_logits") else _j_box_logits(m, out))
    heads = (out["feats"], out["rpn_logits"], out["rpn_deltas"],
             out["proposals"], cls, deltas)
    return heads, m(x), m.loss_fn(out, tg), out["proposal_mask"]


def _j_box_logits(m, out):
    from tlxcv_tpu.models.detection.mask_rcnn import _multilevel_roi_align

    hidden = m.box_head(_multilevel_roi_align(
        out["feats"], out["proposals"], m.box_roi_size,
        m.box_sampling_ratio))
    return m.cls_score(hidden), m.bbox_pred(hidden)


def _cascade(m, x, tg):
    out = _train_outputs(m, x)
    out["stages"], _ = m._run_cascade(out["feats"], out["proposals"],
                                      tuple(x.shape[1:3]))
    heads = (out["feats"], out["rpn_logits"], out["rpn_deltas"],
             [s for s in out["stages"]])
    return heads, m(x), m.loss_fn(out, tg), out["proposal_mask"]


MODELS = {"faster_rcnn": (JC.faster_rcnn, TC.faster_rcnn, _faster),
          "cascade_rcnn": (JC.CascadeRCNN, TC.CascadeRCNN, _cascade)}


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(name):
        if name not in cache:
            jf, tf = MODELS[name][:2]
            cache[name] = bridged(
                jf(**MICRO, backbone=JResNet(depth=18, num_classes=0,
                                             with_pool=False)),
                tf(**MICRO, backbone=ResNet(depth=18, num_classes=0,
                                            with_pool=False, device="cpu"),
                   device="cpu"),
                np.random.default_rng(len(cache) + 21), lambda m: ())
        return cache[name]
    return get


@pytest.mark.parametrize("hw", FRAMES, ids=["64x64", "80x104"])
@pytest.mark.parametrize("name", list(MODELS))
def test_rcnn_matches_jax(rng, pairs, name, hw):
    """The pyramid, the RPN, the proposals (the same slots), each stage's
    logits and deltas, the detections and ``loss_fn``."""
    jm, tm = pairs(name)
    fn = MODELS[name][2]
    x = _images(rng, hw)
    tg = _targets(rng, hw=hw)
    th, tdets, tloss, tmask = run_port(tm, fn, x, tg)
    jh, jdets, jloss, jmask = run_jax(jm, fn, x, tg)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    th, jh = leaves(th), leaves(jh)
    assert len(th) == len(jh)
    for t, j in zip(th, jh):
        _close(t, j)
    check_dets(tdets, jdets)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=2e-4)


def test_cascade_has_three_stages_and_no_single_head(pairs):
    _, tm = pairs("cascade_rcnn")
    assert tm.box_head is None and tm.cls_score is None
    assert len(tm.stage_heads) == len(tm.stage_cls) == 3
    assert not any(k.startswith(("box_head", "cls_score", "bbox_pred"))
                   for k in tm.state_dict())
    tm.train()
    try:
        with torch.no_grad():
            out = tm(torch.randn(1, 64, 96, 3))
    finally:
        tm.eval()
    assert len(out["stages"]) == 3 and out["image_hw"] == (64, 96)
    # each stage refines the previous one's boxes, detached
    assert not torch.equal(out["stages"][0][0], out["stages"][1][0])


def test_registry_builds_both_rcnns():
    faster = create_model("faster_rcnn", device="cpu", num_classes=3)
    cascade = create_model("cascade_rcnn", device="cpu", num_classes=3)
    assert faster.mask_head is None and faster.num_classes == 3
    assert cascade.stage_cls[2].weight.shape[0] == 4
