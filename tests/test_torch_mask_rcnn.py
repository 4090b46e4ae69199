"""The port's Mask R-CNN against the JAX package on the CPU, at the micro
size of tests/test_mask_rcnn.py (resnet18 backbone, 4 classes, 16
proposals, pre-NMS top 64, 8 detections, 128^2): the JAX model's
``split()`` carried across by ``load_jax_params(strict=True)``, then
every stage compared on the same seeded f32 input."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlxcv_tpu.core import pure, split
from tlxcv_tpu.models.classification import resnet18 as j_resnet18
from tlxcv_tpu.models.detection import MaskRCNN as JMaskRCNN
from tlxcv_tpu_torch import create_model
from tlxcv_tpu_torch.models.classification import resnet18
from tlxcv_tpu_torch.models.detection import MaskRCNN
from tlxcv_tpu_torch.models.detection import mask_rcnn as TM
from tlxcv_tpu_torch.tasks import ObjectDetection
from tlxcv_tpu_torch.utils import load_jax_params

MICRO = dict(num_classes=4, num_proposals=16, pre_nms_top_k=64,
             detections_per_image=8)
HW = (128, 128)


def _pair(**kw):
    """A JAX micro Mask R-CNN, the port's copy of it, and both models'
    outputs on one seeded batch of two images."""
    jm = JMaskRCNN(**MICRO, backbone=j_resnet18(num_classes=0,
                                                with_pool=False), **kw)
    params, state = split(jm)
    flat = {k: np.asarray(v) for k, v in {**params, **state}.items()}
    tm = MaskRCNN(**MICRO, backbone=resnet18(num_classes=0, with_pool=False,
                                             device="cpu"),
                  device="cpu", **kw)
    load_jax_params(tm, flat, strict=True)
    tm.eval()
    x = np.random.default_rng(0).normal(size=(2, *HW, 3)).astype(np.float32)
    fwd = pure(jm)
    feat_fn = pure(jm, lambda m, x: m.forward_features(x))
    want, _ = jax.jit(lambda p, s, x: fwd(p, s, x))(params, state,
                                                    jnp.asarray(x))
    want_feats, _ = jax.jit(lambda p, s, x: feat_fn(p, s, x))(
        params, state, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
        got_feats = tm.forward_features(torch.from_numpy(x))
    return jm, tm, flat, want, want_feats, got, got_feats


@pytest.fixture(scope="module")
def pair():
    return _pair()


def test_bridge_carries_every_tensor(pair):
    jm, tm, flat = pair[:3]
    assert sorted(k.replace(".", "/") for k in tm.state_dict()) == \
        sorted(flat)
    deconv = flat["mask_head/deconv/weight"]            # HWIO (2, 2, I, O)
    np.testing.assert_array_equal(
        tm.mask_head.deconv.weight.detach().numpy(),
        deconv.transpose(2, 3, 0, 1))                   # (I, O, kh, kw)


def test_fpn_and_rpn_match_jax(pair):
    """P2..P6, RPN logits and deltas within 2e-4 (f32, summation order)."""
    want, got = pair[4], pair[6]
    for w, g in zip(want[0], got[0]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)
    for i in (1, 2):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def test_proposals_match_jax(pair):
    """The same proposals in the same slots: the masks equal, the boxes
    within 1e-3 px (f32 noise through delta2bbox's exp)."""
    want, got = pair[4], pair[6]
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                               rtol=0, atol=1e-3)


def test_dets_counts_and_masks_match_jax(pair):
    """Counts and labels equal; scores within 1e-4 (f32 summation order
    through the 12,544-wide fc, which changes with the thread count;
    1.4e-5 seen); boxes within 5e-2 px (the head's deltas amplified by
    exp; 7e-3 seen); mask probabilities within 2e-4 (2.6e-5 seen)."""
    (wd, wc, wm), (gd, gc, gm) = pair[3], pair[5]
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gd[..., 0].numpy(), np.asarray(wd[..., 0]))
    np.testing.assert_allclose(gd[..., 1].numpy(), np.asarray(wd[..., 1]),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(gd[..., 2:].numpy(), np.asarray(wd[..., 2:]),
                               rtol=0, atol=5e-2)
    assert gm.shape == (2, 8, 28, 28)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), rtol=0, atol=2e-4)


def test_paste_matches_jax(pair):
    jm, tm = pair[:2]
    (wd, wc, wm), (gd, gc, gm) = pair[3], pair[5]
    want = np.asarray(jm.paste(wm, wd, wc, HW))
    got = tm.paste(gm, gd, gc, HW)
    assert got.shape == (2, 8, *HW)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)


def test_heads_given_the_same_proposals_match_jax(pair):
    """Box and mask logits on the JAX model's own proposals and boxes."""
    jm, tm = pair[:2]
    want_feats = pair[4]
    feats = [torch.from_numpy(np.array(f)) for f in want_feats[0]]
    props = torch.from_numpy(np.array(want_feats[4]))
    with torch.no_grad():
        cls_logits, deltas = tm.box_logits(feats, props)
        mask_logits = tm.mask_logits(feats, props[:, :8])
    params, state = split(jm)

    def heads(m, feats, props):
        from tlxcv_tpu.models.detection.mask_rcnn import _multilevel_roi_align
        hidden = m.box_head(_multilevel_roi_align(feats, props, 7, 1))
        masks = m.mask_head(_multilevel_roi_align(feats, props[:, :8], 14, 1))
        return m.cls_score(hidden), m.bbox_pred(hidden), masks

    want, _ = pure(jm, heads)(params, state, list(want_feats[0]),
                              want_feats[4])
    for w, g in zip(want, (cls_logits, deltas, mask_logits)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_matrix_nms_options_and_no_mask_match_jax():
    """rpn_matrix_nms, box_matrix_nms and with_mask=False carried."""
    _, _, _, want, want_feats, got, got_feats = _pair(
        rpn_matrix_nms=True, box_matrix_nms=True, with_mask=False)
    assert len(got) == 2
    np.testing.assert_array_equal(got_feats[5].numpy(),
                                  np.asarray(want_feats[5]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0][..., 0].numpy(),
                                  np.asarray(want[0][..., 0]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=5e-2)


def test_task_registry_training_mode_and_loss(pair):
    tm = pair[1]
    task = ObjectDetection(tm)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        dets, counts, masks = task.predict(x)
        assert dets.shape == (1, 8, 6) and masks.shape == (1, 8, 28, 28)
        tm.train()
        try:
            out = task(x)
        finally:
            tm.eval()
    assert set(out) == {"feats", "rpn_logits", "rpn_deltas", "anchors",
                        "proposals", "proposal_mask", "image_hw"}
    assert out["proposals"].shape == (1, 16, 4) and len(out["feats"]) == 5
    with pytest.raises(NotImplementedError, match="training slice"):
        task.loss_fn(out, {})
    full = create_model("mask_rcnn", device="cpu", num_classes=80)
    assert full.cls_score.weight.shape == (81, 1024)
    assert full.mask_head.pred.weight.shape == (80, 256, 1, 1)
    assert isinstance(full.backbone.layer4[0].conv3.weight, torch.Tensor)


def test_anchors_match_jax_and_are_cached():
    from tlxcv_tpu.models.detection.mask_rcnn import _rpn_anchors

    hws = ((32, 32), (16, 16), (8, 8), (4, 4), (2, 2))
    np.testing.assert_array_equal(TM._rpn_anchors(hws), _rpn_anchors(hws)[0])
    m = MaskRCNN(**MICRO, backbone=resnet18(num_classes=0, with_pool=False,
                                            device="cpu"), device="cpu")
    a = m._anchors(hws, torch.device("cpu"))
    assert m._anchors(hws, torch.device("cpu")) is a


def test_mask_rcnn_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; MaskRCNN() would use it")
    with pytest.raises(RuntimeError):
        MaskRCNN(**MICRO)
