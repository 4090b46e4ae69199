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
from tlxcv_tpu_torch.utils.bridge import _owner, _to_port_layout

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
    targets = {"boxes": torch.tensor([[[4.0, 6.0, 40.0, 50.0]]]),
               "class_labels": torch.tensor([[2]]),
               "mask": torch.ones(1, 1)}
    loss = task.loss_fn(out, targets)
    assert loss.shape == () and bool(torch.isfinite(loss))
    full = create_model("mask_rcnn", device="cpu", num_classes=80)
    assert full.cls_score.weight.shape == (81, 1024)
    assert full.mask_head.pred.weight.shape == (80, 256, 1, 1)
    assert isinstance(full.backbone.layer4[0].conv3.weight, torch.Tensor)


def _targets(with_masks, zero_gt=False):
    boxes = np.asarray([[[10, 10, 60, 70], [40, 50, 100, 110], [0, 0, 0, 0]],
                        [[5, 20, 90, 60], [0, 0, 0, 0], [0, 0, 0, 0]]],
                       np.float32)
    valid = np.asarray([[1, 1, 0], [1, 0, 0]], np.float32)
    masks = np.zeros((2, 3, *HW), np.float32)
    masks[0, 0, 10:70, 10:60] = 1
    masks[0, 1, 50:110, 40:100] = 1
    masks[1, 0, 20:60, 5:90] = 1
    if zero_gt:
        boxes, valid, masks = 0 * boxes, 0 * valid, 0 * masks
    t = {"boxes": boxes, "class_labels": np.asarray([[1, 2, 0], [3, 0, 0]],
                                                    np.int32),
         "mask": valid}
    if with_masks:
        t["masks"] = masks
    return t


_DIFF = ("feats", "rpn_logits", "rpn_deltas", "proposals")


def _loss_and_grads(pair, targets):
    """Both loss_fns on the JAX model's training outputs (so both see the
    same proposals): the loss, its gradients with respect to the outputs
    and to the heads' parameters that loss_fn runs."""
    jm, tm = pair[:2]
    params, state = split(jm)
    x = np.random.default_rng(0).normal(size=(2, *HW, 3)).astype(np.float32)
    out, _ = pure(jm, lambda m, x: m(x))(params, state, jnp.asarray(x),
                                         training=True)
    loss_of = pure(jm, lambda m, o, t: m.loss_fn(o, t))
    jt = {k: jnp.asarray(v) for k, v in targets.items()}

    def f(p, d):
        return loss_of(p, state, {**out, **d}, jt, training=True)[0]

    jloss, (jgp, jgo) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(
        params, {k: out[k] for k in _DIFF})
    tout = {k: (v if k in ("image_hw",) else
                [torch.from_numpy(np.array(f)).requires_grad_() for f in v]
                if k == "feats" else torch.from_numpy(np.array(v)))
            for k, v in out.items()}
    for k in _DIFF[1:]:
        tout[k].requires_grad_()
    tm.zero_grad()
    tloss = tm.loss_fn(tout, {k: torch.from_numpy(v)
                              for k, v in targets.items()})
    tloss.backward()
    return float(jloss), float(tloss), jgo, jgp, tout


@pytest.mark.parametrize("with_masks", [True, False])
def test_loss_fn_matches_jax(pair, with_masks):
    """The loss within 1e-5 relative; its gradients with respect to the FPN
    levels, the RPN outputs and the proposals within 1e-4 of each one's
    largest element (3.5e-5 seen: f32 sums in another order); the box
    head's parameters within 1e-3 and the mask head's within 3e-2 (six
    layers at random init, ReLU between them: ill-conditioned in f32, JAX
    0.3% and the port 0.7% of max |g| from float64)."""
    jloss, tloss, jgo, jgp, tout = _loss_and_grads(pair, _targets(with_masks))
    tm = pair[1]
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)

    def rel(got, want):
        want = np.asarray(want)
        return np.abs(got.detach().numpy() - want).max() / np.abs(want).max()

    for g, w in zip(tout["feats"][:4], jgo["feats"][:4]):
        if np.abs(np.asarray(w)).max() > 0:    # P2 only at 128^2
            assert rel(g.grad, w) <= 1e-4
    for k in _DIFF[1:]:
        assert rel(tout[k].grad, jgo[k]) <= 1e-4, k
    for k, p in tm.named_parameters():
        head = k.split(".")[0]
        if head not in ("box_head", "cls_score", "bbox_pred", "mask_head"):
            assert p.grad is None, k           # loss_fn runs the heads only
            continue
        if head == "mask_head" and not with_masks:
            assert p.grad is None, k
            continue
        owner, leaf = _owner(tm, k)
        want = _to_port_layout(owner, leaf, np.asarray(jgp[k.replace(
            ".", "/")]))
        assert rel(p.grad, want) <= (3e-2 if head == "mask_head" else 1e-3), k


def test_loss_fn_finite_with_zero_gt(pair):
    """An image batch with no valid GT (tests/test_mask_rcnn.py:112): the
    padded all-zero target rows encode to finite deltas that the masks
    zero; the loss and its gradients are finite and equal JAX's."""
    jloss, tloss, jgo, _, tout = _loss_and_grads(pair, _targets(True, True))
    assert np.isfinite(tloss)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    for k in _DIFF[1:]:
        assert bool(torch.isfinite(tout[k].grad).all()), k
    np.testing.assert_allclose(tout["rpn_logits"].grad.numpy(),
                               np.asarray(jgo["rpn_logits"]), rtol=0,
                               atol=1e-6)


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
