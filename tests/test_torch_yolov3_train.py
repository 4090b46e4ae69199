"""YOLOv3 training of the port against the JAX package on the CPU: the
target assignment (``gt2yolo_targets``) on ground truths built to share
slots, the loss and its gradients through ``YOLOv3.loss_fn``, and a loss
that falls.

Tolerances: the targets' positive slots and the GT that wins each slot
are exact (each GT carries its own score, so the objectness channel names
the winner); the values (log-ratios, offsets) within 1e-6, the two
frameworks' log and round-trip arithmetic.  The loss within 1e-5 relative
and each gradient within 2e-4 of its tensor's largest magnitude: sums over
thousands of cells in another order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlxcv_tpu.core import pure, split
from tlxcv_tpu.models.detection import YOLOv3 as JYOLOv3
from tlxcv_tpu.models.detection.yolov3 import \
    gt2yolo_targets as j_gt2yolo_targets
from tlxcv_tpu_torch.models.detection import YOLOv3
from tlxcv_tpu_torch.models.detection.yolov3 import (DEFAULT_ANCHORS,
                                                     DEFAULT_MASKS,
                                                     DOWNSAMPLES,
                                                     gt2yolo_targets)
from tlxcv_tpu_torch.train import Trainer, optimizers
from tlxcv_tpu_torch.utils import load_jax_params

HW = (64, 64)
NC = 6


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: these micro models' small ops gain nothing
    from more, and several test processes share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _colliding_gts(rng, b=2, m=10):
    """Boxes in normalised cxcywh: pairs that share a centre and nearly a
    size (one best anchor, one slot), a triple on one cell, sizes that pass
    0.5 IoU with a second anchor of the level, a centre outside [0, 1],
    zero-size and zero-score padding.  Every GT's score is its own, so
    that the objectness channel names the GT that won a slot."""
    boxes = np.zeros((b, m, 4), np.float32)
    for i in range(b):
        c = rng.uniform(0.2, 0.8, size=2)
        s = rng.uniform(0.1, 0.5, size=2)
        boxes[i, 0] = [*c, *s]
        boxes[i, 1] = [*c, *(s * 1.02)]                   # same slot
        boxes[i, 2] = [*(c + 0.01), *(s * 0.98)]          # same cell
        boxes[i, 3] = [*rng.uniform(0.1, 0.9, 2), 0.3, 0.25]
        boxes[i, 4] = [*boxes[i, 3, :2], 0.32, 0.27]       # 2nd anchor
        boxes[i, 5] = [1.02, 0.5, 0.2, 0.2]                # centre past 1
        boxes[i, 6] = [*rng.uniform(0.1, 0.9, 2), 0.05, 0.08]
        boxes[i, 7] = [*boxes[i, 6, :2], 0.055, 0.085]
        # rows 8, 9: padding (zero size), and a box with zero score
        boxes[i, 9] = [0.5, 0.5, 0.3, 0.3]
    cls = rng.integers(0, NC, size=(b, m)).astype(np.int32)
    score = np.linspace(0.3, 1.0, m, dtype=np.float32)[None].repeat(b, 0)
    score[:, 9] = 0.0
    return boxes, cls, score


@pytest.mark.parametrize("iou_thresh", [1.0, 0.5])
def test_gt2yolo_targets_match_jax(rng, iou_thresh):
    boxes, cls, score = _colliding_gts(rng)
    want = j_gt2yolo_targets(jnp.asarray(boxes), jnp.asarray(cls),
                             jnp.asarray(score), DEFAULT_ANCHORS,
                             DEFAULT_MASKS, DOWNSAMPLES, HW, NC,
                             iou_thresh=iou_thresh)
    got = gt2yolo_targets(torch.from_numpy(boxes), torch.from_numpy(cls),
                          torch.from_numpy(score), DEFAULT_ANCHORS,
                          DEFAULT_MASKS, DOWNSAMPLES, HW, NC,
                          iou_thresh=iou_thresh)
    shared = 0
    for w, g in zip(want, got):
        w, g = np.asarray(w), g.numpy()
        assert g.shape == w.shape
        np.testing.assert_array_equal(g[..., 5] > 0, w[..., 5] > 0)
        np.testing.assert_array_equal(g[..., 5], w[..., 5])  # the winner
        np.testing.assert_array_equal(g[..., 4:], w[..., 4:])
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
        shared += int((w[..., 5] > 0).sum())
    # the colliding GTs did collide: fewer positive slots than valid GTs
    valid = int(((boxes[..., 2] > 0) & (score > 0)).sum())
    assert 0 < shared and (iou_thresh < 1 or shared < valid)


def _head_outs(rng, jm, b=2):
    outs = []
    for conv, ds in zip(jm.yolo_head.yolo_outputs, DOWNSAMPLES):
        c = conv.weight.value.shape[-1]
        outs.append(rng.normal(size=(b, HW[0] // ds, HW[1] // ds, c))
                    .astype(np.float32) * 2)
    return outs


@pytest.mark.parametrize("iou_aware", [False, True])
@pytest.mark.parametrize("iou_thresh", [1.0, 0.5])
def test_loss_and_gradients_match_jax(rng, iou_aware, iou_thresh):
    """``loss_fn`` on seeded head outputs of the micro detector
    (``YOLOv3(num_classes=6)`` at 64^2): the loss and its gradient with
    respect to each level's head output."""
    kw = dict(num_classes=NC, iou_aware=iou_aware, gt_iou_thresh=iou_thresh)
    jm = JYOLOv3(**kw)
    tm = YOLOv3(**kw, device="cpu")
    outs = _head_outs(rng, jm)
    boxes, cls, _ = _colliding_gts(rng)
    jt = {"boxes": jnp.asarray(boxes), "class_labels": jnp.asarray(cls)}
    tt = {"boxes": torch.from_numpy(boxes),
          "class_labels": torch.from_numpy(cls)}

    def jloss(o):
        return jm.loss_fn({"head_outs": o, "input_hw": HW}, jt)

    want, want_g = jax.value_and_grad(jloss)([jnp.asarray(o) for o in outs])
    leaves = [torch.from_numpy(o).requires_grad_() for o in outs]
    got = tm.loss_fn({"head_outs": leaves, "input_hw": HW}, tt)
    got_g = torch.autograd.grad(got, leaves)
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    for g, w in zip(got_g, want_g):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=2e-4 * np.abs(w).max())


def test_model_loss_and_parameter_gradients_match_jax(rng):
    """The whole micro detector bridged from JAX (``strict=True``) at 64^2
    b2: the train-mode loss through the network, then the loss and the
    gradients of the first conv, a mid-backbone conv, a neck conv and the
    three prediction convs with BatchNorm on its running statistics.

    Gradients through train-mode BatchNorm at this size (8 samples a
    channel at stride 32) are ill-conditioned in f32: the port's first-conv
    gradient lies 9e-3 of its largest value from its own float64 one
    (oneDNN off), the JAX package's 9e-5; with running statistics both lie
    within 1e-4 of float64 (measured on this seed)."""
    jm = JYOLOv3(num_classes=NC)
    tm = YOLOv3(num_classes=NC, device="cpu")
    params, state = split(jm)
    load_jax_params(tm, {k: np.asarray(v) for k, v in
                         {**params, **state}.items()}, strict=True)
    x = rng.normal(size=(2, *HW, 3)).astype(np.float32)
    boxes, cls, _ = _colliding_gts(rng)
    jt = {"boxes": jnp.asarray(boxes), "class_labels": jnp.asarray(cls)}
    tt = {"boxes": torch.from_numpy(boxes),
          "class_labels": torch.from_numpy(cls)}
    probes = ["backbone/conv0/conv/weight",
              "backbone/stages/2/blocks/0/conv1/conv/weight",
              "neck/yolo_blocks/1/tip/conv/weight",
              *[f"yolo_head/yolo_outputs/{i}/weight" for i in range(3)]]

    def jloss(p, training):
        out, _ = pure(jm, lambda m, v: m.loss_fn(
            {"head_outs": m.head_outputs(v), "input_hw": HW}, jt))(
            p, state, jnp.asarray(x), training=training)
        return out

    want_train = jax.jit(lambda p: jloss(p, True))(params)
    want, want_g = jax.jit(jax.value_and_grad(lambda p: jloss(p, False)))(
        params)
    with torch.backends.mkldnn.flags(enabled=False):
        tm.eval()
        got = tm.loss_fn({"head_outs": tm.head_outputs(torch.from_numpy(x)),
                          "input_hw": HW}, tt)
        got.backward()
        tm.train()  # last: it moves the running statistics
        with torch.no_grad():
            got_train = tm.loss_fn(tm(torch.from_numpy(x)), tt)
    for g, w in ((got_train, want_train), (got, want)):
        assert abs(g.item() - float(w)) <= 1e-5 * abs(float(w))
    named = dict(tm.named_parameters())
    for k in probes:
        w = np.asarray(want_g[k])
        g = named[k.replace("/", ".")].grad.numpy()
        if g.ndim == 4:
            g = g.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=2e-4 * np.abs(w).max(), err_msg=k)


def test_yolov3_loss_decreases(rng):
    """As the JAX package's tests/test_detection_training.py: YOLOv3 with
    3 classes at 96^2 on a fixed batch, 25 Adam steps through the port's
    Trainer; the loss must halve."""
    torch.manual_seed(0)
    model = YOLOv3(num_classes=3, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    x = rng.normal(size=(2, 96, 96, 3)).astype(np.float32)
    boxes = np.zeros((2, 4, 4), np.float32)
    boxes[:, :2, 0:2] = rng.uniform(0.3, 0.7, size=(2, 2, 2))
    boxes[:, :2, 2:4] = rng.uniform(0.2, 0.5, size=(2, 2, 2))
    y = {"boxes": boxes,
         "class_labels": rng.integers(0, 3, size=(2, 4)).astype(np.int32)}
    trainer = Trainer(model, optimizer=optimizers.Adam(1e-3), device="cpu")
    batch = trainer._put_batch((x, y))
    losses = [float(trainer._train_step(*batch)[0]) for _ in range(25)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
