"""PP-YOLOE and SSD training of the port against the JAX package on the
CPU: the two PP-YOLOE assigners on inputs full of ties, ``get_loss`` on
both sides of the assigner switch, ``SSDLoss`` with tied negatives, the
micro detectors of ``tests/test_torch_ssd_ppyoloe.py`` bridged with their
losses and parameter gradients, and the Trainer's ``epoch_id``.

Tolerances: assignments (labels, boxes) exact, the assigners' scores
within 1e-6 (f32 powers and IoUs); losses within 1e-5 relative; gradients
within 1e-5 of their largest magnitude for the losses alone and 2e-4
through a micro detector (f32 sums in other orders through its
convolutions and BatchNorms; 1e-3 for PP-YOLOE's, whose own float64
distance is measured in its test)."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlxcv_tpu import nn as jnn
from tlxcv_tpu.core import pure, split
from tlxcv_tpu.models.detection import ssd as jssd
from tlxcv_tpu_torch.models.detection import ssd as tssd
from tlxcv_tpu_torch.tasks import ObjectDetection
from tlxcv_tpu_torch.train import Trainer, optimizers
from tlxcv_tpu_torch.utils import load_jax_params
from tlxcv_tpu_torch.utils.bridge import _owner, _to_port_layout

jppyoloe = importlib.import_module("tlxcv_tpu.models.detection.ppyoloe")
tppyoloe = importlib.import_module("tlxcv_tpu_torch.models.detection.ppyoloe")

NC = 4
FEAT_HWS = ((2, 2), (4, 4), (8, 8))  # PP-YOLOE's levels at 64^2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: these micro models' small ops gain nothing
    from more, and several test processes share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _j(x):
    return jnp.asarray(x)


def _heads():
    jh = jppyoloe.PPYOLOEHead(in_channels=(32, 16, 8), num_classes=NC)
    th = tppyoloe.PPYOLOEHead(in_channels=(32, 16, 8), num_classes=NC,
                              device="cpu")
    return jh, th


def _tied_gts():
    """Integer corners: the centres lie on the anchor grid's midpoints,
    so several anchors of a level are exactly as far (ATSS ties); the
    small box holds fewer anchors than the top 13, so zero metrics enter
    the task-aligned top-k (its ties); the last row of image 1 is
    padding."""
    boxes = np.array([[[4, 4, 28, 28], [16, 0, 48, 32], [40, 40, 60, 62]],
                      [[0, 0, 64, 64], [20, 20, 36, 36], [0, 0, 0, 0]]],
                     np.float32)
    labels = np.array([[0, 3, 1], [2, 2, 0]], np.int32)
    pad = (boxes[..., 2] > boxes[..., 0]).astype(np.float32)
    return boxes, labels, pad


def test_atss_assign_matches_jax_on_ties():
    jh, th = _heads()
    anchors, _, _, counts = jh._anchors(FEAT_HWS)
    boxes, labels, pad = _tied_gts()
    a = anchors.shape[0]
    pm = np.broadcast_to(pad[..., None], pad.shape + (a,)).copy()
    rng = np.random.default_rng(0)
    jitter = rng.uniform(-4, 4, (2, a, 4))
    pred = (anchors[None] + jitter).astype(np.float32)
    want = jppyoloe.atss_assign(_j(anchors), counts, _j(labels), _j(boxes),
                                _j(pm), NC, NC, pred_bboxes=_j(pred))
    got = tppyoloe.atss_assign(_t(anchors), counts, _t(labels).long(),
                               _t(boxes), _t(pm), NC, NC,
                               pred_bboxes=_t(pred))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0,
                               atol=1e-6)
    assert (got[0] != NC).sum() > 8  # positives were assigned


@pytest.mark.parametrize("cold", [True, False])
def test_task_aligned_assign_matches_jax_on_ties(cold):
    """``cold``: every score 0.01 and every predicted box the same
    offset from its anchor, as a fresh head predicts: the metrics of a
    level tie exactly."""
    jh, _ = _heads()
    _, points, _, _ = jh._anchors(FEAT_HWS)
    boxes, labels, pad = _tied_gts()
    a = points.shape[0]
    pm = np.broadcast_to(pad[..., None], pad.shape + (a,)).copy()
    rng = np.random.default_rng(1)
    if cold:
        scores = np.full((2, a, NC), 0.01, np.float32)
        off = np.full((2, a, 2), 6.0, np.float32)
        pred = np.concatenate([points - off, points + off], -1)
    else:
        scores = rng.uniform(0, 1, (2, a, NC)).astype(np.float32)
        pred = np.concatenate([points - rng.uniform(2, 20, (2, a, 2)),
                               points + rng.uniform(2, 20, (2, a, 2))], -1)
    pred = pred.astype(np.float32)
    want = jppyoloe.task_aligned_assign(_j(scores), _j(pred), _j(points),
                                        _j(labels), _j(boxes), _j(pm), NC,
                                        NC)
    got = tppyoloe.task_aligned_assign(_t(scores), _t(pred), _t(points),
                                       _t(labels).long(), _t(boxes), _t(pm),
                                       NC, NC)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0,
                               atol=1e-6)
    assert (got[0] != NC).sum() > 8


@pytest.mark.parametrize("epoch_id", [0, 4])
def test_get_loss_and_its_gradients_match_jax(epoch_id):
    """Seeded head outputs, ATSS before ``static_assigner_epoch`` (4),
    task-aligned from it on."""
    jh, th = _heads()
    rng = np.random.default_rng(2)
    a = sum(h * w for h, w in FEAT_HWS)
    scores = rng.uniform(0.02, 0.98, (2, a, NC)).astype(np.float32)
    distri = rng.normal(size=(2, a, 4 * 17)).astype(np.float32)
    boxes, labels, _ = _tied_gts()
    jt = {"boxes": _j(boxes), "class_labels": _j(labels)}
    tt = {"boxes": _t(boxes), "class_labels": _t(labels)}
    want, wg = jax.value_and_grad(
        lambda s, d: jh.get_loss((s, d, FEAT_HWS), jt, epoch_id),
        argnums=(0, 1))(_j(scores), _j(distri))
    leaves = [_t(scores).requires_grad_(), _t(distri).requires_grad_()]
    got = th.get_loss((*leaves, FEAT_HWS), tt, epoch_id)
    gg = torch.autograd.grad(got, leaves)
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    for g, w in zip(gg, wg):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def _ssd_case(rng, tied=True):
    a, n, c = 60, 3, 5
    lo = rng.uniform(0, 0.7, (a, 2))
    priors = np.concatenate([lo, lo + rng.uniform(0.1, 0.3, (a, 2))],
                            -1).astype(np.float32)
    gt = np.zeros((2, n, 4), np.float32)
    gt[:, :2] = priors[[[3, 17], [40, 41]]] + 0.01
    labels = np.array([[1, 2, 0], [3, 4, 0]], np.int32)
    mask = np.array([[1, 1, 0], [1, 1, 0]], np.float32)
    boxes = rng.normal(size=(2, a, 4)).astype(np.float32)
    scores = rng.normal(size=(2, a, c + 1)).astype(np.float32)
    if tied:  # whole runs of negatives with one and the same loss
        scores[:, 10:50] = scores[:, 10:11]
    return boxes, scores, gt, labels, mask, priors


@pytest.mark.parametrize("tied", [True, False])
def test_ssd_loss_and_its_gradients_match_jax(rng, tied):
    boxes, scores, gt, labels, mask, priors = _ssd_case(rng, tied)
    jl, tl = jssd.SSDLoss(), tssd.SSDLoss()
    want, wg = jax.value_and_grad(
        lambda b, s: jl(b, s, _j(gt), _j(labels), _j(mask), _j(priors)),
        argnums=(0, 1))(_j(boxes), _j(scores))
    leaves = [_t(boxes).requires_grad_(), _t(scores).requires_grad_()]
    got = tl(*leaves, _t(gt), _t(labels), _t(mask), _t(priors))
    gg = torch.autograd.grad(got, leaves)
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    for g, w in zip(gg, wg):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    if tied:  # the tied negatives were ranked, not all taken
        picked = (gg[1].abs().sum(-1) > 0)[:, 10:50].sum(1)
        assert 0 < int(picked.min()) and int(picked.max()) < 40


def _flat(jm):
    params, state = split(jm)
    return {k: np.asarray(v) for k, v in {**params, **state}.items()}


def _random_bn_statistics(jm, rng):
    for _, mod in jm.modules():
        if isinstance(mod, jnn.BatchNorm):
            c = mod.running_mean.value.shape[0]
            mod.running_mean.value = jnp.asarray(
                rng.normal(scale=0.2, size=(c,)), jnp.float32)
            mod.running_var.value = jnp.asarray(
                rng.uniform(0.5, 2.0, size=(c,)), jnp.float32)


def _compare_param_grads(tm, wg, rel=2e-4):
    """Every parameter's gradient against the JAX one in the port's
    layout; a gradient below a thousandth of the model's largest is held
    to ``rel`` of a thousandth of that largest (rounding noise where the
    exact gradient is zero or nearly)."""
    want = {}
    for k, _ in tm.named_parameters():
        owner, leaf = _owner(tm, k)
        want[k] = _to_port_layout(owner, leaf,
                                  np.asarray(wg[k.replace(".", "/")]))
    top = max(np.abs(w).max() for w in want.values())
    for k, p in tm.named_parameters():
        w = want[k]
        np.testing.assert_allclose(
            p.grad.numpy(), w, rtol=0,
            atol=rel * max(np.abs(w).max(), 1e-3 * top), err_msg=k)


def _model_grads(jm, tm, x, jt, tt, call, training, rel=2e-4):
    params, state = split(jm)
    lp = pure(jm, lambda m, v, t: call(m, v, t))
    want, wg = jax.jit(jax.value_and_grad(
        lambda p: lp(p, state, _j(x), jt, training=training)[0]))(params)
    tm.train(training)
    tm.zero_grad()
    saved = {k: b.clone() for k, b in tm.named_buffers()}
    with torch.backends.mkldnn.flags(enabled=False):
        got = call(tm, _t(x), tt)
        got.backward()
    with torch.no_grad():
        for k, b in tm.named_buffers():
            b.copy_(saved[k])
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    _compare_param_grads(tm, wg, rel)


def test_micro_ppyoloe_loss_and_parameter_gradients_match_jax():
    """``ppyoloe_s`` with 4 classes at 64^2 b2, train mode (BatchNorm on
    batch statistics), the prediction convs drawn from a seeded normal,
    the ATSS phase (its assignment depends on the anchors and GTs only).
    Gradients within 1e-3 of their largest value: on this seed each
    package's f32 gradients lie up to 5.2e-4 (the port) and 3.5e-4 (the
    JAX package) of their largest value from its own float64 ones (the
    GIoU's min and max and the swish-BatchNorm stack at 2 x 2 x 2 samples
    a channel)."""
    rng = np.random.default_rng(3)
    jm = jppyoloe.ppyoloe("ppyoloe_s", num_classes=NC)
    _random_bn_statistics(jm, rng)
    head = jm.yolo_head
    for conv in (*head.pred_cls, *head.pred_reg):
        conv.weight.value = jnp.asarray(rng.normal(
            scale=0.02, size=conv.weight.value.shape), jnp.float32)
        conv.bias.value = jnp.asarray(rng.normal(
            scale=0.5, size=conv.bias.value.shape), jnp.float32)
    tm = tppyoloe.ppyoloe("ppyoloe_s", num_classes=NC, device="cpu")
    load_jax_params(tm, _flat(jm), strict=True)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    boxes, labels, _ = _tied_gts()
    _model_grads(jm, tm, x, {"boxes": _j(boxes), "class_labels": _j(labels)},
                 {"boxes": _t(boxes), "class_labels": _t(labels)},
                 lambda m, v, t: m.loss_fn(m(v, epoch_id=0), t), True,
                 rel=1e-3)


def test_micro_ssd_loss_and_parameter_gradients_match_jax():
    """``SSD(num_classes=5, image_size=(96, 96))`` b2, the loss through
    the network with BatchNorm on its running statistics: in train mode
    MobileNetV1's deepest BatchNorms see 2 to 18 samples a channel, where
    one ReLU whose input lies within f32 rounding of 0 decides the
    gradient (``tests/test_torch_bn_train_grads.py`` traces the same
    effect in YOLOv3); the train-mode loss itself is compared too."""
    rng = np.random.default_rng(4)
    cfg = dict(num_classes=5, image_size=(96, 96), keep_top_k=10)
    jm = jssd.SSD(**cfg)
    _random_bn_statistics(jm, rng)
    tm = tssd.SSD(**cfg, device="cpu")
    load_jax_params(tm, _flat(jm), strict=True)
    x = rng.normal(size=(2, 96, 96, 3)).astype(np.float32)
    gt = np.zeros((2, 4, 4), np.float32)
    gt[:, :2] = np.sort(rng.uniform(0.2, 0.8, size=(2, 2, 2, 2)),
                        axis=2).reshape(2, 2, 4)
    labels = rng.integers(0, 5, size=(2, 4)).astype(np.int32)
    jt = {"boxes": _j(gt), "class_labels": _j(labels)}
    tt = {"boxes": _t(gt), "class_labels": _t(labels)}

    def call(m, v, t):
        if isinstance(m, torch.nn.Module):
            boxes, scores, priors = m.head_outputs(v)
        else:
            boxes, scores = m.ssd_head(m.backbone(v))
            priors = jnp.asarray(m.priors(m.backbone(v)))
        return m.loss_fn({"boxes": boxes, "scores": scores,
                          "priors": priors}, t)

    _model_grads(jm, tm, x, jt, tt, call, False)
    want = jax.jit(lambda p, s: pure(jm, lambda m, v, t: m.loss_fn(m(v), t))(
        p, s, _j(x), jt, training=True)[0])(*split(jm))
    tm.train()
    with torch.no_grad():
        got = tm.loss_fn(tm(_t(x)), tt)
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))


def test_trainer_passes_the_epoch_across_the_assigner_switch(monkeypatch):
    """The Trainer finds PP-YOLOE's ``static_assigner_epoch`` behind the
    task and calls the network with the loop's epoch: with the switch at
    1, epoch 0 takes ATSS and epoch 1 the task-aligned assigner."""
    model = tppyoloe.ppyoloe("ppyoloe_s", num_classes=NC, device="cpu",
                             static_assigner_epoch=1,
                             generator=torch.Generator().manual_seed(0))
    seen = []
    real = tppyoloe.PPYOLOEHead.get_loss

    def spy(self, head_outs, targets, epoch_id=0):
        seen.append(epoch_id)
        return real(self, head_outs, targets, epoch_id)

    monkeypatch.setattr(tppyoloe.PPYOLOEHead, "get_loss", spy)
    calls = {"atss": 0, "tal": 0}
    for name, key in (("atss_assign", "atss"),
                      ("task_aligned_assign", "tal")):
        fn = getattr(tppyoloe, name)

        def counted(*a, _fn=fn, _key=key, **k):
            calls[_key] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(tppyoloe, name, counted)
    boxes, labels, _ = _tied_gts()
    x = np.random.default_rng(5).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    data = [(x[i], {"boxes": boxes[i], "class_labels": labels[i]})
            for i in range(2)]
    from tlxcv_tpu_torch.data import DataLoader

    trainer = Trainer(ObjectDetection(model), optimizer=optimizers.Adam(1e-4),
                      device="cpu")
    with torch.backends.mkldnn.flags(enabled=False):
        trainer.train(2, DataLoader(data, batch_size=2), print_freq=10)
    assert seen == [0, 1] and calls == {"atss": 1, "tal": 1}
