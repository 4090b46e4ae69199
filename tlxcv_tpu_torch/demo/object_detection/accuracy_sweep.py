"""Registry-driven hermetic accuracy sweep over the detection zoo.

Port of ``demo/object_detection/accuracy_sweep.py``: each detector trains
from random weights (seeded with ``torch.manual_seed(0)`` before its
build) on the procedural ``ShapesDetection`` fixture and must clear its
COCO-mAP floor through the port's evaluator (``utils.coco_eval``).  The
schedules, batches, learning rates, sizes, seeds and floors are the
reference's; its optax pieces map onto ``train.optimizers``:
``cosine_decay_schedule`` is ``cosine_schedule``, ``adam`` is ``Adam``,
``multi_transform`` is a learning rate per label and
``chain(clip_by_global_norm, .)`` is ``grad_clip``.  The floors sit
10-15% under the reference's measured values, which absorbs the other
framework's random draws.

    python -m tlxcv_tpu_torch.demo.object_detection.accuracy_sweep \\
        [model ...] [--int8] [--steps=N] [--device=cpu] [--out-dir=DIR]

(no model: all).  Writes ``sweep_results.json`` (``int8_results.json``
with ``--int8``) beside this file, or in ``--out-dir``, after each model.

``--int8``: after the float floor, the trained model goes through
``ops.quant.quantize_for_serving`` and is scored again; its mAP must stay
within 0.02 of its float self.
"""
from __future__ import annotations

import inspect
import sys
import time

import numpy as np
import torch
from torch import nn as tnn

from ...data import ShapesDetection
from ...utils.coco_eval import compute_map
from ...device import resolve_device
from .. import _accuracy as A

__all__ = ["REGISTRY", "TARGET_ADAPTERS", "PREDICT_ADAPTERS", "batcher",
           "run_model", "main"]

SIZE = 128
M = 4           # max objects per image
B = 32
NC = 3


def _r18(device):
    from ...models.classification.resnet import ResNet

    return ResNet(depth=18, num_classes=0, with_pool=False, device=device)


class _R18C345(tnn.Module):
    """ResNet-18 adapter giving (C3, C4, C5): TTFNet's backbone contract."""

    def __init__(self, device):
        super().__init__()
        self.net = _r18(device)
        self.out_channels = tuple(self.net.feat_channels[1:])

    def forward(self, x):
        return tuple(self.net.features(x)[1:])


def _fcos(device):
    from ...models.detection import FCOS

    return FCOS(num_classes=NC, backbone=_r18(device), score_threshold=0.05,
                device=device)


def _retinanet(device):
    from ...models.detection import RetinaNet

    return RetinaNet(num_classes=NC, backbone=_r18(device),
                     score_threshold=0.05, device=device)


def _gfl(device):
    from ...models.detection import GFL

    return GFL(num_classes=NC, backbone=_r18(device), score_threshold=0.05,
               device=device)


def _tood(device):
    from ...models.detection import TOOD

    return TOOD(num_classes=NC, backbone=_r18(device), score_threshold=0.05,
                device=device)


def _yolox(device):
    from ...models.detection import yolox

    return yolox("yolox_s", num_classes=NC, score_threshold=0.05,
                 device=device)


def _picodet(device):
    from ...models.detection import PicoDet

    return PicoDet(num_classes=NC, scale=0.75, score_threshold=0.05,
                   device=device)


def _ppyoloe_s(device):
    from ...models.detection import ppyoloe

    return ppyoloe("ppyoloe_s", num_classes=NC,
                   nms_cfg=dict(score_threshold=0.05, nms_threshold=0.6,
                                nms_top_k=1000, keep_top_k=100),
                   device=device)


def _centernet(device):
    from ...models.detection import CenterNet

    return CenterNet(num_classes=NC, backbone=_r18(device),
                     score_threshold=0.05, device=device)


def _ttfnet(device):
    from ...models.detection import TTFNet

    return TTFNet(num_classes=NC, backbone=_R18C345(device),
                  score_threshold=0.05, device=device)


def _ssd(device, size=SIZE):
    from ...models.detection import SSD

    return SSD(num_classes=NC, image_size=(size, size), score_threshold=0.05,
               nms_threshold=0.5, device=device)


def _yolov3(device):
    from ...models.detection import YOLOv3

    # fixture-scaled anchors: objects are 19-51 px at SIZE=128; masks keep
    # the convention (6, 7, 8) -> stride 32 = largest
    anchors = ((14, 14), (20, 26), (26, 20),
               (28, 28), (36, 28), (28, 36),
               (40, 40), (48, 48), (52, 40))
    return YOLOv3(num_classes=NC, anchors=anchors, score_threshold=0.05,
                  device=device)


def _faster_rcnn(device):
    from ...models.detection import faster_rcnn

    return faster_rcnn(num_classes=NC, backbone=_r18(device),
                       box_score_thresh=0.05, device=device)


def _cascade_rcnn(device):
    from ...models.detection import CascadeRCNN

    return CascadeRCNN(num_classes=NC, backbone=_r18(device),
                       box_score_thresh=0.05, device=device)


def _detr(device):
    from ...models.detection import Detr

    # 4 encoder and decoder layers and 25 queries for <= 4 objects at 128^2;
    # live BatchNorm on a ResNet-18 trained from scratch (frozen identity
    # statistics are the pretrained regime)
    return Detr(num_classes=NC, num_queries=25, enc_layers=4, dec_layers=4,
                dropout=0.0, backbone_depth=18, freeze_bn=False,
                device=device)


def _detr_predict(model, x):
    """DETR's eval output ``{logits, boxes}`` as ``(dets, counts)``: the
    queries in descending score order (stable), counted above 0.05."""
    out = model(x)
    labels, scores, boxes = model.predict_boxes(out, tuple(x.shape[1:3]))
    order = torch.sort(-scores, dim=1, stable=True).indices
    labels = torch.gather(labels, 1, order)
    scores = torch.gather(scores, 1, order)
    boxes = torch.gather(boxes, 1, order[..., None].expand_as(boxes))
    dets = torch.cat([labels[..., None].float(), scores[..., None], boxes],
                     -1)
    return dets, (scores > 0.05).sum(1)


def _tgt_norm_xyxy(t, size=SIZE):
    """SSD's contract: boxes as normalised xyxy."""
    return {**t, "boxes": t["boxes"] / size}


def _tgt_norm_cxcywh(t, size=SIZE):
    """YOLOv3's and DETR's contract: boxes as normalised cxcywh, padded
    rows with w = h = 0."""
    b = t["boxes"] / size
    cxcy = (b[..., :2] + b[..., 2:]) / 2
    wh = (b[..., 2:] - b[..., :2]) * t["mask"][..., None]
    return {**t, "boxes": torch.cat([cxcy, wh], -1), "scores": t["mask"]}


# name -> (builder, steps, lr, mAP floor[, options]), the reference's
REGISTRY = {
    "fcos": (_fcos, 2000, 1e-3, 0.75),
    "retinanet": (_retinanet, 2000, 1e-3, 0.60),
    "gfl": (_gfl, 2000, 1e-3, 0.75),
    "tood": (_tood, 2000, 1e-3, 0.70),
    "yolox_s": (_yolox, 2000, 1e-3, 0.70),
    "picodet": (_picodet, 3000, 2e-3, 0.60),
    # static ATSS for the first 700 steps, then task-aligned assignment
    "ppyoloe_s": (_ppyoloe_s, 2500, 1e-3, 0.62, {"tal_after": 700}),
    "centernet": (_centernet, 3000, 1e-3, 0.55),
    "ttfnet": (_ttfnet, 3000, 1e-3, 0.55),
    # SSD at 256^2: its stride-16-and-up pyramid matches too few priors to
    # the fixture's objects at 128^2
    "ssd": (_ssd, 5000, 1e-3, 0.50, {"size": 256, "batch": 16}),
    "yolov3": (_yolov3, 8000, 1e-3, 0.60),
    "faster_rcnn": (_faster_rcnn, 2000, 1e-3, 0.55),
    # three cascade stages: half the batch, twice the steps
    "cascade_rcnn": (_cascade_rcnn, 4000, 1e-3, 0.55, {"batch": 16}),
    "detr": (_detr, 4000, 2e-4, 0.30),
}

# models whose loss speaks another box convention than pixel xyxy
TARGET_ADAPTERS = {
    "ssd": _tgt_norm_xyxy,
    "yolov3": _tgt_norm_cxcywh,
    "detr": _tgt_norm_cxcywh,
}

# models whose eval forward does not already give (dets, counts)
PREDICT_ADAPTERS = {
    "detr": _detr_predict,
}


def batcher(ds, idxs):
    """Images [B, S, S, 3] f32 and the ground truth padded to ``M``
    objects (boxes f32 pixels xyxy, class_labels int32, mask f32), numpy."""
    imgs, boxes, labels, mask = [], [], [], []
    for i in idxs:
        im, t = ds[int(i)]
        imgs.append(im)
        b = np.zeros((M, 4), np.float32)
        lab = np.zeros((M,), np.int64)
        v = np.zeros((M,), np.float32)
        n = len(t["boxes"])
        b[:n] = t["boxes"][:M]
        lab[:n] = t["class_labels"][:M]
        v[:n] = 1
        boxes.append(b)
        labels.append(lab)
        mask.append(v)
    return (np.stack(imgs).astype(np.float32),
            {"boxes": np.stack(boxes),
             "class_labels": np.stack(labels).astype(np.int32),
             "mask": np.stack(mask)})


def _optimizer(model, name, lr, steps, opts):
    from ...train.optimizers import Adam, cosine_schedule

    named = dict(model.named_parameters())
    sched = cosine_schedule(lr, steps)
    bb_mult = opts.get("backbone_lr_mult")
    if bb_mult is not None:
        labels = {k: ("backbone" if k.startswith("backbone") else "main")
                  for k in named}
        rates = {"backbone": cosine_schedule(lr * bb_mult, steps),
                 "main": sched}
        return Adam(rates, lr_labels=labels, grad_clip=opts.get("clip"))(
            named)
    return Adam(sched, grad_clip=opts.get("clip"))(named)


def train_step(model, opt, x, t, **kw):
    """One update: the loss of the train-mode forward, its gradients and
    the optimizer's step; the loss, detached."""
    loss = model.loss_fn(model(x, **kw), t)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def eval_map(model, predict, val, device, eval_batch=B):
    """COCO mAP of ``predict(model, x)``'s (dets, counts) over ``val``."""
    model.eval()
    preds, gts = [], []
    with torch.inference_mode():
        for i0 in range(0, len(val), eval_batch):
            idxs = list(range(i0, min(i0 + eval_batch, len(val))))
            x, _ = batcher(val, idxs)
            out = predict(model, torch.from_numpy(x).to(device))
            dets = out[0].float().cpu().numpy()
            counts = out[1].cpu().numpy()
            for j, i in enumerate(idxs):
                n = int(counts[j])
                preds.append({"boxes": dets[j, :n, 2:6],
                              "scores": dets[j, :n, 1],
                              "labels": dets[j, :n, 0].astype(int)})
                _, t = val[i]
                gts.append({"boxes": t["boxes"],
                            "labels": t["class_labels"]})
    return compute_map(preds, gts)


def run_model(name, steps=None, log_every=500, int8=False, device=None,
              batch=None, val_num=128):
    """Train ``REGISTRY[name]`` and score it; the result row (with the
    card's name and the kernels' launches).  ``batch`` and ``val_num``
    override the training batch and the validation set's size."""
    dev = resolve_device(device)
    entry = REGISTRY[name]
    build, default_steps, lr, floor = entry[:4]
    opts = entry[4] if len(entry) > 4 else {}
    train_b = batch or opts.get("batch", B)
    sz = opts.get("size", SIZE)
    raw_adapt = TARGET_ADAPTERS.get(name)
    adapt = (lambda t: raw_adapt(t, sz)) if raw_adapt else (lambda t: t)
    steps = steps or default_steps
    A.reset_launches()
    # the weights draw from torch's default generator: one seed per model
    # keeps a run of a subset reproducible
    torch.manual_seed(0)
    model = (build(dev, size=sz)
             if "size" in inspect.signature(build).parameters
             else build(dev))
    tal_after = opts.get("tal_after")
    predict = PREDICT_ADAPTERS.get(name, lambda m, x: m(x))
    opt = _optimizer(model, name, lr, steps, opts)

    train = ShapesDetection(num=4096, size=sz, seed=0)
    val = ShapesDetection(num=val_num, size=sz, seed=999)
    rng = np.random.default_rng(0)
    model.train()
    losses = {}
    t0 = time.time()
    for it in range(steps):
        x, t = batcher(train, rng.integers(0, len(train), size=train_b))
        kw = {}
        if tal_after is not None:  # the assigner PP-YOLOE's epoch selects
            kw["epoch_id"] = 10 ** 6 if it >= tal_after else 0
        loss = train_step(model, opt, A.to_device(x, dev),
                          adapt(A.to_device(t, dev)), **kw)
        if it % log_every == 0:
            losses[it] = float(loss)
            print(f"  [{name}] it {it} loss {losses[it]:.4f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    train_s = time.time() - t0

    stats = eval_map(model, predict, val, dev)
    elapsed = time.time() - t0
    print(f"  [{name}] mAP={stats['map']:.4f} mAP50={stats['map50']:.4f} "
          f"mAP75={stats['map75']:.4f} floor={floor} ({elapsed:.0f}s)",
          flush=True)
    result = {"model": name, "map": stats["map"], "map50": stats["map50"],
              "map75": stats["map75"], "floor": floor, "steps": steps,
              "seconds": round(elapsed, 1), "pass": stats["map"] >= floor,
              "batch": train_b, "train_seconds": round(train_s, 1),
              "losses": losses}
    metrics = [A.metric("map", stats["map"], floor)]

    if int8:
        from ...ops.quant import quantize_for_serving

        calib = [batcher(train, rng.integers(0, len(train), size=8))[0]
                 for _ in range(2)]

        def fold_fwd(v):
            # fold and fusion verify one array: the heads, flattened
            outs = model.head_outputs(v)
            return torch.cat([o.reshape(-1) for o in _leaves(outs)])

        n_fold, n_q, n_cal, n_fuse = quantize_for_serving(
            model, calib, forward=fold_fwd)
        print(f"  [{name}] int8: folded {n_fold} BN, {n_q} layers, "
              f"{n_cal} calibrated, {n_fuse} requant-fused", flush=True)
        qstats = eval_map(model, predict, val, dev)
        drop = stats["map"] - qstats["map"]
        print(f"  [{name}] int8 mAP={qstats['map']:.4f} "
              f"(float {stats['map']:.4f}, drop {drop:+.4f})", flush=True)
        metrics.append(A.metric("int8_map", qstats["map"],
                                stats["map"] - 0.02))
        result.update(int8_map=qstats["map"], int8_map50=qstats["map50"],
                      int8_drop=round(drop, 4), int8_pass=metrics[-1]["ok"])
        result["pass"] = result["pass"] and result["int8_pass"]
    result["metrics"] = metrics
    result["device"] = A.card(dev)
    result["kernel_launches"] = A.launch_counts()
    return result


def _leaves(tree):
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [t for v in tree for t in _leaves(v)]


def main(names, int8=False, steps=None, device=None, out_dir=None,
         batch=None, val_num=128):
    """Run ``names`` and merge their rows into the results file; their
    rows, or ``BelowFloor`` carrying them if one missed or raised."""
    out_path = A.results_path(
        __file__, "int8_results.json" if int8 else "sweep_results.json",
        out_dir)
    order = list(REGISTRY)
    rows = {}
    for name in names:
        print(f"== {name} ==", flush=True)
        try:
            r = run_model(name, steps=steps, int8=int8, device=device,
                          batch=batch, val_num=val_num)
        except Exception as e:  # keep sweeping; report at the end
            print(f"  [{name}] ERROR: {e!r}", flush=True)
            r = {"model": name, "error": repr(e), "pass": False}
        rows[name] = r
        A.merge_rows(out_path, [r], order=lambda x: (
            order.index(x["model"]) if x["model"] in order else len(order)))
    return A.judge([rows[n] for n in names])


def _cli(argv):
    int8 = "--int8" in argv
    steps = device = out_dir = None
    names = []
    for a in argv:
        if a == "--int8":
            continue
        if a.startswith("--steps="):
            steps = int(a.split("=", 1)[1])
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a.startswith("--out-dir="):
            out_dir = a.split("=", 1)[1]
        else:
            names.append(a)
    names = names or list(REGISTRY)
    bad = [n for n in names if n not in REGISTRY]
    if bad:
        raise SystemExit(f"unknown models {bad}; known: {list(REGISTRY)}")
    main(names, int8=int8, steps=steps, device=device, out_dir=out_dir)


if __name__ == "__main__":
    _cli(sys.argv[1:])
