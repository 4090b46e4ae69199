"""Hermetic instance-segmentation accuracy check (mask mAP).

Port of ``demo/object_detection/accuracy_check_instance_seg.py``: Mask
R-CNN and SOLOv2, each on a ResNet-18 trunk, train from random weights on
the procedural ``ShapesDetection`` fixture with its instance masks (b16
128^2, Adam, cosine decay from 1e-3; SOLOv2 after a 500-step linear
warm-up) and are scored by the port's COCO evaluator with
``iou_type="segm"`` (Mask R-CNN also ``"bbox"``) on 128 held-out images.
Floors (``FLOORS``) are the reference's.  On the card Mask R-CNN runs
the hand-written gather (RoIAlign's rows), upsample-add (the FPN) and
transposed-resize (the upsample-add's gradient) kernels.

    python -m tlxcv_tpu_torch.demo.object_detection.accuracy_check_instance_seg \\
        [maskrcnn|solov2 ...] [--device=cpu] [--out-dir=DIR]

merges each model's row into ``instance_seg_results.json``.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ...data import ShapesDetection
from ...ops.image import resize_linear
from ...utils.coco_eval import compute_coco_stats
from ...device import resolve_device
from .. import _accuracy as A
from .accuracy_sweep import train_step

__all__ = ["FLOORS", "batcher", "run_maskrcnn", "run_solov2", "main"]

SIZE = 128
M = 4
B = 16
NC = 3

FLOORS = {"maskrcnn": {"segm": 0.50, "bbox": 0.60},
          "solov2": {"segm": 0.43}}


def _r18(device):
    from ...models.classification.resnet import ResNet

    return ResNet(depth=18, num_classes=0, with_pool=False, device=device)


def batcher(ds, idxs):
    """The sweep's batch with the instance masks [B, M, S, S] f32."""
    imgs, boxes, labels, vmask, gmasks = [], [], [], [], []
    for i in idxs:
        im, t = ds[int(i)]
        imgs.append(im)
        b = np.zeros((M, 4), np.float32)
        lab = np.zeros((M,), np.int64)
        v = np.zeros((M,), np.float32)
        gm = np.zeros((M, SIZE, SIZE), np.float32)
        n = len(t["boxes"])
        b[:n] = t["boxes"][:M]
        lab[:n] = t["class_labels"][:M]
        v[:n] = 1
        gm[:n] = t["masks"][:M]
        boxes.append(b)
        labels.append(lab)
        vmask.append(v)
        gmasks.append(gm)
    return (np.stack(imgs).astype(np.float32),
            {"boxes": np.stack(boxes),
             "class_labels": np.stack(labels).astype(np.int32),
             "mask": np.stack(vmask), "masks": np.stack(gmasks)})


def _train(model, steps, lr, log_tag, device, batch, warmup=0):
    """The reference's loop: Adam on a cosine decay (after a linear
    warm-up from 0 when ``warmup``), batches drawn with
    ``default_rng(0)``.  SOLOv2 needs the warm-up: at the full rate from
    the first step the dice loss drives every mask into its all-zero dead
    zone.  Returns the log points' losses."""
    from ...train.optimizers import Adam, cosine_schedule, warmup_cosine

    sched = (warmup_cosine(lr, warmup, steps) if warmup
             else cosine_schedule(lr, steps))
    opt = Adam(sched)(dict(model.named_parameters()))
    train = ShapesDetection(num=4096, size=SIZE, seed=0, return_masks=True)
    rng = np.random.default_rng(0)
    model.train()
    losses = {}
    t0 = time.time()
    for it in range(steps):
        x, t = batcher(train, rng.integers(0, len(train), size=batch))
        loss = train_step(model, opt, A.to_device(x, device),
                          A.to_device(t, device))
        if it % 250 == 0:
            losses[it] = float(loss)
            print(f"  [{log_tag}] it {it} loss {losses[it]:.4f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    return losses, t0


def _gather_gts(val, idxs):
    gts = []
    for i in idxs:
        _, t = val[int(i)]
        gts.append({"boxes": t["boxes"], "labels": t["class_labels"],
                    "masks": t["masks"]})
    return gts


def _val_batches(val):
    for i0 in range(0, len(val), B):
        idxs = list(range(i0, min(i0 + B, len(val))))
        yield idxs, batcher(val, idxs)[0]


def run_maskrcnn(steps=2500, device=None, batch=B, val_num=128):
    from ...models.detection import MaskRCNN

    dev = resolve_device(device)
    A.reset_launches()
    torch.manual_seed(0)
    model = MaskRCNN(num_classes=NC, backbone=_r18(dev), num_proposals=64,
                     pre_nms_top_k=256, detections_per_image=16,
                     box_score_thresh=0.05, device=dev)
    losses, t0 = _train(model, steps, 1e-3, "maskrcnn", dev, batch)
    model.eval()
    val = ShapesDetection(num=val_num, size=SIZE, seed=999,
                          return_masks=True)
    preds, gts = [], []
    with torch.inference_mode():
        for idxs, x in _val_batches(val):
            dets, counts, masks = model(torch.from_numpy(x).to(dev))
            pasted = model.paste(masks, dets, counts, (SIZE, SIZE))
            dets = dets.float().cpu().numpy()
            counts = counts.cpu().numpy()
            pasted = pasted.float().cpu().numpy()
            for j in range(len(idxs)):
                n = int(counts[j])
                preds.append({"boxes": dets[j, :n, 2:6],
                              "scores": dets[j, :n, 1],
                              "labels": dets[j, :n, 0].astype(int),
                              "masks": pasted[j, :n] > 0.5})
            gts.extend(_gather_gts(val, idxs))
    segm = compute_coco_stats(preds, gts, iou_type="segm")
    bbox = compute_coco_stats(preds, gts, iou_type="bbox")
    el = time.time() - t0
    print(f"  [maskrcnn] segm mAP={segm['map']:.4f} mAP50={segm['map50']:.4f}"
          f" | bbox mAP={bbox['map']:.4f} ({el:.0f}s)", flush=True)
    metrics = [A.metric("segm_map", segm["map"], FLOORS["maskrcnn"]["segm"]),
               A.metric("bbox_map", bbox["map"], FLOORS["maskrcnn"]["bbox"])]
    return {"model": "maskrcnn", "segm_map": segm["map"],
            "segm_map50": segm["map50"], "bbox_map": bbox["map"],
            "seconds": round(el, 1),
            "pass": all(m["ok"] for m in metrics), "metrics": metrics,
            "steps": steps, "batch": batch, "losses": losses,
            "device": A.card(dev), "kernel_launches": A.launch_counts()}


def run_solov2(steps=4000, device=None, batch=B, val_num=128):
    from ...models.detection import SOLOv2

    dev = resolve_device(device)
    A.reset_launches()
    torch.manual_seed(0)
    model = SOLOv2(num_classes=NC, backbone=_r18(dev), pre_top_k=64,
                   keep_top_k=16, max_pos=32, score_threshold=0.05,
                   device=dev)
    # the reference's 500-step warm-up (a shortened run: half its steps)
    warmup = 500 if steps > 500 else max(1, steps // 2)
    losses, t0 = _train(model, steps, 1e-3, "solov2", dev, batch,
                        warmup=warmup)
    model.eval()
    val = ShapesDetection(num=val_num, size=SIZE, seed=999,
                          return_masks=True)
    preds, gts = [], []
    with torch.inference_mode():
        for idxs, x in _val_batches(val):
            cls, scores, masks, counts = model(torch.from_numpy(x).to(dev))
            up = resize_linear(masks, (SIZE, SIZE), axes=(2, 3))
            cls = cls.cpu().numpy()
            scores = scores.float().cpu().numpy()
            up = up.float().cpu().numpy()
            counts = counts.cpu().numpy()
            for j in range(len(idxs)):
                n = int(counts[j])
                # no boxes: the segm protocol takes the masks' areas
                preds.append({"scores": scores[j, :n],
                              "labels": cls[j, :n].astype(int),
                              "masks": up[j, :n] > 0.5})
            gts.extend(_gather_gts(val, idxs))
    segm = compute_coco_stats(preds, gts, iou_type="segm")
    el = time.time() - t0
    print(f"  [solov2] segm mAP={segm['map']:.4f} mAP50={segm['map50']:.4f} "
          f"({el:.0f}s)", flush=True)
    metrics = [A.metric("segm_map", segm["map"], FLOORS["solov2"]["segm"])]
    return {"model": "solov2", "segm_map": segm["map"],
            "segm_map50": segm["map50"], "seconds": round(el, 1),
            "pass": metrics[0]["ok"], "metrics": metrics, "steps": steps, "batch": batch, "losses": losses,
            "device": A.card(dev), "kernel_launches": A.launch_counts()}


def main(names=("maskrcnn", "solov2"), device=None, out_dir=None,
         steps=None, batch=B, val_num=128):
    """Run ``names``, merge their rows into ``instance_seg_results.json``;
    their rows, or ``BelowFloor`` carrying them if one missed."""
    out_path = A.results_path(__file__, "instance_seg_results.json", out_dir)
    run = {"maskrcnn": run_maskrcnn, "solov2": run_solov2}
    rows = []
    for name in names:
        print(f"== {name} ==", flush=True)
        kw = {} if steps is None else {"steps": steps}
        r = run[name](device=device, batch=batch, val_num=val_num, **kw)
        rows.append(r)
        # merged by name with the rows of other runs
        A.merge_rows(out_path, [r], order=lambda x: x["model"])
    return A.judge(rows)


if __name__ == "__main__":
    args = sys.argv[1:]
    dev = next((a.split("=", 1)[1] for a in args
                if a.startswith("--device=")), None)
    out = next((a.split("=", 1)[1] for a in args
                if a.startswith("--out-dir=")), None)
    main([a for a in args if not a.startswith("--")] or
         ["maskrcnn", "solov2"], device=dev, out_dir=out)
