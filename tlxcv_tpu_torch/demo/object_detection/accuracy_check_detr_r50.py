"""DETR at the reference's configuration: a frozen-BatchNorm ResNet-50.

Port of ``demo/object_detection/accuracy_check_detr_r50.py``.  Frozen
identity BatchNorm on a backbone trained from scratch leaves it with no
normalisation at all, so the backbone is pretrained here, hermetically:

1. a classification ResNet-50 trains on a ``ShapesDetection`` task (the
   class of the largest object; 1,500 steps at b64, Adam on a cosine
   decay from 1e-3), so that features and BatchNorm statistics form;
2. ``Detr(backbone_depth=50, freeze_bn=True)`` loads that backbone (the
   frozen BatchNorms take its statistics) and trains through the sweep's
   ``run_model("detr_r50")``: 12,000 steps, 2e-4 with the backbone at a
   tenth of it, gradients clipped to a global norm of 0.1.  Floor mAP
   0.55.

    python -m tlxcv_tpu_torch.demo.object_detection.accuracy_check_detr_r50 \\
        [steps_cls [steps_det]]

writes ``detr_r50_results.json`` beside this file.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from ...data import ShapesDetection
from ...ops.losses import softmax_cross_entropy
from ...device import resolve_device
from .. import _accuracy as A
from . import accuracy_sweep as S

__all__ = ["pretrain_resnet50", "make_detr_r50", "main"]

NC = S.NC
SIZE = S.SIZE


def label_of(t):
    b = t["boxes"]
    areas = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return int(t["class_labels"][int(np.argmax(areas))])


def _xy(ds, idxs):
    imgs, ys = [], []
    for i in idxs:
        im, t = ds[int(i)]
        imgs.append(im)
        ys.append(label_of(t))
    return np.stack(imgs).astype(np.float32), np.asarray(ys, np.int32)


def pretrain_resnet50(steps=1500, batch=64, lr=1e-3, device=None,
                      val_num=256):
    """Stage 1: classification on the detection fixture's images; the
    trained model and its held-out accuracy."""
    from ...models.classification.resnet import ResNet
    from ...train.optimizers import Adam, cosine_schedule

    dev = resolve_device(device)
    torch.manual_seed(0)
    model = ResNet(depth=50, num_classes=NC, device=dev)
    opt = Adam(cosine_schedule(lr, steps))(dict(model.named_parameters()))
    ds = ShapesDetection(num=4096, size=SIZE, seed=7)
    rng = np.random.default_rng(0)
    t0 = time.time()
    model.train()
    for it in range(steps):
        x, y = _xy(ds, rng.integers(0, len(ds), size=batch))
        logits = model(torch.from_numpy(x).to(dev))
        loss = softmax_cross_entropy(logits.float(),
                                     A.to_device(y, dev)).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if it % 250 == 0:
            print(f"  [cls-r50] it {it} loss {float(loss.detach()):.4f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    val = ShapesDetection(num=val_num, size=SIZE, seed=77)
    model.eval()
    correct = total = 0
    with torch.inference_mode():
        for i0 in range(0, len(val), 64):
            x, ys = _xy(val, range(i0, min(i0 + 64, len(val))))
            pred = model(torch.from_numpy(x).to(dev)).argmax(-1).cpu()
            correct += int((pred.numpy() == ys).sum())
            total += len(ys)
    acc = correct / total
    print(f"  [cls-r50] pretrain val acc {acc:.4f} "
          f"({time.time() - t0:.0f}s)", flush=True)
    return model, acc


def make_detr_r50(pretrained_sd, device):
    """Stage 2's builder: the reference's frozen-BatchNorm R50 semantics,
    the backbone from stage 1 (the frozen BatchNorms take its running
    statistics and affine)."""
    from ...models.detection import Detr

    torch.manual_seed(0)
    model = Detr(num_classes=NC, num_queries=25, enc_layers=4, dec_layers=4,
                 dropout=0.0, backbone_depth=50, freeze_bn=True,
                 device=device)
    model.backbone.load_state_dict(pretrained_sd)
    return model


def main(steps_cls=1500, steps_det=12000, device=None, out_dir=None,
         batch=None, val_num=128, pretrain_val=256):
    t0 = time.time()
    cls_model, cls_acc = pretrain_resnet50(
        steps=steps_cls, device=device, batch=batch or 64,
        val_num=pretrain_val)
    sd = {k: v for k, v in cls_model.state_dict().items()
          if not k.startswith("fc")}     # the detection backbone is headless
    del cls_model
    # the reference DETR recipe: backbone at 0.1x the rate, clip 0.1 (a
    # pretrained frozen-BN backbone at the full rate loses its features)
    S.REGISTRY["detr_r50"] = (lambda dev: make_detr_r50(sd, dev),
                              steps_det, 2e-4, 0.55,
                              {"backbone_lr_mult": 0.1, "clip": 0.1})
    S.TARGET_ADAPTERS["detr_r50"] = S.TARGET_ADAPTERS["detr"]
    S.PREDICT_ADAPTERS["detr_r50"] = S.PREDICT_ADAPTERS["detr"]
    r = S.run_model("detr_r50", steps=steps_det, device=device, batch=batch,
                    val_num=val_num)
    r["pretrain_val_acc"] = round(cls_acc, 4)
    r["pretrain_steps"] = steps_cls
    r["total_seconds"] = round(time.time() - t0, 1)
    A.write_results(A.results_path(__file__, "detr_r50_results.json",
                                   out_dir), r)
    print(json.dumps(r), flush=True)
    return A.judge(r)


if __name__ == "__main__":
    a = [x for x in sys.argv[1:] if not x.startswith("--")]
    main(steps_cls=int(a[0]) if a else 1500,
         steps_det=int(a[1]) if len(a) > 1 else 12000,
         device=next((x.split("=", 1)[1] for x in sys.argv[1:]
                      if x.startswith("--device=")), None))
