"""QAT to int8 serving, scored on the task: a micro-ViT.

Port of ``demo/image_classification/accuracy_check_qat.py``.  The task:
the class of the largest object in ``ShapesDetection`` images at 64^2;
the model a ViT (patch 8, width 128, depth 4, 4 heads, MLP ratio 2).

1. float training (1,500 steps at b64, Adam on a cosine decay from
   1e-3) -> ``float_acc`` on 512 held-out images;
2. PTQ (``quantize_weights`` + ``calibrate_activations`` on two batches
   of 32: every Linear full int8) -> ``ptq_acc``;
3. QAT: the float weights again, ``enable_qat(act=True)``, the same
   calibration, 600 fine-tune steps under fake quant (cosine from 2e-4),
   then ``qat_serving_convert`` -> ``qat_int8_acc``.

Floor: ``qat_int8_acc >= float_acc - 0.02`` and ``>= ptq_acc - 0.005``.
On the card the float training runs the flash kernels (f32) and the int8
models serve through the hand-written int8 GEMM.

    python -m tlxcv_tpu_torch.demo.image_classification.accuracy_check_qat \\
        [steps [qat_steps]]

writes ``accuracy_results_qat.json`` beside this file (before it fails).
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from ...data import ShapesDetection
from ...models.classification.vision_transformer import VisionTransformer
from ...ops.losses import softmax_cross_entropy
from ...ops.quant import (calibrate_activations, enable_qat,
                          qat_serving_convert, quantize_weights)
from ...device import resolve_device
from .. import _accuracy as A

__all__ = ["label_of", "build_vit", "make_data", "main"]

SIZE = 64
NC = 3
BATCH = 64


def build_vit(device):
    torch.manual_seed(0)
    return VisionTransformer(img_size=SIZE, patch_size=8, num_classes=NC,
                             embed_dim=128, depth=4, num_heads=4,
                             mlp_ratio=2.0, qkv_bias=True, device=device)


def label_of(t):
    """The class of the sample's largest box."""
    b = t["boxes"]
    areas = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return int(t["class_labels"][int(np.argmax(areas))])


def as_xy(ds, idxs):
    imgs, ys = [], []
    for i in idxs:
        im, t = ds[int(i)]
        imgs.append(im)
        ys.append(label_of(t))
    return np.stack(imgs).astype(np.float32), np.asarray(ys, np.int32)


def make_data(val_num=512):
    train = ShapesDetection(num=4096, size=SIZE, seed=11)
    val = ShapesDetection(num=val_num, size=SIZE, seed=99)
    Xv, Yv = as_xy(val, range(len(val)))
    return train, Xv, Yv


def finetune(model, train, steps, lr, device, batch=BATCH):
    from ...train.optimizers import Adam, cosine_schedule

    opt = Adam(cosine_schedule(lr, steps))(dict(model.named_parameters()))
    rng = np.random.default_rng(0)
    losses = {}
    t0 = time.time()
    model.train()
    for it in range(steps):
        X, Y = as_xy(train, rng.integers(0, len(train), size=batch))
        logits = model(torch.from_numpy(X).to(device))
        loss = softmax_cross_entropy(logits.float(),
                                     A.to_device(Y, device)).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if it % 250 == 0:
            losses[it] = float(loss.detach())
            print(f"  it {it} loss {losses[it]:.4f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    return losses


def accuracy(model, Xv, Yv, device):
    model.eval()
    correct = 0
    with torch.inference_mode():
        for i0 in range(0, len(Xv), 128):
            x = torch.from_numpy(Xv[i0:i0 + 128]).to(device)
            pred = model(x).argmax(-1).cpu().numpy()
            correct += int((pred == Yv[i0:i0 + 128]).sum())
    return correct / len(Xv)


def main(steps=1500, qat_steps=600, batch=BATCH, val_num=512, device=None,
         out_dir=None):
    dev = resolve_device(device)
    A.reset_launches()
    t0 = time.time()
    train, Xv, Yv = make_data(val_num)
    model = build_vit(dev)
    float_losses = finetune(model, train, steps, 1e-3, dev, batch)
    float_acc = accuracy(model, Xv, Yv, dev)
    print(f"float acc {float_acc:.4f}", flush=True)
    sd = model.state_dict()
    calib = [as_xy(train, range(i * 32, (i + 1) * 32))[0] for i in range(2)]

    m_ptq = build_vit(dev)
    m_ptq.load_state_dict(sd)
    quantize_weights(m_ptq)
    calibrate_activations(m_ptq, calib)
    ptq_acc = accuracy(m_ptq, Xv, Yv, dev)
    print(f"ptq acc {ptq_acc:.4f}", flush=True)
    del m_ptq

    m_qat = build_vit(dev)
    m_qat.load_state_dict(sd)
    n = enable_qat(m_qat, act=True)
    calibrate_activations(m_qat, calib)
    qat_losses = finetune(m_qat, train, qat_steps, 2e-4, dev, batch)
    qat_serving_convert(m_qat)
    launches_before = A.launch_counts()["int8_matmul"]
    qat_int8_acc = accuracy(m_qat, Xv, Yv, dev)
    qat_int8_launches = A.launch_counts()["int8_matmul"] - launches_before
    print(f"qat-int8 acc {qat_int8_acc:.4f} ({n} layers)", flush=True)
    # within 0.02 of its float self, and never worse than plain PTQ
    metrics = [A.metric("qat_int8_acc", qat_int8_acc, float_acc - 0.02),
               A.metric("qat_int8_acc_vs_ptq", qat_int8_acc, ptq_acc - 0.005)]

    r = {
        "metric": "vit_qat_int8",
        "model": f"micro-ViT {SIZE}^2/p8 d128x4",
        "float_acc": round(float_acc, 4),
        "ptq_acc": round(ptq_acc, 4),
        "qat_int8_acc": round(qat_int8_acc, 4),
        "bar": round(float_acc - 0.02, 4),
        "steps": steps, "qat_steps": qat_steps,
        "seconds": round(time.time() - t0, 1),
        "pass": all(m["ok"] for m in metrics), "metrics": metrics,
        "batch": batch, "images": len(Xv), "qat_layers": n,
        "losses": {"float": float_losses, "qat": qat_losses},
        "qat_int8_launches": qat_int8_launches,
        "device": A.card(dev), "kernel_launches": A.launch_counts(),
    }
    A.write_results(A.results_path(__file__, "accuracy_results_qat.json",
                                   out_dir), r)
    print(json.dumps(r), flush=True)
    return A.judge(r)


if __name__ == "__main__":
    a = [x for x in sys.argv[1:] if not x.startswith("--")]
    main(steps=int(a[0]) if a else 1500,
         qat_steps=int(a[1]) if len(a) > 1 else 600,
         device=next((x.split("=", 1)[1] for x in sys.argv[1:]
                      if x.startswith("--device=")), None))
