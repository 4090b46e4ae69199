"""Hermetic pose accuracy check: no data on disk.

Port of ``demo/human_pose_estimation/accuracy_check.py``.  The fixture:
each of 5 "joints" is a small disk of a fixed colour at a random place,
its exact centre the keypoint.  A PoseHighResolutionNet on the
HRNet-W18-small trunk trains from random weights (800 steps at b16 128^2,
Adam 1e-3) against Gaussian heatmap targets made on the device, and is
scored on 64 held-out images by PCK@0.05 (floor 0.95) and by COCO's OKS
keypoint AP (floor 0.80).

    python -m tlxcv_tpu_torch.demo.human_pose_estimation.accuracy_check

writes ``accuracy_results.json`` beside this file (before the asserts).
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ...models.backbones.hrnet import hrnet_w18_small_v1
from ...models.human_pose_estimation.hrnet import PoseHighResolutionNet
from ...tasks.human_pose_estimation import (PCK, generate_heatmap_target,
                                            get_max_preds)
from ...utils.coco_eval import compute_coco_stats
from ...device import resolve_device
from .. import _accuracy as A

__all__ = ["sample", "main"]

SIZE = 128
J = 5
PCK_BAR = 0.95
OKS_BAR = 0.80
COLORS = np.asarray([[1.0, 0.2, 0.2], [0.2, 1.0, 0.2], [0.2, 0.2, 1.0],
                     [1.0, 1.0, 0.2], [0.2, 1.0, 1.0]], np.float32)


def sample(rng, n):
    """n images [n, S, S, 3] f32 and their keypoints [n, J, 3] (x, y, 1)."""
    imgs = np.asarray(
        rng.uniform(0, 0.3, size=(n, SIZE, SIZE, 3)), np.float32)
    kps = np.zeros((n, J, 3), np.float32)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float32)
    for i in range(n):
        for j in range(J):
            cx = rng.uniform(8, SIZE - 8)
            cy = rng.uniform(8, SIZE - 8)
            r = rng.uniform(3, 5)
            m = (xx - cx) ** 2 + (yy - cy) ** 2 <= r ** 2
            imgs[i][m] = COLORS[j]
            kps[i, j] = (cx, cy, 1.0)
    return imgs, kps


def _targets(kps):
    return generate_heatmap_target(kps, input_size=(SIZE, SIZE),
                                   heatmap_size=(SIZE // 4, SIZE // 4))


def main(steps=800, batch=16, val_images=64, device=None, out_dir=None):
    from ...train.optimizers import Adam

    dev = resolve_device(device)
    A.reset_launches()
    torch.manual_seed(0)
    model = PoseHighResolutionNet(num_joints=J,
                                  backbone=hrnet_w18_small_v1(device=dev),
                                  device=dev)
    opt = Adam(1e-3)(dict(model.named_parameters()))
    rng = np.random.default_rng(0)
    model.train()
    losses = {}
    t0 = time.time()
    for it in range(steps):
        x, kps = (A.to_device(a, dev) for a in sample(rng, batch))
        loss = model.loss_fn(model(x), _targets(kps))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if it % 200 == 0:
            losses[it] = float(loss.detach())
            print(f"it {it} loss {losses[it]:.5f} ({time.time()-t0:.0f}s)",
                  flush=True)

    # PCK and OKS keypoint AP (COCO's protocol) on the same held-out images
    model.eval()
    pck = PCK(threshold=0.05)
    sigmas = np.full(J, 0.05, np.float32)
    oks_preds, oks_gts = [], []
    vrng = np.random.default_rng(12345)
    with torch.inference_mode():
        for i0 in range(0, val_images, 16):  # batches of 16, as drawn
            x, kps = sample(vrng, min(16, val_images - i0))
            hm = model(torch.from_numpy(x).to(dev)).float().cpu().numpy()
            tgt, _ = _targets(torch.from_numpy(kps))
            pck.update(hm, tgt.numpy())
            # the heatmap's argmax as image keypoints, for OKS-AP
            pred_xy, maxvals = get_max_preds(hm)
            pred_xy = pred_xy * 4.0  # heatmap stride
            for i in range(len(x)):
                pk = np.concatenate([pred_xy[i], maxvals[i][:, None]],
                                    -1)[None]  # [1, J, 3]
                oks_preds.append({
                    "boxes": np.asarray([[0, 0, SIZE, SIZE]], np.float32),
                    "scores": np.asarray([float(maxvals[i].mean())],
                                         np.float32),
                    "labels": np.asarray([1]), "keypoints": pk})
                oks_gts.append({
                    "boxes": np.asarray([[0, 0, SIZE, SIZE]], np.float32),
                    "labels": np.asarray([1]), "keypoints": kps[i][None],
                    "area": np.asarray([float(SIZE * SIZE)])})
    print(f"PCK@0.05 = {pck.result():.4f}")
    oks = compute_coco_stats(oks_preds, oks_gts, iou_type="keypoints",
                             kpt_sigmas=sigmas)
    print(f"OKS-AP@[.50:.95] = {oks['map']:.4f}  OKS-AP50 = "
          f"{oks['map50']:.4f}  OKS-AP75 = {oks['stats'][2]:.4f}")
    result = {"metric": "pck@0.05", "value": pck.result(), "bar": PCK_BAR,
              "oks_map": oks["map"], "oks_map50": oks["map50"],
              "oks_map75": float(oks["stats"][2]), "oks_bar": OKS_BAR,
              "steps": steps, "batch": batch,
              "images": val_images,
              "seconds": round(time.time() - t0, 1), "losses": losses,
              "device": A.card(dev), "kernel_launches": A.launch_counts(),
              "metrics": [A.metric("pck@0.05", pck.result(), PCK_BAR),
                          A.metric("oks_map", oks["map"], OKS_BAR)]}
    A.write_results(A.results_path(__file__, "accuracy_results.json",
                                   out_dir), result)
    return A.judge(result)


if __name__ == "__main__":
    main(device=next((a.split("=", 1)[1] for a in sys.argv[1:]
                      if a.startswith("--device=")), None))
