"""Hermetic video-classification accuracy check: no data on disk.

Port of ``demo/video_classification/accuracy_check.py``.  The *motion*
fixture: each clip (16 frames of 64^2) shows one shape (disk or square,
random size, colour and start) moving in one of four directions with
toroidal wrap-around on a noisy background; the class is the direction,
so no single frame tells it.  InceptionI3d trains from random weights
through the ``VideoClassification`` task's loss (per-frame BCE against
the clip's one-hot) for 400 steps at b16 (Adam on a cosine decay from
3e-4), and is scored by clip accuracy (the majority of the per-frame
argmax) on 128 held-out clips.  Floor 0.90.

    python -m tlxcv_tpu_torch.demo.video_classification.accuracy_check [steps]

writes ``accuracy_results.json`` beside this file (before the assert).
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ...models.video_classification import InceptionI3d
from ...tasks.video_classification import VideoClassification
from ...device import resolve_device
from .. import _accuracy as A

__all__ = ["DIRS", "FRAMES", "clip", "batch", "main"]

SIZE = 64
FRAMES = 16
NC = 4
BAR = 0.90
DIRS = np.asarray([[0, -1], [0, 1], [-1, 0], [1, 0]], np.float32)  # dy,dx


def clip(rng):
    """One clip [T, S, S, 3] f32 and its direction label."""
    label = int(rng.integers(0, NC))
    frames = np.asarray(rng.uniform(0, 0.25, size=(FRAMES, SIZE, SIZE, 3)),
                        np.float32)
    r = float(rng.uniform(5, 11))
    speed = float(rng.uniform(1.2, 2.6))
    # a uniform start and toroidal motion: the first frame's position
    # carries no class information
    cy, cx = rng.uniform(0, SIZE, size=2)
    color = rng.uniform(0.6, 1.0, size=3).astype(np.float32)
    kind = int(rng.integers(0, 2))
    yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float32)
    for t in range(FRAMES):
        y = (cy + DIRS[label][0] * speed * t) % SIZE
        x = (cx + DIRS[label][1] * speed * t) % SIZE
        # minimum-image (wrapped) offsets
        oy = (yy - y + SIZE / 2) % SIZE - SIZE / 2
        ox = (xx - x + SIZE / 2) % SIZE - SIZE / 2
        if kind == 0:
            m = (oy ** 2 + ox ** 2) <= r * r
        else:
            m = (np.abs(oy) <= r) & (np.abs(ox) <= r)
        frames[t][m] = color
    return frames, label


def batch(rng, n):
    """n clips [n, T, S, S, 3] f32 and their labels [n] (numpy)."""
    clips, labels = zip(*(clip(rng) for _ in range(n)))
    return np.stack(clips), np.asarray(labels)


def main(steps=400, batch_size=16, val_clips=128, device=None,
         out_dir=None):
    from ...train.optimizers import Adam, cosine_schedule

    dev = resolve_device(device)
    A.reset_launches()
    torch.manual_seed(0)
    task = VideoClassification(
        backbone=InceptionI3d(num_classes=NC, in_channels=3, device=dev))
    opt = Adam(cosine_schedule(3e-4, steps))(dict(task.named_parameters()))
    eye = np.eye(NC, dtype=np.float32)
    rng = np.random.default_rng(0)
    losses = {}
    t0 = time.time()
    task.train()
    for it in range(steps):
        x, y = batch(rng, batch_size)
        logits = task(torch.from_numpy(x).to(dev))
        # per-frame BCE against the clip's one-hot, broadcast over T'
        onehot = torch.from_numpy(eye[y]).to(dev)
        loss = task.loss_fn(logits, onehot[:, None, :].expand_as(logits))
        loss = loss.mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if it % 50 == 0:
            losses[it] = float(loss.detach())
            print(f"[i3d] it {it} loss {losses[it]:.4f} "
                  f"({time.time() - t0:.0f}s)", flush=True)

    # held out: a clip's label is the majority of its per-frame argmax
    task.eval()
    eval_rng = np.random.default_rng(999)
    correct = total = 0
    with torch.inference_mode():
        for i0 in range(0, val_clips, 16):  # batches of 16, as drawn
            x, y = batch(eval_rng, min(16, val_clips - i0))
            per_frame = task.predict(torch.from_numpy(x).to(dev)).cpu()
            votes = [np.bincount(f, minlength=NC).argmax()
                     for f in per_frame.numpy()]
            correct += int(np.sum(np.asarray(votes) == y))
            total += len(y)
    acc = correct / total
    print(f"[i3d] held-out clip accuracy {acc:.4f} ({total} clips) "
          f"bar {BAR} ({time.time() - t0:.0f}s)")
    result = {"metric": "clip_accuracy", "value": acc, "bar": BAR,
              "steps": steps, "clips": total,
              "seconds": round(time.time() - t0, 1), "batch": batch_size,
              "losses": losses, "device": A.card(dev),
              "kernel_launches": A.launch_counts(),
              "metrics": [A.metric("clip_accuracy", acc, BAR)]}
    A.write_results(A.results_path(__file__, "accuracy_results.json",
                                   out_dir), result)
    A.judge(result)
    print("PASS")
    return result


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    main(steps=int(args[0]) if args else 400,
         device=next((a.split("=", 1)[1] for a in sys.argv[1:]
                      if a.startswith("--device=")), None))
