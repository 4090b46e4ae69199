"""Hermetic facial-landmark accuracy check: no data on disk.

Port of ``demo/facial_landmark_detection/accuracy_check.py``.  The
"sketch face" fixture: a canonical 68-point layout (jaw, brows, nose,
eyes, mouth) under a random similarity transform, drawn as line segments;
the moved points are the landmarks, the eye line's angle the roll.  PFLD
trains from random weights at 112^2 b32 in two phases, and is scored by
the inter-ocular NME in eval mode (running BatchNorm statistics) on 128
held-out faces, floor 0.06:

1. 8,000 steps of L2 on the landmarks (Adam, cosine from 1e-3 to 1e-5),
   with the reference recipe's flip, rotation and occlusion;
2. the BatchNorm statistics re-estimated exactly over 40 batches
   (``train.recalibrate_batch_stats``), then 2,000 steps of the wing loss
   at a tenth of the rate with BatchNorm frozen (eval mode inside the
   loss), so the fine-tune optimises the function that is scored.

Both phases add 0.01 x the L2 of the auxiliary net's angles.

    python -m tlxcv_tpu_torch.demo.facial_landmark_detection.accuracy_check \\
        [steps_l2 [steps_wing]]

writes ``accuracy_results.json`` beside this file (before the assert).
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ...data.landmark_transforms import (RandomHorizontalFlip,
                                         RandomOcclude, RandomRotate)
from ...models.facial_landmark_detection.pfld import PFLD
from ...ops.losses import wing_loss
from ...tasks.facial_landmark_detection import NME
from ...device import resolve_device
from .. import _accuracy as A

__all__ = ["TEMPLATE", "GROUPS", "sample", "main"]

SIZE = 112
NME_BAR = 0.06


def _template():
    """Canonical 68 points in [-1, 1]^2 (x right, y down)."""
    pts = []
    # jaw 0-16: lower arc
    th = np.linspace(np.pi * 0.15, np.pi * 0.85, 17)
    pts += [(np.cos(t) * 0.9, np.sin(t) * 0.9) for t in th][::-1]
    # brows 17-21 / 22-26
    for sgn in (-1, 1):
        xs = np.linspace(0.15, 0.65, 5) * sgn
        pts += [(x, -0.55 - 0.08 * np.cos((abs(x) - 0.4) * 4)) for x in xs]
    # nose 27-35: bridge + base
    pts += [(0.0, y) for y in np.linspace(-0.45, 0.05, 4)]
    pts += [(x, 0.12) for x in np.linspace(-0.15, 0.15, 5)]
    # eyes 36-41 / 42-47: hexagons
    for cx in (-0.4, 0.4):
        th6 = np.linspace(0, 2 * np.pi, 7)[:6]
        pts += [(cx + 0.13 * np.cos(t), -0.3 + 0.07 * np.sin(t))
                for t in th6]
    # mouth 48-67: two ellipses
    th12 = np.linspace(0, 2 * np.pi, 13)[:12]
    pts += [(0.28 * np.cos(t), 0.5 + 0.12 * np.sin(t)) for t in th12]
    th8 = np.linspace(0, 2 * np.pi, 9)[:8]
    pts += [(0.18 * np.cos(t), 0.5 + 0.06 * np.sin(t)) for t in th8]
    return np.asarray(pts, np.float32)  # [68, 2]


TEMPLATE = _template()
GROUPS = [range(0, 17), range(17, 22), range(22, 27), range(27, 31),
          range(31, 36), list(range(36, 42)) + [36],
          list(range(42, 48)) + [42], list(range(48, 60)) + [48],
          list(range(60, 68)) + [60]]

# every polyline segment as an index pair, rasterised at once
_SEG_A = np.asarray([a for g in GROUPS for a in list(g)[:-1]])
_SEG_B = np.asarray([b for g in GROUPS for b in list(g)[1:]])
_T = np.linspace(0.0, 1.0, 32, dtype=np.float32)  # >= the longest segment


def _draw_face(img, pts):
    """Mark every segment's pixels: 32 points a segment (segments here are
    at most ~15 px)."""
    P, Q = pts[_SEG_A], pts[_SEG_B]
    xs = (P[:, 0:1] + (Q[:, 0:1] - P[:, 0:1]) * _T).astype(int).ravel()
    ys = (P[:, 1:2] + (Q[:, 1:2] - P[:, 1:2]) * _T).astype(int).ravel()
    ok = (xs >= 0) & (xs < SIZE) & (ys >= 0) & (ys < SIZE)
    img[ys[ok], xs[ok]] = 1.0


class _NpRandom:
    """The ``random`` module's face over a numpy Generator (for the
    transforms)."""

    def __init__(self, rng):
        self._rng = rng

    def random(self):
        return float(self._rng.uniform())

    def choice(self, seq):
        return seq[int(self._rng.integers(0, len(seq)))]

    def randint(self, a, b):
        return int(self._rng.integers(a, b + 1))


def augment_pipeline(rng):
    """The reference recipe's flip (mirror-indexed), rotation, occlusion."""
    r = _NpRandom(rng)
    return [RandomHorizontalFlip(rng=r), RandomRotate(range(-8, 9), rng=r),
            RandomOcclude((24, 24), rng=r)]


def sample(rng, n, augments=None):
    """n faces [n, S, S, 3] f32, their landmarks [n, 136] in [0, 1] and
    euler angles [n, 3] (the roll from the final eye line)."""
    imgs = np.asarray(rng.uniform(0, 0.2, size=(n, SIZE, SIZE, 3)),
                      np.float32)
    lms = np.zeros((n, 68, 2), np.float32)
    rolls = np.zeros((n,), np.float32)
    for i in range(n):
        scale = rng.uniform(0.28, 0.42) * SIZE
        rot = rng.uniform(-0.4, 0.4)
        cx = rng.uniform(0.4, 0.6) * SIZE
        cy = rng.uniform(0.4, 0.6) * SIZE
        c, s = np.cos(rot), np.sin(rot)
        R = np.asarray([[c, -s], [s, c]], np.float32)
        pts = TEMPLATE @ R.T * scale + (cx, cy)
        color = rng.uniform(0.7, 1.0)
        _draw_face(imgs[i, :, :, 0], pts)
        imgs[i, :, :, 1] = imgs[i, :, :, 0] * color
        imgs[i, :, :, 2] = imgs[i, :, :, 0] * (1 - color)
        if augments:
            img, label = imgs[i], {"landmark": pts}
            for t in augments:
                img, label = t((img, label))
            imgs[i] = img
            pts = np.asarray(label["landmark"], np.float32)
        lms[i] = pts / SIZE
        # the roll from the final landmarks (after any flip and rotation)
        eye_d = pts[42:48].mean(0) - pts[36:42].mean(0)
        rolls[i] = np.degrees(np.arctan2(eye_d[1], eye_d[0]))
    eulers = np.stack([np.zeros_like(rolls), np.zeros_like(rolls), rolls],
                      -1)
    return imgs, lms.reshape(n, -1), eulers


def objective(model, x, lm, eu, use_wing):
    """The landmark loss (L2, or wing in normalised units: 10 px and 2 px
    over SIZE) plus 0.01 x the angles' L2."""
    landmarks, features = model(x)
    angle = model.auxiliarynet(features)
    ang_loss = torch.mean(torch.sum((angle - eu) ** 2, -1))
    b = landmarks.shape[0]
    if use_wing:
        lm_loss = wing_loss(landmarks.reshape(b, -1), lm.reshape(b, -1),
                            w=10.0 / SIZE, epsilon=2.0 / SIZE,
                            reduction="none")
        lm_loss = torch.mean(torch.sum(lm_loss, -1))
    else:
        lm_loss = torch.mean(torch.sum(
            (landmarks.reshape(b, -1) - lm) ** 2, -1))
    return lm_loss + 0.01 * ang_loss


def main(steps_l2=8000, steps_wing=2000, batch=32, val_images=128,
         recal_batches=40, device=None, out_dir=None):
    from ...train.bn_recal import recalibrate_batch_stats
    from ...train.optimizers import Adam, cosine_schedule

    dev = resolve_device(device)
    A.reset_launches()
    torch.manual_seed(0)
    model = PFLD(num_landmarks=68, device=dev)

    def predict(x):
        model.eval()
        with torch.inference_mode():
            return model(torch.from_numpy(x).to(dev))[0].float().cpu().numpy()

    def eval_nme(n_images):
        m_ = NME(num_points=68)
        vrng = np.random.default_rng(999)
        for i0 in range(0, n_images, 32):
            x, lm, _ = sample(vrng, min(32, n_images - i0))
            m_.update(predict(x), lm)
        return m_.result()

    rng = np.random.default_rng(0)
    augments = augment_pipeline(rng)
    losses = {}
    t0 = time.time()

    def phase(name, use_wing, steps, lr, freeze_bn=False):
        """``freeze_bn``: the loss runs in eval mode, on the running
        statistics, which it never updates."""
        opt = Adam(cosine_schedule(lr, steps, 1e-2))(
            dict(model.named_parameters()))
        for it in range(steps):
            x, lm, eu = sample(rng, batch, augments=augments)
            model.train(not freeze_bn)
            loss = objective(model, *(A.to_device(a, dev)
                                      for a in (x, lm, eu)), use_wing)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            if it % 500 == 0:
                losses[f"{name}_{it}"] = float(loss.detach())
                print(f"[{name}] it {it} loss {float(loss.detach()):.4f} "
                      f"eval-NME {eval_nme(val_images // 2):.4f} "
                      f"({time.time()-t0:.0f}s)", flush=True)

    phase("l2", False, steps_l2, 1e-3)
    # exact BatchNorm statistics with the weights frozen, then the wing
    # fine-tune against them
    recal = [torch.from_numpy(sample(rng, batch)[0]).to(dev)
             for _ in range(recal_batches)]
    recalibrate_batch_stats(model, recal)
    del recal
    print(f"post-l2-recal eval-NME {eval_nme(val_images // 2):.4f} "
          f"({time.time()-t0:.0f}s)", flush=True)
    phase("wing", True, steps_wing, 1e-4, freeze_bn=True)
    print(f"post-wing eval-NME {eval_nme(val_images // 2):.4f} "
          f"({time.time()-t0:.0f}s)", flush=True)

    nme = eval_nme(val_images)       # held-out, no augmentation
    print(f"NME (inter-ocular) = {nme:.4f} ({time.time()-t0:.0f}s)")
    result = {"metric": "nme_interocular", "value": nme, "bar": NME_BAR,
              "mode": "eval (running BN stats)", "steps_l2": steps_l2,
              "steps_wing": steps_wing, "batch": batch,
              "images": val_images, "seconds": round(time.time() - t0, 1),
              "losses": losses, "device": A.card(dev),
              "kernel_launches": A.launch_counts(),
              "metrics": [A.metric("nme_interocular", nme, NME_BAR,
                                   higher=False)]}
    A.write_results(A.results_path(__file__, "accuracy_results.json",
                                   out_dir), result)
    return A.judge(result)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    main(steps_l2=int(args[0]) if args else 8000,
         steps_wing=int(args[1]) if len(args) > 1 else 2000,
         device=next((a.split("=", 1)[1] for a in sys.argv[1:]
                      if a.startswith("--device=")), None))
