"""Procedural detection dataset (counterpart of
``tlxcv_tpu/data/shapes_det.py``, numpy only): deterministic images with
exactly-known boxes and instance masks for three visually distinct
classes, so a detector trains with no data on disk.

Classes: 0 = filled rectangle, 1 = filled ellipse, 2 = hollow frame.
Every sample is reproducible from (seed, index); the same (seed, index)
gives the same sample as the JAX package's dataset.
"""
from __future__ import annotations

import numpy as np

from .vision import VisionDataset

__all__ = ["ShapesDetection", "pad_targets"]


class ShapesDetection(VisionDataset):
    num_classes = 3

    def __init__(self, num=1000, size=128, max_objects=3, seed=0,
                 return_masks=False, transforms=None, transform=None,
                 target_transform=None):
        super().__init__(None, transforms, transform, target_transform)
        self.num = num
        self.size = size
        self.max_objects = max_objects
        self.seed = seed
        self.return_masks = return_masks

    def __len__(self):
        return self.num

    def _draw(self, rng):
        s = self.size
        img = rng.uniform(0, 0.25, size=(s, s, 3)).astype(np.float32)
        # low-frequency background variation
        gx = np.linspace(0, 1, s, dtype=np.float32)
        img += 0.15 * gx[None, :, None] * rng.uniform(0, 1, size=3)
        n_obj = int(rng.integers(1, self.max_objects + 1))
        boxes, labels, masks = [], [], []
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
        for _ in range(n_obj):
            cls = int(rng.integers(0, 3))
            w = float(rng.uniform(s * 0.15, s * 0.4))
            h = float(rng.uniform(s * 0.15, s * 0.4))
            cx = float(rng.uniform(w / 2 + 2, s - w / 2 - 2))
            cy = float(rng.uniform(h / 2 + 2, s - h / 2 - 2))
            color = rng.uniform(0.6, 1.0, size=3).astype(np.float32)
            x1, y1 = cx - w / 2, cy - h / 2
            x2, y2 = cx + w / 2, cy + h / 2
            if cls == 0:                       # filled rectangle
                m = (xx >= x1) & (xx <= x2) & (yy >= y1) & (yy <= y2)
            elif cls == 1:                     # filled ellipse
                m = (((xx - cx) / (w / 2)) ** 2
                     + ((yy - cy) / (h / 2)) ** 2) <= 1.0
            else:                              # hollow frame (3px wall)
                outer = (xx >= x1) & (xx <= x2) & (yy >= y1) & (yy <= y2)
                inner = ((xx >= x1 + 3) & (xx <= x2 - 3)
                         & (yy >= y1 + 3) & (yy <= y2 - 3))
                m = outer & ~inner
            img[m] = color
            boxes.append([x1, y1, x2, y2])
            labels.append(cls)
            masks.append(m)
        # later shapes paint over earlier ones: keep only the visible
        # pixels of each instance so the GT masks match the rendering
        for i in range(n_obj - 1):
            for j in range(i + 1, n_obj):
                masks[i] = masks[i] & ~masks[j]
        target = {"boxes": np.asarray(boxes, np.float32),
                  "class_labels": np.asarray(labels, np.int64)}
        if self.return_masks:
            target["masks"] = np.stack(masks)
        return img, target

    def __getitem__(self, index):
        rng = np.random.default_rng((self.seed, index))
        image, target = self._draw(rng)
        if self.transforms is not None:
            image, target = self.transforms(image, target)
        return image, target


def pad_targets(max_objects):
    """A ``DataLoader`` collate function for detection samples: images
    stacked [B, H, W, 3] f32, and the ground truth padded to
    ``max_objects`` slots, ``{"boxes" [B, M, 4] f32, "class_labels" [B, M]
    int64, "mask" [B, M] f32 validity, "masks" [B, M, H, W] f32}`` (masks
    when the samples carry them), as
    ``demo/object_detection/accuracy_check_instance_seg.py`` pads them.
    Objects past ``max_objects`` are dropped."""
    m = max_objects

    def collate(samples):
        b = len(samples)
        h, w = samples[0][0].shape[:2]
        boxes = np.zeros((b, m, 4), np.float32)
        labels = np.zeros((b, m), np.int64)
        valid = np.zeros((b, m), np.float32)
        with_masks = "masks" in samples[0][1]
        masks = np.zeros((b, m, h, w), np.float32) if with_masks else None
        for i, (_, t) in enumerate(samples):
            n = min(len(t["boxes"]), m)
            boxes[i, :n] = t["boxes"][:n]
            labels[i, :n] = t["class_labels"][:n]
            valid[i, :n] = 1
            if with_masks:
                masks[i, :n] = t["masks"][:n]
        target = {"boxes": boxes, "class_labels": labels, "mask": valid}
        if with_masks:
            target["masks"] = masks
        return np.stack([np.asarray(s[0], np.float32) for s in samples]), \
            target

    return collate
