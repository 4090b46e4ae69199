"""Synthetic circles (counterpart of ``tlxcv_tpu/data/circles.py``): the
hermetic segmentation fixture, drawn from a seeded numpy generator, so the
same seed gives the reference's images and masks."""
from __future__ import annotations

import numpy as np

from .vision import VisionDataset


class Circles(VisionDataset):
    def __init__(self, num, nx=172, ny=172, nc=1, transforms=None,
                 transform=None, target_transform=None, seed=None):
        super().__init__(None, transforms, transform, target_transform)
        self.num = num
        self.nx = nx
        self.ny = ny
        self.nc = nc
        self._rng = np.random.default_rng(seed)

    def __getitem__(self, index):
        image, label = _create_image_and_mask(self._rng, self.nx, self.ny, self.nc)
        image = image.astype(np.float32)
        label = label.astype(np.float32)
        if self.transforms:
            image, label = self.transforms(image, label)
        return image, label

    def __len__(self):
        return self.num


def _create_image_and_mask(rng, nx, ny, nc, cnt=10, r_min=3, r_max=10,
                           border=32, sigma=20):
    # Scale the keep-out border down for small images so the sampling
    # interval [border, n - border) is never empty (nx<=64 crashed before).
    bx = min(border, max(1, nx // 2 - r_max))
    by = min(border, max(1, ny // 2 - r_max))
    image = np.ones((nx, ny, 1))
    mask = np.zeros((nx, ny), dtype=bool)
    for _ in range(cnt):
        a = rng.integers(bx, nx - bx)
        b = rng.integers(by, ny - by)
        r = rng.integers(r_min, r_max)
        h = rng.integers(1, 255)
        y, x = np.ogrid[-a:nx - a, -b:ny - b]
        m = x * x + y * y <= r * r
        mask = np.logical_or(mask, m)
        image[m] = h
    image = image + rng.normal(scale=sigma, size=image.shape)
    image -= np.amin(image)
    image /= np.amax(image)
    image = np.concatenate([image] * nc, axis=-1)
    mask = np.stack([~mask, mask], axis=-1)
    return image, mask
