"""CASIA-WebFace identity classification (counterpart of
``tlxcv_tpu/data/casiawebface.py``): one class per folder, a seeded split."""
from __future__ import annotations

import os

import numpy as np

from .vision import VisionDataset


class CasiaWebFace(VisionDataset):
    def __init__(self, root, split="train", test_ratio=0.05, transforms=None,
                 transform=None, target_transform=None, seed=0):
        super().__init__(root, transforms, transform, target_transform)
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        samples = []
        for c in classes:
            d = os.path.join(root, c)
            for f in sorted(os.listdir(d)):
                if f.lower().endswith((".jpg", ".jpeg", ".png")):
                    samples.append((os.path.join(d, f), self.class_to_idx[c]))
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(samples))
        n_test = int(len(samples) * test_ratio)
        sel = idx[:n_test] if split == "test" else idx[n_test:]
        self.samples = [samples[i] for i in sel]
        self.num_classes = len(classes)

    def __getitem__(self, index):
        path, label = self.samples[index]
        from PIL import Image

        image = np.asarray(Image.open(path).convert("RGB"))
        if self.transforms:
            image, label = self.transforms(image, label)
        return image, label

    def __len__(self):
        return len(self.samples)
