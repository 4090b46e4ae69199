"""CIFAR-10 (counterpart of ``tlxcv_tpu/data/cifar.py``): the standard
``cifar-10-batches-py`` pickle batches, read from disk (nothing is
downloaded); images NHWC uint8, labels int64."""
from __future__ import annotations

import os
import pickle

import numpy as np

from .vision import VisionDataset


class Cifar10(VisionDataset):
    def __init__(self, root, split="train", transforms=None, transform=None,
                 target_transform=None):
        super().__init__(root, transforms, transform, target_transform)
        base = os.path.join(root, "cifar-10-batches-py")
        if not os.path.isdir(base):
            base = root
        files = ([f"data_batch_{i}" for i in range(1, 6)] if split == "train"
                 else ["test_batch"])
        xs, ys = [], []
        for f in files:
            path = os.path.join(base, f)
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"CIFAR-10 batch {path} not found; download "
                    "cifar-10-python.tar.gz and extract under root")
            with open(path, "rb") as fh:
                d = pickle.load(fh, encoding="bytes")
            xs.append(d[b"data"])
            ys.extend(d[b"labels"])
        x = np.concatenate(xs).reshape(-1, 3, 32, 32)
        self.data = np.transpose(x, (0, 2, 3, 1))  # NHWC uint8
        self.targets = np.asarray(ys, np.int64)

    def __getitem__(self, index):
        img, target = self.data[index], int(self.targets[index])
        if self.transforms:
            img, target = self.transforms(img, target)
        return img, target

    def __len__(self):
        return len(self.data)
