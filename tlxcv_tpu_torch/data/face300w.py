"""300-W facial landmarks (counterpart of ``tlxcv_tpu/data/face300w.py``):
68-point landmarks from the ``.pts`` or ``.mat`` file beside each image."""
from __future__ import annotations

import os

import numpy as np

from .vision import VisionDataset


def read_pts(path):
    with open(path) as f:
        lines = f.read().strip().splitlines()
    start = lines.index("{") + 1
    end = lines.index("}")
    pts = [list(map(float, l.split())) for l in lines[start:end]]
    return np.asarray(pts, np.float32)


def read_mat(path):
    from scipy.io import loadmat

    d = loadmat(path)
    key = [k for k in d if not k.startswith("_")][0]
    return np.asarray(d[key], np.float32).reshape(-1, 2)


class Face300W(VisionDataset):
    def __init__(self, root, split="train", transforms=None, transform=None,
                 target_transform=None):
        super().__init__(root, transforms, transform, target_transform)
        self.samples = []
        for dirpath, _, files in os.walk(root):
            for f in sorted(files):
                if f.lower().endswith((".png", ".jpg", ".jpeg")):
                    base = os.path.splitext(os.path.join(dirpath, f))[0]
                    for ext, reader in ((".pts", read_pts), (".mat", read_mat)):
                        if os.path.exists(base + ext):
                            self.samples.append(
                                (os.path.join(dirpath, f), base + ext, reader))
                            break
        if split == "train":
            self.samples = [s for i, s in enumerate(self.samples) if i % 10 != 0]
        elif split == "test":
            self.samples = [s for i, s in enumerate(self.samples) if i % 10 == 0]

    def __getitem__(self, index):
        img_path, lm_path, reader = self.samples[index]
        from PIL import Image

        image = np.asarray(Image.open(img_path).convert("RGB"))
        landmarks = reader(lm_path)
        if self.transforms:
            image, landmarks = self.transforms(image, landmarks)
        return image, landmarks

    def __len__(self):
        return len(self.samples)
