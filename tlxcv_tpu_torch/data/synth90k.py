"""Synth90k OCR word crops (counterpart of ``tlxcv_tpu/data/synth90k.py``):
``annotation_{split}.txt`` lines ``path label_idx``, the word read from the
file name (``..._WORD_...jpg``, the mjsynth convention), the image as an
RGB uint8 array.  PIL is imported only to read images."""
from __future__ import annotations

import os

import numpy as np

from .vision import VisionDataset

__all__ = ["Synth90k"]


class Synth90k(VisionDataset):
    def __init__(self, root, split="train", transforms=None, transform=None,
                 target_transform=None):
        super().__init__(root, transforms, transform, target_transform)
        ann = os.path.join(root, f"annotation_{split}.txt")
        self.samples = []
        with open(ann) as f:
            for line in f:
                path = line.strip().split()[0]
                word = os.path.basename(path).split("_")[1]
                self.samples.append((path, word))

    def __getitem__(self, index):
        path, word = self.samples[index]
        from PIL import Image

        image = np.asarray(Image.open(
            os.path.join(self.root, path)).convert("RGB"))
        if self.transforms:
            image, word = self.transforms(image, word)
        return image, word

    def __len__(self):
        return len(self.samples)
