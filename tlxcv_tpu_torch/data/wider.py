"""WIDER FACE (counterpart of ``tlxcv_tpu/data/wider.py``): the
retinaface-style label.txt parser, targets [N, 15] = normalized xyxy box,
5 normalized landmarks and a validity flag, and ``split_train_test``."""
from __future__ import annotations

import os

import numpy as np

from .vision import VisionDataset


def parse_wider_txt(label_path):
    """Parse retinaface-style label.txt: '# path' lines then per-face rows
    of bbox(4) + 5 landmarks x,y,vis triples + score."""
    samples = []
    path, rows = None, []
    with open(label_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                if path is not None:
                    samples.append((path, rows))
                path, rows = line[1:].strip(), []
            else:
                rows.append([float(x) for x in line.split()])
    if path is not None:
        samples.append((path, rows))
    return samples


class Wider(VisionDataset):
    def __init__(self, root, label_file=None, split="train", transforms=None,
                 transform=None, target_transform=None):
        super().__init__(root, transforms, transform, target_transform)
        label_file = label_file or os.path.join(root, split, "label.txt")
        self.image_dir = os.path.join(root, split, "images")
        self.samples = parse_wider_txt(label_file)

    def _to_target(self, rows, w, h):
        """rows -> [N, 15]: bbox4(norm xyxy) + landm10(norm) + valid."""
        out = []
        for r in rows:
            x, y, bw, bh = r[:4]
            bbox = [x / w, y / h, (x + bw) / w, (y + bh) / h]
            if len(r) >= 19:
                lm = np.asarray(r[4:19]).reshape(5, 3)
                valid = 0.0 if (lm[:, 2] == -1).all() else 1.0
                pts = (lm[:, :2] / (w, h)).reshape(-1).tolist()
            else:
                valid = 0.0
                pts = [0.0] * 10
            out.append(bbox + pts + [valid])
        return np.asarray(out, np.float32).reshape(-1, 15)

    def __getitem__(self, index):
        path, rows = self.samples[index]
        from PIL import Image

        image = np.asarray(Image.open(
            os.path.join(self.image_dir, path)).convert("RGB"))
        h, w = image.shape[:2]
        target = self._to_target(rows, w, h)
        if self.transforms:
            image, target = self.transforms(image, target)
        return image, target

    def __len__(self):
        return len(self.samples)


def split_train_test(samples, test_ratio=0.1, seed=0):
    """A seeded permutation split into (train, test) lists."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(samples))
    n_test = int(len(samples) * test_ratio)
    test = [samples[i] for i in idx[:n_test]]
    train = [samples[i] for i in idx[n_test:]]
    return train, test
