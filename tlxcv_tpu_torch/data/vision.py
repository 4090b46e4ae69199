"""Dataset bases (counterpart of ``tlxcv_tpu/data/vision.py``)."""
from __future__ import annotations

import typing as tp


class Dataset:
    def __getitem__(self, index):  # pragma: no cover - abstract
        raise NotImplementedError

    def __len__(self):  # pragma: no cover - abstract
        raise NotImplementedError


class StandardTransform:
    def __init__(self, transform=None, target_transform=None):
        self.transform = transform
        self.target_transform = target_transform

    def __call__(self, inp, target):
        if self.transform is not None:
            inp = self.transform(inp)
        if self.target_transform is not None:
            target = self.target_transform(target)
        return inp, target


class VisionDataset(Dataset):
    """Base with mutually-exclusive ``transforms`` vs
    ``transform``/``target_transform``."""

    def __init__(self, root=None, transforms=None, transform=None,
                 target_transform=None):
        self.root = root
        has_transforms = transforms is not None
        has_separate = transform is not None or target_transform is not None
        if has_transforms and has_separate:
            raise ValueError(
                "Only transforms or transform/target_transform can be passed "
                "as argument")
        if not has_transforms:
            transforms = StandardTransform(transform, target_transform)
        self.transform = transform
        self.target_transform = target_transform
        self.transforms = transforms
