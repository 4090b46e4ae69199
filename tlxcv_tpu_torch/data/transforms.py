"""Image transforms (counterpart of ``tlxcv_tpu/data/transforms.py``).

Two tiers, as in the reference:

- host transforms (the classes): per-sample numpy ops in the DataLoader,
  NHWC float32 out.  ``Resize`` uses cv2 where it is installed and the
  reference's own numpy nearest route where it is not;
- :func:`batch_preprocess`: the batched device path on torch tensors
  (resize, normalize, a random horizontal flip drawn from an explicit
  ``torch.Generator``).

``FusedResizeNormalize`` is the resize and the normalize in one threaded
C++ pass over a uint8 batch (``tlxcv_tpu_torch.native``).
"""
from __future__ import annotations

import numpy as np
import torch

try:
    import cv2
except Exception:  # cv2 is optional: Resize falls back to numpy
    cv2 = None

__all__ = ["Compose", "Resize", "Normalize", "ToTensor",
           "RandomFlipHorizontal", "RandomCrop", "batch_preprocess",
           "FusedResizeNormalize"]


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


def _pair(size):
    return tuple(size) if isinstance(size, (tuple, list)) else (size, size)


class Resize:
    """To ``size`` (h, w): cv2's bilinear or nearest resize where cv2 is
    installed; else nearest by ``floor(i * in / out)`` in numpy."""

    def __init__(self, size, interpolation="bilinear"):
        self.size = _pair(size)
        self.interpolation = interpolation

    def __call__(self, img):
        h, w = self.size
        if cv2 is not None:
            interp = (cv2.INTER_LINEAR if self.interpolation == "bilinear"
                      else cv2.INTER_NEAREST)
            out = cv2.resize(np.asarray(img), (w, h), interpolation=interp)
            return out[..., None] if out.ndim == 2 else out
        img = np.asarray(img)
        ys = (np.arange(h) * img.shape[0] / h).astype(int)
        xs = (np.arange(w) * img.shape[1] / w).astype(int)
        return img[ys][:, xs]


class Normalize:
    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, img):
        return (np.asarray(img, np.float32) - self.mean) / self.std


class ToTensor:
    """float32; the layout stays HWC unless ``data_format="CHW"``."""

    def __init__(self, data_format="HWC"):
        if data_format not in ("HWC", "CHW"):
            raise ValueError(data_format)
        self.data_format = data_format

    def __call__(self, img):
        img = np.asarray(img, np.float32)
        return np.transpose(img, (2, 0, 1)) if self.data_format == "CHW" \
            else img


class RandomFlipHorizontal:
    """Flips with probability ``prob``, drawn from its own numpy
    generator seeded with ``seed`` (the reference's draws)."""

    def __init__(self, prob=0.5, seed=0):
        self.prob = prob
        self._rng = np.random.default_rng(seed)

    def __call__(self, img):
        if self._rng.random() < self.prob:
            return np.ascontiguousarray(img[:, ::-1])
        return img


class RandomCrop:
    """A ``size`` crop at an offset drawn from its own numpy generator,
    after an optional reflect padding of ``pad``."""

    def __init__(self, size, pad=0, seed=0):
        self.size = _pair(size)
        self.pad = pad
        self._rng = np.random.default_rng(seed)

    def __call__(self, img):
        if self.pad:
            img = np.pad(img, ((self.pad, self.pad), (self.pad, self.pad),
                               (0, 0)), mode="reflect")
        h, w = img.shape[:2]
        th, tw = self.size
        i = int(self._rng.integers(0, h - th + 1))
        j = int(self._rng.integers(0, w - tw + 1))
        return img[i:i + th, j:j + tw]


def batch_preprocess(images, mean, std, generator=None, size=None,
                     training=False):
    """uint8 or float NHWC batch (a tensor, on its device) -> normalized
    float32, resized bilinearly to ``size`` if given, and with
    ``training`` and a ``generator`` each image flipped horizontally with
    probability 0.5 (the draws are the generator's, not the reference's
    ``jax.random`` bits)."""
    from ..ops.image import interpolate

    x = images.float()
    if size is not None and tuple(size) != tuple(x.shape[1:3]):
        x = interpolate(x, size=tuple(size), mode="bilinear")
    mean = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    x = (x - mean) / std
    if training and generator is not None:
        flip = torch.rand((x.shape[0], 1, 1, 1), generator=generator,
                          device=generator.device) < 0.5
        x = torch.where(flip.to(x.device), x.flip(2), x)
    return x


class FusedResizeNormalize:
    """Resize (cv2's bilinear, half-pixel centres) and normalize of uint8
    HWC images in one threaded C++ pass (``native.resize_normalize_batch``,
    its numpy fallback without the library): one image [H, W, C] or a
    batch [B, H, W, C] in, float32 NHWC out."""

    def __init__(self, size, mean, std, threads=0):
        self.size = (tuple(size) if isinstance(size, (tuple, list))
                     else (size, size))
        self.mean = mean
        self.std = std
        self.threads = threads

    def __call__(self, img):
        from .. import native

        img = np.asarray(img)
        batched = img.ndim == 4
        out = native.resize_normalize_batch(
            img if batched else img[None], self.size, self.mean, self.std,
            self.threads)
        return out if batched else out[0]
