"""Image segmentation task head and metrics (counterpart of
``tlxcv_tpu/tasks/image_segmentation.py``), NHWC logits."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.losses import softmax_cross_entropy
from ..utils.metrics import Metric

__all__ = ["ImageSegmentation", "Accuracy", "mean_iou", "dice_coefficient"]


class ImageSegmentation(nn.Module):
    def __init__(self, backbone: nn.Module):
        super().__init__()
        self.backbone = backbone

    def loss_fn(self, output, target):
        """Cross-entropy over NHWC logits; ``target`` is one-hot NHWC or
        integer NHW."""
        if target.ndim == output.ndim:
            target = target.argmax(-1)
        return softmax_cross_entropy(output, target)

    def forward(self, inputs):
        return self.backbone(inputs)

    def predict(self, inputs):
        return self.backbone(inputs)


def _numpy(t):
    return t.detach().float().cpu().numpy() if torch.is_tensor(t) \
        else np.asarray(t)


class Accuracy(Metric):
    """Pixel accuracy of the argmax over the class axis."""

    def __init__(self):
        self.correct = 0
        self.total = 0

    def update(self, y_pred, y_true):
        y_pred = _numpy(y_pred)
        p = y_pred.argmax(-1).reshape(-1)
        t = _numpy(y_true)
        if t.ndim == y_pred.ndim:
            t = t.argmax(-1)
        t = t.reshape(-1)
        self.correct += int((p == t).sum())
        self.total += t.size

    def result(self):
        return self.correct / max(self.total, 1)

    def reset(self):
        self.correct = 0
        self.total = 0


def mean_iou(y_true, y_pred):
    """Soft IoU over one-hot NHWC maps, per image and class, averaged; in
    float64."""
    y_true = torch.as_tensor(y_true, dtype=torch.float64)
    y_pred = torch.as_tensor(y_pred, dtype=torch.float64)
    inter = (y_pred * y_true).sum((1, 2))
    union = (y_pred + y_true).sum((1, 2)) - inter
    return (inter / union).mean()


def dice_coefficient(y_true, y_pred, smooth=1):
    """(2·|A∩B| + smooth) / (|A| + |B| + smooth) per image over NHWC
    maps, averaged over the batch."""
    y_true = torch.as_tensor(y_true)
    y_pred = torch.as_tensor(y_pred)
    inter = (y_true * y_pred).sum((1, 2, 3))
    union = y_true.sum((1, 2, 3)) + y_pred.sum((1, 2, 3))
    return ((2.0 * inter + smooth) / (union + smooth)).mean(0)
