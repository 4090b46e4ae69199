"""Streaming metrics with the update/result/reset protocol (counterpart of
``tlxcv_tpu/utils/metrics.py``).  Each update takes what ``as_numpy``
takes: tensors on any device (copied to the host, floating ones in f32)
or numpy arrays; the counting is the reference's, in numpy."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "TopKAccuracy", "EmptyMetric", "MeanIoU",
           "as_numpy"]


def as_numpy(x):
    """A metric's input on the host: a tensor detached, in f32 for a
    floating one, or anything ``np.asarray`` takes."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).cpu().numpy()
    return np.asarray(x)


class Metric:
    def update(self, y_pred, y_true):  # pragma: no cover - abstract
        raise NotImplementedError

    def result(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def reset(self):  # pragma: no cover - abstract
        raise NotImplementedError


class Accuracy(Metric):
    def __init__(self):
        self.correct = 0
        self.total = 0

    def update(self, y_pred, y_true):
        y_pred = as_numpy(y_pred)
        y_true = as_numpy(y_true)
        if y_pred.ndim > y_true.ndim:
            y_pred = y_pred.argmax(-1)
        self.correct += int((y_pred == y_true).sum())
        self.total += int(y_true.size)

    def result(self):
        return self.correct / max(self.total, 1)

    def reset(self):
        self.correct = 0
        self.total = 0


class TopKAccuracy(Metric):
    def __init__(self, k=5):
        self.k = k
        self.correct = 0
        self.total = 0

    def update(self, logits, y_true):
        logits = as_numpy(logits)
        y_true = as_numpy(y_true).reshape(-1)
        topk = np.argsort(-logits, axis=-1)[:, :self.k]
        self.correct += int((topk == y_true[:, None]).any(-1).sum())
        self.total += len(y_true)

    def result(self):
        return self.correct / max(self.total, 1)

    def reset(self):
        self.correct = 0
        self.total = 0


class MeanIoU(Metric):
    """Streaming mIoU over argmax predictions."""

    def __init__(self, num_classes):
        self.num_classes = num_classes
        self.reset()

    def update(self, y_pred, y_true):
        pred = as_numpy(y_pred)
        true = as_numpy(y_true)
        # logits or one-hot [..., C], or integer labels [...]: a trailing
        # class axis is told by the ranks, or, where they are equal, by a
        # class-sized last axis of a float label (both are distributions)
        both_dist = (pred.ndim == true.ndim
                     and pred.shape[-1] == self.num_classes
                     and not np.issubdtype(true.dtype, np.integer))
        if pred.ndim > true.ndim or both_dist:
            pred = pred.argmax(-1)
        if true.ndim > pred.ndim or both_dist:
            true = true.argmax(-1)
        k = self.num_classes
        idx = k * true.reshape(-1).astype(np.int64) + pred.reshape(-1)
        self.conf += np.bincount(idx, minlength=k * k).reshape(k, k)

    def result(self):
        inter = np.diag(self.conf)
        union = self.conf.sum(0) + self.conf.sum(1) - inter
        valid = union > 0
        return (float((inter[valid] / union[valid]).mean()) if valid.any()
                else 0.0)

    def reset(self):
        self.conf = np.zeros((self.num_classes, self.num_classes), np.int64)


class EmptyMetric(Metric):
    def update(self, *a, **k):
        pass

    def result(self):
        return 0.0

    def reset(self):
        pass
