"""Streaming metrics (counterpart of ``tlxcv_tpu/utils/metrics.py``): the
``Metric`` base for now; the metrics themselves come with the tasks that
use them."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "as_numpy"]


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
