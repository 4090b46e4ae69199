"""Streaming metrics (counterpart of ``tlxcv_tpu/utils/metrics.py``): the
``Metric`` base for now; the metrics themselves come with the tasks that
use them."""
from __future__ import annotations

__all__ = ["Metric"]


class Metric:
    def update(self, y_pred, y_true):  # pragma: no cover - abstract
        raise NotImplementedError

    def result(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def reset(self):  # pragma: no cover - abstract
        raise NotImplementedError
