"""Losses of the classification slice (counterpart of the first part of
``tlxcv_tpu/ops/losses.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["softmax_cross_entropy", "cross_entropy"]


def softmax_cross_entropy(logits, labels, label_smoothing=0.0, axis=-1,
                          reduction="mean"):
    """CE over logits; integer or one-hot labels.  ``axis`` selects the
    class axis of BOTH logits and (one-hot) labels."""
    if axis not in (-1, logits.ndim - 1):
        logits = torch.movedim(logits, axis, -1)
        if labels.ndim == logits.ndim:      # one-hot with the same layout
            labels = torch.movedim(labels, axis, -1)
    nc = logits.shape[-1]
    if labels.ndim == logits.ndim - 1 or labels.dtype in (torch.int32,
                                                          torch.int64):
        labels = F.one_hot(labels.long(), nc).to(logits.dtype)
    if label_smoothing:
        labels = labels * (1.0 - label_smoothing) + label_smoothing / nc
    loss = -(labels * F.log_softmax(logits, dim=-1)).sum(-1)
    return _reduce(loss, reduction)


cross_entropy = softmax_cross_entropy


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction not in (None, "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    return loss
