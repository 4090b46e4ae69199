"""Loss functions shared across tasks (counterpart of
``tlxcv_tpu/ops/losses.py``): softmax and binary cross-entropy, focal,
varifocal, dice, smooth-L1, L1, MSE, GIoU and wing losses."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .boxes import aligned_iou

__all__ = [
    "softmax_cross_entropy", "cross_entropy", "binary_cross_entropy",
    "sigmoid_focal_loss", "varifocal_loss", "dice_loss", "smooth_l1_loss",
    "l1_loss", "mse_loss", "giou_loss", "wing_loss",
]


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


def binary_cross_entropy(logits, targets, reduction="mean", pos_weight=None):
    """BCE with logits."""
    log_p = F.logsigmoid(logits)
    log_np = F.logsigmoid(-logits)
    w = 1.0 if pos_weight is None else pos_weight
    loss = -(w * targets * log_p + (1.0 - targets) * log_np)
    return _reduce(loss, reduction)


def sigmoid_focal_loss(logits, targets, alpha=0.25, gamma=2.0,
                       reduction="none"):
    """Focal loss."""
    p = torch.sigmoid(logits)
    ce = binary_cross_entropy(logits, targets, reduction="none")
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
        loss = alpha_t * loss
    return _reduce(loss, reduction)


def varifocal_loss(pred_logits, gt_score, label, alpha=0.75, gamma=2.0):
    """Varifocal loss; returns the sum."""
    pred = torch.sigmoid(pred_logits)
    weight = alpha * (pred ** gamma) * (1 - label) + gt_score * label
    ce = binary_cross_entropy(pred_logits, gt_score, reduction="none")
    return (ce * weight).sum()


def dice_loss(logits, targets, smooth=1.0, reduction="mean"):
    """Dice loss over sigmoid probabilities, per sample."""
    p = torch.sigmoid(logits)
    p = p.reshape(p.shape[0], -1)
    t = targets.reshape(targets.shape[0], -1)
    num = 2.0 * (p * t).sum(-1)
    den = p.sum(-1) + t.sum(-1)
    loss = 1.0 - (num + smooth) / (den + smooth)
    return _reduce(loss, reduction)


def smooth_l1_loss(pred, target, beta=1.0, reduction="mean"):
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)
    return _reduce(loss, reduction)


def l1_loss(pred, target, reduction="mean"):
    return _reduce((pred - target).abs(), reduction)


def mse_loss(pred, target, reduction="mean"):
    return _reduce((pred - target) ** 2, reduction)


def wing_loss(pred, target, w=10.0, epsilon=2.0, reduction="mean"):
    """Wing loss (Feng et al., CVPR'18): logarithmic inside |x| < w,
    linear outside, continuous at w."""
    diff = (pred - target).abs()
    c = w - w * math.log(1.0 + w / epsilon)
    loss = torch.where(diff < w, w * torch.log(1.0 + diff / epsilon),
                       diff - c)
    return _reduce(loss, reduction)


def giou_loss(pred_boxes, target_boxes, reduction="mean"):
    loss = 1.0 - aligned_iou(pred_boxes, target_boxes, mode="giou")
    return _reduce(loss, reduction)


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction not in (None, "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    return loss
