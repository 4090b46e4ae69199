"""Distillation-aware classification (counterpart of
``tlxcv_tpu/tasks/distillation.py``), the DeiT and LeViT recipe.

- The teacher stays out of the student's graph: ``teacher_labels`` runs
  it in eval mode under ``torch.no_grad()`` on its own device, batch by
  batch, and hands its logits on as targets; the optimizer never sees
  the teacher's parameters.
- The student's training forward returns ``(class_logits, dist_logits)``
  (LeViT with ``distillation=True``) or their average (DeiT), which the
  loss supervises with both terms: hard distillation
  ``CE(y, label) / 2 + CE(y_dist, argmax teacher) / 2``, or soft
  ``(1 - alpha) CE + alpha tau^2 KL(teacher / tau || student / tau)``.
"""
from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..ops.losses import softmax_cross_entropy

__all__ = ["DistilledClassification", "teacher_labels"]


class DistilledClassification(nn.Module):
    """Task head for a distillation-head student.  Targets are dicts
    ``{"label": int labels, "teacher": teacher logits}`` (make them with
    ``teacher_labels``); plain labels take cross-entropy alone.
    ``hard=True`` is DeiT's default."""

    def __init__(self, backbone: nn.Module, hard: bool = True,
                 alpha: float = 0.5, tau: float = 1.0):
        super().__init__()
        self.backbone = backbone
        self.hard = hard
        self.alpha = alpha
        self.tau = tau

    def forward(self, inputs):
        return self.backbone(inputs)

    def loss_fn(self, output, target):
        if not (isinstance(target, dict) and "teacher" in target):
            out = output[0] if isinstance(output, tuple) else output
            return softmax_cross_entropy(out, target)
        label, teacher = target["label"], target["teacher"]
        if isinstance(output, tuple):
            y, y_dist = output
        else:  # an averaged head: both terms supervise it
            y = y_dist = output
        ce = softmax_cross_entropy(y, label)
        if self.hard:
            return 0.5 * ce + 0.5 * softmax_cross_entropy(
                y_dist, teacher.argmax(-1))
        t = self.tau
        log_p = F.log_softmax(y_dist / t, dim=-1)
        q = F.softmax(teacher / t, dim=-1)
        kl = (q * (torch.log(q.clamp(1e-6, 1.0)) - log_p)).sum(-1)
        return (1 - self.alpha) * ce + self.alpha * (t * t) * kl.mean()

    def predict(self, inputs):
        out = self.backbone(inputs)
        if isinstance(out, tuple):  # training-mode dual heads
            out = (out[0] + out[1]) / 2
        return out.argmax(-1)


def teacher_labels(teacher: nn.Module, batches: tp.Iterable, params=None,
                   state=None):
    """Wrap ``(x, label)`` batches into ``(x, {"label", "teacher"})`` by
    the teacher's eval-mode forward under ``torch.no_grad()``, on the
    device of its parameters (``params`` and ``state``, name -> tensor,
    replace its own for the call).  The logits are detached: they never
    enter the student's graph."""
    override = {**(params or {}), **(state or {})}
    device = next(iter(override.values()) if override
                  else teacher.parameters()).device

    def gen():
        for x, label in batches:
            teacher.eval()
            xt = torch.as_tensor(x).to(device)
            with torch.no_grad():
                logits = (functional_call(teacher, override, (xt,))
                          if override else teacher(xt))
            if isinstance(logits, tuple):
                logits = (logits[0] + logits[1]) / 2
            yield x, {"label": label, "teacher": logits}

    return gen()
