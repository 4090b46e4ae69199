"""Video classification task (counterpart of
``tlxcv_tpu/tasks/video_classification.py``): BCE with logits over
per-frame multi-label targets, per-frame argmax ``predict``."""
from __future__ import annotations

from torch import nn

from ..ops.losses import binary_cross_entropy

__all__ = ["VideoClassification"]


class VideoClassification(nn.Module):
    def __init__(self, backbone: nn.Module):
        super().__init__()
        self.backbone = backbone

    def loss_fn(self, output, target):
        return binary_cross_entropy(output, target.to(output.dtype))

    def forward(self, inputs):
        return self.backbone(inputs)

    def predict(self, inputs):
        return self.backbone(inputs).argmax(-1)
