"""Object detection task head (counterpart of
``tlxcv_tpu/tasks/object_detection.py``): the model's own outputs, its own
loss."""
from __future__ import annotations

from torch import nn


class ObjectDetection(nn.Module):
    def __init__(self, backbone: nn.Module):
        super().__init__()
        self.backbone = backbone

    def loss_fn(self, output, target):
        return self.backbone.loss_fn(output, target)

    def forward(self, inputs, **kwargs):
        return self.backbone(inputs, **kwargs)

    def predict(self, inputs, **kwargs):
        return self.backbone(inputs, **kwargs)
