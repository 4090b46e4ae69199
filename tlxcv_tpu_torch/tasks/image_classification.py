"""Image classification task head (counterpart of
``tlxcv_tpu/tasks/image_classification.py``)."""
from __future__ import annotations

from torch import nn

from ..ops.losses import softmax_cross_entropy


class ImageClassification(nn.Module):
    def __init__(self, backbone: nn.Module):
        super().__init__()
        self.backbone = backbone

    def loss_fn(self, output, target):
        return softmax_cross_entropy(output, target)

    def forward(self, inputs):
        return self.backbone(inputs)

    def predict(self, inputs):
        return self.backbone(inputs).argmax(-1)
