"""AlexNet (counterpart of ``tlxcv_tpu/models/classification/alexnet.py``),
NHWC.  The adaptive pool's 6x6 map is flattened in H, W, C order, as the
JAX model flattens its NHWC tensor; below 224 px it averages
overlapping bins (``nn.AdaptiveAvgPool2d``'s non-divisible route)."""
from __future__ import annotations

from torch import nn as tnn

from ... import nn
from ...device import resolve_device

__all__ = ["AlexNet", "alexnet"]


class AlexNet(tnn.Module):
    def __init__(self, num_classes=1000, dropout=0.5, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        relu = lambda: nn.Activation("relu")  # noqa: E731
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, stride=4, padding=2, **kw), relu(),
            nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, padding=2, **kw), relu(),
            nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, padding=1, **kw), relu(),
            nn.Conv2d(384, 256, 3, padding=1, **kw), relu(),
            nn.Conv2d(256, 256, 3, padding=1, **kw), relu(),
            nn.MaxPool2d(3, 2),
        )
        self.avgpool = nn.AdaptiveAvgPool2d((6, 6))
        self.classifier = nn.Sequential(
            nn.Dropout(dropout, generator=generator),
            nn.Linear(256 * 6 * 6, 4096, **kw), relu(),
            nn.Dropout(dropout, generator=generator),
            nn.Linear(4096, 4096, **kw), relu(),
            nn.Linear(4096, num_classes, **kw),
        )

    def forward(self, x):
        x = self.avgpool(self.features(x))
        return self.classifier(x.reshape(x.shape[0], -1))


def alexnet(pretrained=False, **kwargs):
    return AlexNet(**kwargs)
