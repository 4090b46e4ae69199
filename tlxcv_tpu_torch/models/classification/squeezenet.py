"""SqueezeNet 1.0 and 1.1 (counterpart of
``tlxcv_tpu/models/classification/squeezenet.py``), NHWC, its max pools
unpadded."""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...device import resolve_device

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class Fire(tnn.Module):
    def __init__(self, cin, squeeze, e1, e3, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.squeeze = nn.Conv2d(cin, squeeze, 1, **kw)
        self.expand1 = nn.Conv2d(squeeze, e1, 1, **kw)
        self.expand3 = nn.Conv2d(squeeze, e3, 3, padding=1, **kw)

    def forward(self, x):
        x = nn.relu(self.squeeze(x))
        return torch.cat([nn.relu(self.expand1(x)),
                          nn.relu(self.expand3(x))], -1)


class SqueezeNet(tnn.Module):
    def __init__(self, version="1.0", num_classes=1000, dropout=0.5,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        relu, pool = nn.Activation("relu"), lambda: nn.MaxPool2d(3, 2)
        if version == "1.0":
            self.features = nn.Sequential(
                nn.Conv2d(3, 96, 7, stride=2, **kw), relu, pool(),
                Fire(96, 16, 64, 64, **kw), Fire(128, 16, 64, 64, **kw),
                Fire(128, 32, 128, 128, **kw), pool(),
                Fire(256, 32, 128, 128, **kw), Fire(256, 48, 192, 192, **kw),
                Fire(384, 48, 192, 192, **kw), Fire(384, 64, 256, 256, **kw),
                pool(), Fire(512, 64, 256, 256, **kw))
        else:
            self.features = nn.Sequential(
                nn.Conv2d(3, 64, 3, stride=2, **kw), relu, pool(),
                Fire(64, 16, 64, 64, **kw), Fire(128, 16, 64, 64, **kw),
                pool(),
                Fire(128, 32, 128, 128, **kw), Fire(256, 32, 128, 128, **kw),
                pool(),
                Fire(256, 48, 192, 192, **kw), Fire(384, 48, 192, 192, **kw),
                Fire(384, 64, 256, 256, **kw), Fire(512, 64, 256, 256, **kw))
        self.drop = nn.Dropout(dropout, generator=generator)
        self.final_conv = nn.Conv2d(512, num_classes, 1, **kw)
        self.pool = nn.GlobalAvgPool2d()

    def forward(self, x):
        x = self.features(x)
        x = nn.relu(self.final_conv(self.drop(x)))
        return self.pool(x)


def squeezenet1_0(pretrained=False, **kw):
    return SqueezeNet("1.0", **kw)


def squeezenet1_1(pretrained=False, **kw):
    return SqueezeNet("1.1", **kw)
