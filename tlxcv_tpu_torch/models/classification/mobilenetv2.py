"""MobileNetV2 (counterpart of
``tlxcv_tpu/models/classification/mobilenetv2.py``), NHWC.

The JAX model's attribute names (``features.layers.4.conv.layers.1``).
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn as tnn

from ... import nn
from ...device import resolve_device
from .utils import make_divisible

__all__ = ["MobileNetV2", "mobilenet_v2"]


class ConvBNReLU6(tnn.Module):
    def __init__(self, cin, cout, k=3, stride=1, groups=1, device=None,
                 generator=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=stride,
                              padding=(k - 1) // 2, groups=groups, bias=False,
                              device=device, generator=generator)
        self.bn = nn.BatchNorm(cout, device=device)

    def forward(self, x):
        return F.relu6(self.bn(self.conv(x)))


class InvertedResidual(tnn.Module):
    def __init__(self, cin, cout, stride, expand_ratio, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        hidden = int(round(cin * expand_ratio))
        self.use_res = stride == 1 and cin == cout
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU6(cin, hidden, 1, **kw))
        layers += [ConvBNReLU6(hidden, hidden, 3, stride, groups=hidden, **kw),
                   nn.Conv2d(hidden, cout, 1, bias=False, **kw),
                   nn.BatchNorm(cout, device=device)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


_CFG = [  # t, c, n, s
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
]


class MobileNetV2(tnn.Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        input_channel = make_divisible(32 * scale, 8)
        last_channel = make_divisible(1280 * max(1.0, scale), 8)
        features = [ConvBNReLU6(3, input_channel, 3, 2, **kw)]
        for t, c, n, s in _CFG:
            out = make_divisible(c * scale, 8)
            for i in range(n):
                features.append(InvertedResidual(
                    input_channel, out, s if i == 0 else 1, t, **kw))
                input_channel = out
        features.append(ConvBNReLU6(input_channel, last_channel, 1, **kw))
        self.features = nn.Sequential(*features)
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.pool = nn.GlobalAvgPool2d()
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2, generator=generator),
                nn.Linear(last_channel, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x)
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV2(scale=scale, **kwargs)
