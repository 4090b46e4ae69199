"""MobileNetV1 (counterpart of
``tlxcv_tpu/models/classification/mobilenetv1.py``), also SSD's backbone.

NHWC images at the public call and the JAX model's attribute names
(``blocks.3.dw.conv``).  The depthwise 3x3 convs are ``nn.Conv2d`` with
``groups`` equal to the channels, which cuDNN runs on the card.
"""
from __future__ import annotations

from torch import nn as tnn

from ... import nn
from ...device import resolve_device

__all__ = ["ConvBNReLU", "DepthwiseSeparable", "MobileNetV1", "mobilenet_v1"]


class ConvBNReLU(tnn.Module):
    def __init__(self, cin, cout, k, stride=1, padding=0, groups=1,
                 device=None, generator=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=padding,
                              groups=groups, bias=False, device=device,
                              generator=generator)
        self.bn = nn.BatchNorm(cout, device=device)

    def forward(self, x):
        return nn.relu(self.bn(self.conv(x)))


class DepthwiseSeparable(tnn.Module):
    def __init__(self, cin, cout, stride, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.dw = ConvBNReLU(cin, cin, 3, stride, 1, groups=cin, **kw)
        self.pw = ConvBNReLU(cin, cout, 1, **kw)

    def forward(self, x):
        return self.pw(self.dw(x))


_CFG = [  # (out, stride)
    (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
    (512, 1), (512, 1), (512, 1), (512, 1), (512, 1),
    (1024, 2), (1024, 1),
]


class MobileNetV1(tnn.Module):
    """Logits ``[N, num_classes]``; ``features()`` returns the outputs of
    the blocks listed in ``feature_idx`` (all of them in order), or the
    last block's alone."""

    def __init__(self, num_classes=1000, scale=1.0, with_pool=True,
                 feature_idx=None, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        s = lambda c: max(int(c * scale), 8)  # noqa: E731
        self.stem = ConvBNReLU(3, s(32), 3, 2, 1, **kw)
        blocks = []
        cin = s(32)
        for out, stride in _CFG:
            blocks.append(DepthwiseSeparable(cin, s(out), stride, **kw))
            cin = s(out)
        self.blocks = tnn.ModuleList(blocks)
        self.out_channels = cin
        self.with_pool = with_pool
        self.num_classes = num_classes
        self.feature_idx = feature_idx
        if with_pool:
            self.pool = nn.GlobalAvgPool2d()
        if num_classes > 0:
            self.fc = nn.Linear(cin, num_classes, **kw)

    def features(self, x):
        x = self.stem(x)
        outs = []
        for i, b in enumerate(self.blocks):
            x = b(x)
            if self.feature_idx and i in self.feature_idx:
                outs.append(x)
        return outs if self.feature_idx else [x]

    def forward(self, x):
        x = self.features(x)[-1]
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x)
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV1(scale=scale, **kwargs)
