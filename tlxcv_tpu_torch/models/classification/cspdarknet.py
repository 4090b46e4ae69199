"""CSPDarkNet-53 on Mish, and the DarkNet-53 classifier over the
detection trunk (counterpart of
``tlxcv_tpu/models/classification/cspdarknet.py``), NHWC."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn as tnn

from ... import nn
from ...device import resolve_device

__all__ = ["CSPDarkNet", "cspdarknet53", "DarkNet53", "darknet53_cls"]


class ConvBNMish(tnn.Module):
    def __init__(self, cin, cout, k, stride=1, device=None, generator=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                              bias=False, device=device, generator=generator)
        self.bn = nn.BatchNorm(cout, device=device)

    def forward(self, x):
        return F.mish(self.bn(self.conv(x)))


class ResBlock(tnn.Module):
    def __init__(self, ch, hidden=None, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        hidden = hidden or ch
        self.conv1 = ConvBNMish(ch, hidden, 1, **kw)
        self.conv2 = ConvBNMish(hidden, ch, 3, **kw)

    def forward(self, x):
        return x + self.conv2(self.conv1(x))


class CSPStage(tnn.Module):
    def __init__(self, cin, cout, n, first=False, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.down = ConvBNMish(cin, cout, 3, stride=2, **kw)
        split = cout if first else cout // 2
        self.split1 = ConvBNMish(cout, split, 1, **kw)
        self.split2 = ConvBNMish(cout, split, 1, **kw)
        self.blocks = tnn.ModuleList([
            ResBlock(split, cout // 2 if first else None, **kw)
            for _ in range(n)])
        self.post = ConvBNMish(split, split, 1, **kw)
        self.fuse = ConvBNMish(split * 2, cout, 1, **kw)

    def forward(self, x):
        x = self.down(x)
        y1 = self.split1(x)
        y2 = self.split2(x)
        for b in self.blocks:
            y2 = b(y2)
        return self.fuse(torch.cat([y1, self.post(y2)], -1))


class CSPDarkNet(tnn.Module):
    def __init__(self, num_classes=1000, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.stem = ConvBNMish(3, 32, 3, **kw)
        stages = []
        cin = 32
        for i, (n, c) in enumerate(zip((1, 2, 8, 8, 4),
                                       (64, 128, 256, 512, 1024))):
            stages.append(CSPStage(cin, c, n, first=(i == 0), **kw))
            cin = c
        self.stages = tnn.ModuleList(stages)
        self.pool = nn.GlobalAvgPool2d()
        self.fc = nn.Linear(1024, num_classes, **kw)

    def forward(self, x):
        x = self.stem(x)
        for s in self.stages:
            x = s(x)
        return self.fc(self.pool(x))


def cspdarknet53(pretrained=False, **kw):
    return CSPDarkNet(**kw)


class DarkNet53(tnn.Module):
    """Classifier over the detection DarkNet-53 trunk (its C5)."""

    def __init__(self, num_classes=1000, device=None, generator=None):
        super().__init__()
        from ..detection.backbones.darknet import DarkNet

        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.trunk = DarkNet(return_idx=(4,), **kw)
        self.pool = nn.GlobalAvgPool2d()
        self.fc = nn.Linear(1024, num_classes, **kw)

    def forward(self, x):
        return self.fc(self.pool(self.trunk(x)[-1]))


def darknet53_cls(pretrained=False, **kw):
    return DarkNet53(**kw)
