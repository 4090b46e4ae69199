"""Res2Net (counterpart of
``tlxcv_tpu/models/classification/res2net.py``), NHWC.

The JAX model's attribute names (``blocks.0.convs.2.bn``).  A bottleneck
splits its 1x1's output into ``scale`` groups of channels; each group but
the last passes a 3x3, after adding the previous group's output (at stride
1), and the last is carried (average-pooled at stride 2).
"""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...device import resolve_device

__all__ = ["Res2Net", "res2net50_26w_4s", "res2net101_26w_4s"]


class ConvBNReLU(tnn.Module):
    def __init__(self, cin, cout, k, stride=1, act=True, device=None,
                 generator=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                              bias=False, device=device, generator=generator)
        self.bn = nn.BatchNorm(cout, device=device)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return nn.relu(x) if self.act else x


class Bottle2neck(tnn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1, downsample=False, base_width=26,
                 scale=4, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        width = int(planes * (base_width / 64.0)) * scale
        self.scale = scale
        self.stride = stride
        self.conv1 = ConvBNReLU(cin, width, 1, **kw)
        n = max(scale - 1, 1)
        self.convs = tnn.ModuleList([
            ConvBNReLU(width // scale, width // scale, 3, stride, **kw)
            for _ in range(n)])
        self.pool = nn.AvgPool2d(3, stride, 1) if stride > 1 else None
        self.conv3 = ConvBNReLU(width, planes * 4, 1, act=False, **kw)
        self.downsample = (ConvBNReLU(cin, planes * 4, 1, stride, act=False,
                                      **kw) if downsample else None)

    def forward(self, x):
        sp = self.conv1(x).chunk(self.scale, -1)
        outs = []
        prev = None
        for i, conv in enumerate(self.convs):
            s = sp[i] if (i == 0 or self.stride > 1) else sp[i] + prev
            prev = conv(s)
            outs.append(prev)
        outs.append(sp[-1] if self.pool is None else self.pool(sp[-1]))
        out = self.conv3(torch.cat(outs, -1))
        identity = x if self.downsample is None else self.downsample(x)
        return nn.relu(out + identity)


class Res2Net(tnn.Module):
    def __init__(self, depth=50, base_width=26, scale=4, num_classes=1000,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        counts = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}[depth]
        self.stem = nn.Sequential(
            nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False, **kw),
            nn.BatchNorm(64, device=device), nn.Activation("relu"),
            nn.MaxPool2d(3, 2, 1))
        blocks = []
        cin = 64
        for si, (n, planes) in enumerate(zip(counts, (64, 128, 256, 512))):
            for bi in range(n):
                stride = 2 if (bi == 0 and si > 0) else 1
                blocks.append(Bottle2neck(
                    cin, planes, stride, downsample=(bi == 0),
                    base_width=base_width, scale=scale, **kw))
                cin = planes * 4
        self.blocks = tnn.ModuleList(blocks)
        self.pool = nn.GlobalAvgPool2d()
        self.fc = nn.Linear(cin, num_classes, **kw)

    def forward(self, x):
        x = self.stem(x)
        for b in self.blocks:
            x = b(x)
        return self.fc(self.pool(x))


def res2net50_26w_4s(pretrained=False, **kw):
    return Res2Net(50, **kw)


def res2net101_26w_4s(pretrained=False, **kw):
    return Res2Net(101, **kw)
