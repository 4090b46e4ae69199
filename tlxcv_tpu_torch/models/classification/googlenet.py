"""GoogLeNet / Inception-v1 (counterpart of
``tlxcv_tpu/models/classification/googlenet.py``), NHWC.  The 3x3/1 max
pool of each Inception's pool branch is padded with -inf
(``nn.MaxPool2d``)."""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...device import resolve_device

__all__ = ["GoogLeNet", "googlenet"]


class BasicConv(tnn.Module):
    def __init__(self, cin, cout, k, stride=1, padding=0, device=None,
                 generator=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=padding,
                              bias=False, device=device, generator=generator)
        self.bn = nn.BatchNorm(cout, eps=0.001, device=device)

    def forward(self, x):
        return nn.relu(self.bn(self.conv(x)))


class Inception(tnn.Module):
    def __init__(self, cin, c1, c3r, c3, c5r, c5, pp, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.b1 = BasicConv(cin, c1, 1, **kw)
        self.b2 = nn.Sequential(BasicConv(cin, c3r, 1, **kw),
                                BasicConv(c3r, c3, 3, padding=1, **kw))
        self.b3 = nn.Sequential(BasicConv(cin, c5r, 1, **kw),
                                BasicConv(c5r, c5, 3, padding=1, **kw))
        self.b4_pool = nn.MaxPool2d(3, 1, 1)
        self.b4 = BasicConv(cin, pp, 1, **kw)

    def forward(self, x):
        return torch.cat([self.b1(x), self.b2(x), self.b3(x),
                          self.b4(self.b4_pool(x))], -1)


class GoogLeNet(tnn.Module):
    def __init__(self, num_classes=1000, dropout=0.2, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.stem = nn.Sequential(
            BasicConv(3, 64, 7, 2, 3, **kw), nn.MaxPool2d(3, 2, padding=1),
            BasicConv(64, 64, 1, **kw),
            BasicConv(64, 192, 3, padding=1, **kw),
            nn.MaxPool2d(3, 2, padding=1))
        self.i3a = Inception(192, 64, 96, 128, 16, 32, 32, **kw)
        self.i3b = Inception(256, 128, 128, 192, 32, 96, 64, **kw)
        self.pool3 = nn.MaxPool2d(3, 2, padding=1)
        self.i4a = Inception(480, 192, 96, 208, 16, 48, 64, **kw)
        self.i4b = Inception(512, 160, 112, 224, 24, 64, 64, **kw)
        self.i4c = Inception(512, 128, 128, 256, 24, 64, 64, **kw)
        self.i4d = Inception(512, 112, 144, 288, 32, 64, 64, **kw)
        self.i4e = Inception(528, 256, 160, 320, 32, 128, 128, **kw)
        self.pool4 = nn.MaxPool2d(2, 2)
        self.i5a = Inception(832, 256, 160, 320, 32, 128, 128, **kw)
        self.i5b = Inception(832, 384, 192, 384, 48, 128, 128, **kw)
        self.pool = nn.GlobalAvgPool2d()
        self.drop = nn.Dropout(dropout, generator=generator)
        self.fc = nn.Linear(1024, num_classes, **kw)

    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.i3b(self.i3a(x)))
        x = self.i4e(self.i4d(self.i4c(self.i4b(self.i4a(x)))))
        x = self.pool4(x)
        x = self.i5b(self.i5a(x))
        return self.fc(self.drop(self.pool(x)))


def googlenet(pretrained=False, **kw):
    return GoogLeNet(**kw)
