"""Inception-v3 (counterpart of
``tlxcv_tpu/models/classification/inceptionv3.py``), NHWC, at 299 px.
The 3x3/1 average pools leave the padding out of their count
(``nn.AvgPool2d``, torch's ``count_include_pad=False``)."""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...device import resolve_device

__all__ = ["InceptionV3", "inception_v3"]


class BasicConv(tnn.Module):
    def __init__(self, cin, cout, k, stride=1, padding=0, device=None,
                 generator=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=padding,
                              bias=False, device=device, generator=generator)
        self.bn = nn.BatchNorm(cout, eps=0.001, device=device)

    def forward(self, x):
        return nn.relu(self.bn(self.conv(x)))


class InceptionA(tnn.Module):
    def __init__(self, cin, pool_features, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.b1x1 = BasicConv(cin, 64, 1, **kw)
        self.b5x5_1 = BasicConv(cin, 48, 1, **kw)
        self.b5x5_2 = BasicConv(48, 64, 5, padding=2, **kw)
        self.b3x3_1 = BasicConv(cin, 64, 1, **kw)
        self.b3x3_2 = BasicConv(64, 96, 3, padding=1, **kw)
        self.b3x3_3 = BasicConv(96, 96, 3, padding=1, **kw)
        self.pool = nn.AvgPool2d(3, 1, 1)
        self.bpool = BasicConv(cin, pool_features, 1, **kw)

    def forward(self, x):
        return torch.cat([
            self.b1x1(x), self.b5x5_2(self.b5x5_1(x)),
            self.b3x3_3(self.b3x3_2(self.b3x3_1(x))),
            self.bpool(self.pool(x))], -1)


class InceptionB(tnn.Module):
    def __init__(self, cin, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.b3x3 = BasicConv(cin, 384, 3, stride=2, **kw)
        self.b3x3d_1 = BasicConv(cin, 64, 1, **kw)
        self.b3x3d_2 = BasicConv(64, 96, 3, padding=1, **kw)
        self.b3x3d_3 = BasicConv(96, 96, 3, stride=2, **kw)
        self.pool = nn.MaxPool2d(3, 2)

    def forward(self, x):
        return torch.cat([
            self.b3x3(x), self.b3x3d_3(self.b3x3d_2(self.b3x3d_1(x))),
            self.pool(x)], -1)


class InceptionC(tnn.Module):
    def __init__(self, cin, c7, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.b1x1 = BasicConv(cin, 192, 1, **kw)
        self.b7_1 = BasicConv(cin, c7, 1, **kw)
        self.b7_2 = BasicConv(c7, c7, (1, 7), padding=(0, 3), **kw)
        self.b7_3 = BasicConv(c7, 192, (7, 1), padding=(3, 0), **kw)
        self.b7d_1 = BasicConv(cin, c7, 1, **kw)
        self.b7d_2 = BasicConv(c7, c7, (7, 1), padding=(3, 0), **kw)
        self.b7d_3 = BasicConv(c7, c7, (1, 7), padding=(0, 3), **kw)
        self.b7d_4 = BasicConv(c7, c7, (7, 1), padding=(3, 0), **kw)
        self.b7d_5 = BasicConv(c7, 192, (1, 7), padding=(0, 3), **kw)
        self.pool = nn.AvgPool2d(3, 1, 1)
        self.bpool = BasicConv(cin, 192, 1, **kw)

    def forward(self, x):
        return torch.cat([
            self.b1x1(x), self.b7_3(self.b7_2(self.b7_1(x))),
            self.b7d_5(self.b7d_4(self.b7d_3(self.b7d_2(self.b7d_1(x))))),
            self.bpool(self.pool(x))], -1)


class InceptionD(tnn.Module):
    def __init__(self, cin, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.b3_1 = BasicConv(cin, 192, 1, **kw)
        self.b3_2 = BasicConv(192, 320, 3, stride=2, **kw)
        self.b7_1 = BasicConv(cin, 192, 1, **kw)
        self.b7_2 = BasicConv(192, 192, (1, 7), padding=(0, 3), **kw)
        self.b7_3 = BasicConv(192, 192, (7, 1), padding=(3, 0), **kw)
        self.b7_4 = BasicConv(192, 192, 3, stride=2, **kw)
        self.pool = nn.MaxPool2d(3, 2)

    def forward(self, x):
        return torch.cat([
            self.b3_2(self.b3_1(x)),
            self.b7_4(self.b7_3(self.b7_2(self.b7_1(x)))), self.pool(x)], -1)


class InceptionE(tnn.Module):
    def __init__(self, cin, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.b1x1 = BasicConv(cin, 320, 1, **kw)
        self.b3_1 = BasicConv(cin, 384, 1, **kw)
        self.b3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1), **kw)
        self.b3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0), **kw)
        self.b3d_1 = BasicConv(cin, 448, 1, **kw)
        self.b3d_2 = BasicConv(448, 384, 3, padding=1, **kw)
        self.b3d_3a = BasicConv(384, 384, (1, 3), padding=(0, 1), **kw)
        self.b3d_3b = BasicConv(384, 384, (3, 1), padding=(1, 0), **kw)
        self.pool = nn.AvgPool2d(3, 1, 1)
        self.bpool = BasicConv(cin, 192, 1, **kw)

    def forward(self, x):
        b3 = self.b3_1(x)
        b3 = torch.cat([self.b3_2a(b3), self.b3_2b(b3)], -1)
        b3d = self.b3d_2(self.b3d_1(x))
        b3d = torch.cat([self.b3d_3a(b3d), self.b3d_3b(b3d)], -1)
        return torch.cat([self.b1x1(x), b3, b3d, self.bpool(self.pool(x))],
                         -1)


class InceptionV3(tnn.Module):
    def __init__(self, num_classes=1000, dropout=0.5, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.stem = nn.Sequential(
            BasicConv(3, 32, 3, stride=2, **kw), BasicConv(32, 32, 3, **kw),
            BasicConv(32, 64, 3, padding=1, **kw), nn.MaxPool2d(3, 2),
            BasicConv(64, 80, 1, **kw), BasicConv(80, 192, 3, **kw),
            nn.MaxPool2d(3, 2))
        self.blocks = tnn.ModuleList([
            InceptionA(192, 32, **kw), InceptionA(256, 64, **kw),
            InceptionA(288, 64, **kw),
            InceptionB(288, **kw),
            InceptionC(768, 128, **kw), InceptionC(768, 160, **kw),
            InceptionC(768, 160, **kw), InceptionC(768, 192, **kw),
            InceptionD(768, **kw),
            InceptionE(1280, **kw), InceptionE(2048, **kw),
        ])
        self.pool = nn.GlobalAvgPool2d()
        self.drop = nn.Dropout(dropout, generator=generator)
        self.fc = nn.Linear(2048, num_classes, **kw)

    def forward(self, x):
        x = self.stem(x)
        for b in self.blocks:
            x = b(x)
        return self.fc(self.drop(self.pool(x)))


def inception_v3(pretrained=False, **kw):
    return InceptionV3(**kw)
