"""DenseNet-121/161/169/201/264 (counterpart of
``tlxcv_tpu/models/classification/densenet.py``), NHWC.  Each dense layer
concatenates its 3x3 conv's growth onto its input along channels."""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...device import resolve_device

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264"]

_CFGS = {
    121: (6, 12, 24, 16), 161: (6, 12, 36, 24), 169: (6, 12, 32, 32),
    201: (6, 12, 48, 32), 264: (6, 12, 64, 48),
}


class DenseLayer(tnn.Module):
    def __init__(self, cin, growth_rate, bn_size, dropout, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        mid = bn_size * growth_rate
        self.bn1 = nn.BatchNorm(cin, device=device)
        self.conv1 = nn.Conv2d(cin, mid, 1, bias=False, **kw)
        self.bn2 = nn.BatchNorm(mid, device=device)
        self.conv2 = nn.Conv2d(mid, growth_rate, 3, padding=1, bias=False,
                               **kw)
        self.dropout = nn.Dropout(dropout, generator=generator)

    def forward(self, x):
        out = self.conv1(nn.relu(self.bn1(x)))
        out = self.conv2(nn.relu(self.bn2(out)))
        return torch.cat([x, self.dropout(out)], -1)


class Transition(tnn.Module):
    def __init__(self, cin, cout, device=None, generator=None):
        super().__init__()
        self.bn = nn.BatchNorm(cin, device=device)
        self.conv = nn.Conv2d(cin, cout, 1, bias=False, device=device,
                              generator=generator)
        self.pool = nn.AvgPool2d(2, 2)

    def forward(self, x):
        return self.pool(self.conv(nn.relu(self.bn(x))))


class DenseNet(tnn.Module):
    def __init__(self, layers=121, growth_rate=32, bn_size=4, dropout=0.0,
                 num_classes=1000, num_init_features=64, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        cfg = _CFGS[layers]
        if layers == 161:
            growth_rate, num_init_features = 48, 96
        self.stem = nn.Sequential(
            nn.Conv2d(3, num_init_features, 7, stride=2, padding=3,
                      bias=False, **kw),
            nn.BatchNorm(num_init_features, device=device),
            nn.Activation("relu"), nn.MaxPool2d(3, 2, 1))
        blocks = []
        ch = num_init_features
        for i, n in enumerate(cfg):
            for _ in range(n):
                blocks.append(DenseLayer(ch, growth_rate, bn_size, dropout,
                                         **kw))
                ch += growth_rate
            if i != len(cfg) - 1:
                blocks.append(Transition(ch, ch // 2, **kw))
                ch = ch // 2
        self.blocks = tnn.ModuleList(blocks)
        self.final_bn = nn.BatchNorm(ch, device=device)
        self.pool = nn.GlobalAvgPool2d()
        self.fc = nn.Linear(ch, num_classes, **kw)

    def forward(self, x):
        x = self.stem(x)
        for b in self.blocks:
            x = b(x)
        return self.fc(self.pool(nn.relu(self.final_bn(x))))


def densenet121(pretrained=False, **kw):
    return DenseNet(121, **kw)


def densenet161(pretrained=False, **kw):
    return DenseNet(161, **kw)


def densenet169(pretrained=False, **kw):
    return DenseNet(169, **kw)


def densenet201(pretrained=False, **kw):
    return DenseNet(201, **kw)


def densenet264(pretrained=False, **kw):
    return DenseNet(264, **kw)
