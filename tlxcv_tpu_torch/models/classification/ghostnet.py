"""GhostNet (counterpart of
``tlxcv_tpu/models/classification/ghostnet.py``), NHWC.

The JAX model's attribute names (``blocks.5.ghost1.cheap.layers.0``).  A
ghost module makes half its channels with a conv and the other half from
those with a cheap depthwise conv.
"""
from __future__ import annotations

import math

import torch
from torch import nn as tnn

from ... import nn
from ...device import resolve_device
from .utils import make_divisible

__all__ = ["GhostNet", "ghostnet"]


def _relu_or_identity(act):
    return nn.Activation("relu") if act else nn.Identity()


class GhostModule(tnn.Module):
    def __init__(self, cin, cout, k=1, ratio=2, dw_size=3, stride=1, act=True,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        init_ch = math.ceil(cout / ratio)
        cheap_ch = init_ch * (ratio - 1)
        self.primary = nn.Sequential(
            nn.Conv2d(cin, init_ch, k, stride=stride, padding=k // 2,
                      bias=False, **kw),
            nn.BatchNorm(init_ch, device=device), _relu_or_identity(act))
        self.cheap = nn.Sequential(
            nn.Conv2d(init_ch, cheap_ch, dw_size, padding=dw_size // 2,
                      groups=init_ch, bias=False, **kw),
            nn.BatchNorm(cheap_ch, device=device), _relu_or_identity(act))
        self.cout = cout

    def forward(self, x):
        x1 = self.primary(x)
        x2 = self.cheap(x1)
        return torch.cat([x1, x2], -1)[..., :self.cout]


class SE(tnn.Module):
    def __init__(self, ch, ratio=4, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        mid = make_divisible(ch / ratio, 4)
        self.fc1 = nn.Conv2d(ch, mid, 1, **kw)
        self.fc2 = nn.Conv2d(mid, ch, 1, **kw)

    def forward(self, x):
        s = nn.relu(self.fc1(x.mean((1, 2), keepdim=True)))
        return x * torch.clamp(self.fc2(s) + 3, 0, 6) / 6


class GhostBottleneck(tnn.Module):
    def __init__(self, cin, mid, cout, k, stride, use_se, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.ghost1 = GhostModule(cin, mid, **kw)
        self.stride = stride
        if stride > 1:
            self.dw = nn.Conv2d(mid, mid, k, stride=stride, padding=k // 2,
                                groups=mid, bias=False, **kw)
            self.dw_bn = nn.BatchNorm(mid, device=device)
        self.se = SE(mid, **kw) if use_se else None
        self.ghost2 = GhostModule(mid, cout, act=False, **kw)
        self.shortcut = None
        if cin != cout or stride != 1:
            self.shortcut = nn.Sequential(
                nn.Conv2d(cin, cin, k, stride=stride, padding=k // 2,
                          groups=cin, bias=False, **kw),
                nn.BatchNorm(cin, device=device),
                nn.Conv2d(cin, cout, 1, bias=False, **kw),
                nn.BatchNorm(cout, device=device))

    def forward(self, x):
        out = self.ghost1(x)
        if self.stride > 1:
            out = self.dw_bn(self.dw(out))
        if self.se is not None:
            out = self.se(out)
        out = self.ghost2(out)
        return out + (x if self.shortcut is None else self.shortcut(x))


_CFG = [  # k, exp, out, se, stride
    (3, 16, 16, 0, 1), (3, 48, 24, 0, 2), (3, 72, 24, 0, 1),
    (5, 72, 40, 1, 2), (5, 120, 40, 1, 1), (3, 240, 80, 0, 2),
    (3, 200, 80, 0, 1), (3, 184, 80, 0, 1), (3, 184, 80, 0, 1),
    (3, 480, 112, 1, 1), (3, 672, 112, 1, 1), (5, 672, 160, 1, 2),
    (5, 960, 160, 0, 1), (5, 960, 160, 1, 1), (5, 960, 160, 0, 1),
    (5, 960, 160, 1, 1),
]


class GhostNet(tnn.Module):
    def __init__(self, scale=1.0, num_classes=1000, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        s = lambda c: make_divisible(c * scale, 4)  # noqa: E731
        self.stem = nn.Sequential(
            nn.Conv2d(3, s(16), 3, stride=2, padding=1, bias=False, **kw),
            nn.BatchNorm(s(16), device=device), nn.Activation("relu"))
        blocks = []
        cin = s(16)
        for k, exp, out, se, stride in _CFG:
            blocks.append(GhostBottleneck(cin, s(exp), s(out), k, stride, se,
                                          **kw))
            cin = s(out)
        self.blocks = tnn.ModuleList(blocks)
        self.head_conv = nn.Sequential(
            nn.Conv2d(cin, s(960), 1, bias=False, **kw),
            nn.BatchNorm(s(960), device=device), nn.Activation("relu"))
        self.pool = nn.GlobalAvgPool2d(keepdims=True)
        self.conv_last = nn.Conv2d(s(960), 1280, 1, **kw)
        self.fc = nn.Linear(1280, num_classes, **kw)

    def forward(self, x):
        x = self.stem(x)
        for b in self.blocks:
            x = b(x)
        x = self.pool(self.head_conv(x))
        x = nn.relu(self.conv_last(x))
        return self.fc(x[:, 0, 0, :])


def ghostnet(pretrained=False, scale=1.0, **kw):
    return GhostNet(scale=scale, **kw)
