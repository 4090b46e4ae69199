"""RegNetX and RegNetY (counterpart of
``tlxcv_tpu/models/classification/regnet.py``), NHWC.

The JAX model's attribute names (``blocks.5.b.layers.0``).  The stage
widths come from ``_generate_widths`` in float64 numpy, the reference's
arithmetic, so that every integer width is the reference's.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn as tnn

from ... import nn
from ...device import resolve_device

__all__ = ["RegNet", "regnetx_4gf", "regnety_4gf"]


def _generate_widths(w_a, w_0, w_m, depth, q=8):
    """The quantized linear widths of each block, grouped into stages:
    (widths, blocks per stage)."""
    ws_cont = np.arange(depth) * w_a + w_0
    ks = np.round(np.log(ws_cont / w_0) / np.log(w_m))
    ws = w_0 * np.power(w_m, ks)
    ws = np.round(np.divide(ws, q)) * q
    widths, counts = np.unique(ws.astype(int), return_counts=True)
    return widths.tolist(), counts.tolist()


class SE(tnn.Module):
    def __init__(self, ch, se_ch, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.fc1 = nn.Conv2d(ch, se_ch, 1, **kw)
        self.fc2 = nn.Conv2d(se_ch, ch, 1, **kw)

    def forward(self, x):
        s = x.mean((1, 2), keepdim=True)
        return x * torch.sigmoid(self.fc2(nn.relu(self.fc1(s))))


def _conv_bn(cin, cout, k=1, stride=1, groups=1, relu=True, kw=None):
    layers = [nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                        groups=groups, bias=False, **kw),
              nn.BatchNorm(cout, device=kw["device"])]
    return nn.Sequential(*layers, *([nn.Activation("relu")] if relu else []))


class Bottleneck(tnn.Module):
    def __init__(self, cin, cout, stride, group_width, se_ratio=0.0,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.a = _conv_bn(cin, cout, kw=kw)
        self.b = _conv_bn(cout, cout, 3, stride, groups=cout // group_width,
                          kw=kw)
        self.se = SE(cout, int(cin * se_ratio), **kw) if se_ratio > 0 else None
        self.c = _conv_bn(cout, cout, relu=False, kw=kw)
        self.proj = None
        if cin != cout or stride != 1:
            self.proj = _conv_bn(cin, cout, stride=stride, relu=False, kw=kw)

    def forward(self, x):
        out = self.b(self.a(x))
        if self.se is not None:
            out = self.se(out)
        out = self.c(out)
        sc = x if self.proj is None else self.proj(x)
        return nn.relu(out + sc)


class RegNet(tnn.Module):
    def __init__(self, w_a, w_0, w_m, depth, group_width, se_ratio=0.0,
                 num_classes=1000, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        widths, counts = _generate_widths(w_a, w_0, w_m, depth)
        self.stem = _conv_bn(3, 32, 3, 2, kw=kw)
        blocks = []
        cin = 32
        for w, n in zip(widths, counts):
            gw = min(group_width, w)
            w = int(round(w / gw) * gw)
            for i in range(n):
                blocks.append(Bottleneck(cin, w, 2 if i == 0 else 1, gw,
                                         se_ratio, **kw))
                cin = w
        self.blocks = tnn.ModuleList(blocks)
        self.pool = nn.GlobalAvgPool2d()
        self.fc = nn.Linear(cin, num_classes, **kw)

    def forward(self, x):
        x = self.stem(x)
        for b in self.blocks:
            x = b(x)
        return self.fc(self.pool(x))


def regnetx_4gf(pretrained=False, **kw):
    return RegNet(w_a=38.65, w_0=96, w_m=2.43, depth=23, group_width=40, **kw)


def regnety_4gf(pretrained=False, **kw):
    return RegNet(w_a=31.41, w_0=96, w_m=2.24, depth=22, group_width=64,
                  se_ratio=0.25, **kw)
