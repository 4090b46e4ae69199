"""EfficientNet B0 to B7 (counterpart of
``tlxcv_tpu/models/classification/efficientnet.py``), NHWC.

The JAX model's attribute names (``blocks.6.se.fc1``): MBConv blocks with
squeeze-and-excite and drop path, BatchNorm at eps 1e-3.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn as tnn

from ... import nn
from ...device import resolve_device
from .utils import make_divisible

__all__ = ["EfficientNet"] + [f"efficientnet_b{i}" for i in range(8)]

# (expand, channels, repeats, stride, kernel)
_BASE_CFG = [
    (1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5), (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5), (6, 192, 4, 2, 5), (6, 320, 1, 1, 3),
]
# width_mult, depth_mult, resolution, dropout
_SCALES = {
    0: (1.0, 1.0, 224, 0.2), 1: (1.0, 1.1, 240, 0.2), 2: (1.1, 1.2, 260, 0.3),
    3: (1.2, 1.4, 300, 0.3), 4: (1.4, 1.8, 380, 0.4), 5: (1.6, 2.2, 456, 0.4),
    6: (1.8, 2.6, 528, 0.5), 7: (2.0, 3.1, 600, 0.5),
}


def _bn(c, device):
    return nn.BatchNorm(c, momentum=0.99, eps=1e-3, device=device)


class ConvBNSiLU(tnn.Module):
    def __init__(self, cin, cout, k=3, stride=1, groups=1, device=None,
                 generator=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                              groups=groups, bias=False, device=device,
                              generator=generator)
        self.bn = _bn(cout, device)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class SE(tnn.Module):
    def __init__(self, channels, se_channels, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.fc1 = nn.Conv2d(channels, se_channels, 1, **kw)
        self.fc2 = nn.Conv2d(se_channels, channels, 1, **kw)

    def forward(self, x):
        s = F.silu(self.fc1(x.mean((1, 2), keepdim=True)))
        return x * torch.sigmoid(self.fc2(s))


class MBConv(tnn.Module):
    def __init__(self, cin, cout, expand, stride, k, drop_path=0.0,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        mid = cin * expand
        self.use_res = stride == 1 and cin == cout
        self.expand = expand != 1
        if self.expand:
            self.expand_conv = ConvBNSiLU(cin, mid, 1, **kw)
        self.dw = ConvBNSiLU(mid, mid, k, stride, groups=mid, **kw)
        self.se = SE(mid, max(1, cin // 4), **kw)
        self.project = nn.Conv2d(mid, cout, 1, bias=False, **kw)
        self.project_bn = _bn(cout, device)
        self.drop_path = nn.DropPath(drop_path, generator=generator)

    def forward(self, x):
        out = self.expand_conv(x) if self.expand else x
        out = self.project_bn(self.project(self.se(self.dw(out))))
        if self.use_res:
            out = x + self.drop_path(out)
        return out


class EfficientNet(tnn.Module):
    def __init__(self, width_mult=1.0, depth_mult=1.0, dropout=0.2,
                 num_classes=1000, drop_path_rate=0.2, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        rnd = lambda c: make_divisible(c * width_mult, 8)  # noqa: E731
        reps = lambda r: int(math.ceil(r * depth_mult))  # noqa: E731
        self.stem = ConvBNSiLU(3, rnd(32), 3, 2, **kw)
        blocks = []
        cin = rnd(32)
        total = sum(reps(r) for _, _, r, _, _ in _BASE_CFG)
        bi = 0
        for expand, c, r, s, k in _BASE_CFG:
            cout = rnd(c)
            for i in range(reps(r)):
                blocks.append(MBConv(cin, cout, expand, s if i == 0 else 1, k,
                                     drop_path_rate * bi / total, **kw))
                cin = cout
                bi += 1
        self.blocks = tnn.ModuleList(blocks)
        head_ch = rnd(1280)
        self.head_conv = ConvBNSiLU(cin, head_ch, 1, **kw)
        self.pool = nn.GlobalAvgPool2d()
        self.dropout = nn.Dropout(dropout, generator=generator)
        self.fc = nn.Linear(head_ch, num_classes, **kw)

    def forward(self, x):
        x = self.stem(x)
        for b in self.blocks:
            x = b(x)
        x = self.pool(self.head_conv(x))
        return self.fc(self.dropout(x))


def _eff(i, **kw):
    w, d, _, p = _SCALES[i]
    kw.setdefault("dropout", p)
    return EfficientNet(width_mult=w, depth_mult=d, **kw)


def efficientnet_b0(pretrained=False, **kw):
    return _eff(0, **kw)


def efficientnet_b1(pretrained=False, **kw):
    return _eff(1, **kw)


def efficientnet_b2(pretrained=False, **kw):
    return _eff(2, **kw)


def efficientnet_b3(pretrained=False, **kw):
    return _eff(3, **kw)


def efficientnet_b4(pretrained=False, **kw):
    return _eff(4, **kw)


def efficientnet_b5(pretrained=False, **kw):
    return _eff(5, **kw)


def efficientnet_b6(pretrained=False, **kw):
    return _eff(6, **kw)


def efficientnet_b7(pretrained=False, **kw):
    return _eff(7, **kw)
