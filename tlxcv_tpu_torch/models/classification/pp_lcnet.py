"""PP-LCNet (counterpart of ``tlxcv_tpu/models/classification/pp_lcnet.py``),
NHWC: a stride-2 stem, then 13 depthwise-separable blocks (3x3 or 5x5
depthwise, hardswish, a squeeze-excite in the last two, 1x1 pointwise,
hardswish), each width times ``scale`` rounded by ``make_divisible``; the
head pools, a 1x1 conv to 1280 with hardswish, dropout, the classifier.
PicoDet's backbone taps its blocks at strides 8, 16 and 32."""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn as tnn

from ... import nn
from ...device import resolve_device
from .utils import make_divisible

__all__ = ["PPLCNet", "pp_lcnet"]

# k, cin, cout, stride, use_se (before ``scale``)
_CFG = [
    (3, 16, 32, 1, 0),
    (3, 32, 64, 2, 0), (3, 64, 64, 1, 0),
    (3, 64, 128, 2, 0), (3, 128, 128, 1, 0),
    (3, 128, 256, 2, 0), (5, 256, 256, 1, 0), (5, 256, 256, 1, 0),
    (5, 256, 256, 1, 0), (5, 256, 256, 1, 0), (5, 256, 256, 1, 0),
    (5, 256, 512, 2, 1), (5, 512, 512, 1, 1),
]


class SE(tnn.Module):
    def __init__(self, ch, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.fc1 = nn.Conv2d(ch, ch // 4, 1, **kw)
        self.fc2 = nn.Conv2d(ch // 4, ch, 1, **kw)

    def forward(self, x):
        s = x.mean(dim=(1, 2), keepdim=True)
        return x * F.hardsigmoid(self.fc2(nn.relu(self.fc1(s))))


class DWBlock(tnn.Module):
    def __init__(self, cin, cout, k, stride, use_se, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.dw = nn.Conv2d(cin, cin, k, stride=stride, padding=k // 2,
                            groups=cin, bias=False, **kw)
        self.dw_bn = nn.BatchNorm(cin, device=device)
        self.se = SE(cin, **kw) if use_se else None
        self.pw = nn.Conv2d(cin, cout, 1, bias=False, **kw)
        self.pw_bn = nn.BatchNorm(cout, device=device)

    def forward(self, x):
        x = F.hardswish(self.dw_bn(self.dw(x)))
        if self.se is not None:
            x = self.se(x)
        return F.hardswish(self.pw_bn(self.pw(x)))


class PPLCNet(tnn.Module):
    def __init__(self, scale=1.0, num_classes=1000, dropout=0.2, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)

        def s(c):
            return make_divisible(c * scale, 8)

        self.stem = nn.Sequential(
            nn.Conv2d(3, s(16), 3, stride=2, padding=1, bias=False, **kw),
            nn.BatchNorm(s(16), device=device), nn.Activation("hardswish"))
        self.blocks = tnn.ModuleList([
            DWBlock(s(cin), s(cout), k, st, se, **kw)
            for k, cin, cout, st, se in _CFG])
        self.pool = nn.GlobalAvgPool2d(keepdims=True)
        self.last_conv = nn.Conv2d(s(512), 1280, 1, **kw)
        self.drop = nn.Dropout(dropout)
        self.fc = nn.Linear(1280, num_classes, **kw)

    def forward(self, x):
        x = self.stem(x)
        for b in self.blocks:
            x = b(x)
        x = F.hardswish(self.last_conv(self.pool(x)))
        return self.fc(self.drop(x[:, 0, 0, :]))


def pp_lcnet(pretrained=False, scale=1.0, **kw):
    return PPLCNet(scale=scale, **kw)
