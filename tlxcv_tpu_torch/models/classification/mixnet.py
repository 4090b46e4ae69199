"""MixNet-S and -M, mixed depthwise kernels (counterpart of
``tlxcv_tpu/models/classification/mixnet.py``), NHWC.

A mixed depthwise conv splits its channels into one group per kernel
size, the first group taking the remainder (``split_channels``).  As in
the JAX package, ``mixnet_m`` widens the stem to 24 channels while its
first block still expects 16, so its forward fails at that block's
depthwise conv, at any input size.
"""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...device import resolve_device
from .utils import make_divisible

__all__ = ["MixNet", "mixnet_s", "mixnet_m", "split_channels"]


def split_channels(channels, groups):
    """``groups`` equal shares of ``channels``, the first one taking what
    the division leaves over."""
    splits = [channels // groups] * groups
    splits[0] += channels - sum(splits)
    return splits


class MixedDWConv(tnn.Module):
    """Depthwise conv with a mix of kernel sizes across channel groups."""

    def __init__(self, channels, kernel_sizes, stride=1, device=None,
                 generator=None):
        super().__init__()
        self.splits = split_channels(channels, len(kernel_sizes))
        self.convs = tnn.ModuleList([
            nn.Conv2d(c, c, k, stride=stride, padding=k // 2, groups=c,
                      bias=False, device=device, generator=generator)
            for c, k in zip(self.splits, kernel_sizes)])

    def forward(self, x):
        parts = x.split(self.splits, -1) if len(self.splits) > 1 else (x,)
        return torch.cat([conv(p) for conv, p in zip(self.convs, parts)], -1)


class SE(tnn.Module):
    def __init__(self, ch, reduction=4, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        mid = max(1, ch // reduction)
        self.fc1 = nn.Conv2d(ch, mid, 1, **kw)
        self.fc2 = nn.Conv2d(mid, ch, 1, **kw)

    def forward(self, x):
        s = x.mean((1, 2), keepdim=True)
        return x * torch.sigmoid(self.fc2(nn.relu(self.fc1(s))))


class MixBlock(tnn.Module):
    def __init__(self, cin, cout, kernels, expand, stride, se_ratio, act,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        mid = cin * expand
        self.use_res = stride == 1 and cin == cout
        self.expand = expand != 1
        if self.expand:
            self.pw1 = nn.Conv2d(cin, mid, 1, bias=False, **kw)
            self.bn1 = nn.BatchNorm(mid, device=device)
        self.dw = MixedDWConv(mid, kernels, stride, **kw)
        self.bn2 = nn.BatchNorm(mid, device=device)
        self.se = SE(mid, int(1 / se_ratio), **kw) if se_ratio else None
        self.pw2 = nn.Conv2d(mid, cout, 1, bias=False, **kw)
        self.bn3 = nn.BatchNorm(cout, device=device)
        self.act = nn.get_activation(act)

    def forward(self, x):
        out = x
        if self.expand:
            out = self.act(self.bn1(self.pw1(out)))
        out = self.act(self.bn2(self.dw(out)))
        if self.se is not None:
            out = self.se(out)
        out = self.bn3(self.pw2(out))
        return x + out if self.use_res else out


# cin, cout, kernels, expand, stride, se_ratio, act  (MixNet-S)
_S_CFG = [
    (16, 16, (3,), 1, 1, 0, "relu"),
    (16, 24, (3,), 6, 2, 0, "relu"),
    (24, 24, (3,), 3, 1, 0, "relu"),
    (24, 40, (3, 5, 7), 6, 2, 0.5, "swish"),
    (40, 40, (3, 5), 6, 1, 0.5, "swish"),
    (40, 40, (3, 5), 6, 1, 0.5, "swish"),
    (40, 40, (3, 5), 6, 1, 0.5, "swish"),
    (40, 80, (3, 5, 7), 6, 2, 0.25, "swish"),
    (80, 80, (3, 5), 6, 1, 0.25, "swish"),
    (80, 80, (3, 5), 6, 1, 0.25, "swish"),
    (80, 120, (3, 5, 7), 6, 1, 0.5, "swish"),
    (120, 120, (3, 5, 7, 9), 3, 1, 0.5, "swish"),
    (120, 120, (3, 5, 7, 9), 3, 1, 0.5, "swish"),
    (120, 200, (3, 5, 7, 9, 11), 6, 2, 0.5, "swish"),
    (200, 200, (3, 5, 7, 9), 6, 1, 0.5, "swish"),
    (200, 200, (3, 5, 7, 9), 6, 1, 0.5, "swish"),
]


class MixNet(tnn.Module):
    def __init__(self, cfg=_S_CFG, stem=16, num_classes=1000, width=1.0,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        s = lambda c: make_divisible(c * width, 8)  # noqa: E731
        self.stem = nn.Sequential(
            nn.Conv2d(3, s(stem), 3, stride=2, padding=1, bias=False, **kw),
            nn.BatchNorm(s(stem), device=device), nn.Activation("relu"))
        self.blocks = tnn.ModuleList([
            MixBlock(s(ci), s(co), ks, e, st, se, act, **kw)
            for ci, co, ks, e, st, se, act in cfg])
        last = s(cfg[-1][1])
        self.head = nn.Sequential(
            nn.Conv2d(last, 1536, 1, bias=False, **kw),
            nn.BatchNorm(1536, device=device), nn.Activation("relu"))
        self.pool = nn.GlobalAvgPool2d()
        self.fc = nn.Linear(1536, num_classes, **kw)

    def forward(self, x):
        x = self.stem(x)
        for b in self.blocks:
            x = b(x)
        return self.fc(self.pool(self.head(x)))


def mixnet_s(pretrained=False, **kw):
    return MixNet(**kw)


def mixnet_m(pretrained=False, **kw):
    return MixNet(width=1.0, stem=24, **kw)
