"""ESNet and PP-LCNetV2 (counterpart of
``tlxcv_tpu/models/classification/esnet.py``), NHWC: hardswish convs,
hardsigmoid squeeze-excites, and ShuffleNetV2's channel shuffle."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn as tnn

from ... import nn
from ...device import resolve_device
from .shufflenetv2 import channel_shuffle
from .utils import make_divisible

__all__ = ["ESNet", "esnet_x0_5", "esnet_x1_0", "PPLCNetV2", "pp_lcnet_v2"]


class ConvBNAct(tnn.Module):
    def __init__(self, cin, cout, k, stride=1, groups=1, act="hardswish",
                 device=None, generator=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                              groups=groups, bias=False, device=device,
                              generator=generator)
        self.bn = nn.BatchNorm(cout, device=device)
        self.act = nn.get_activation(act) if act else None

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act else x


class SE(tnn.Module):
    def __init__(self, ch, ratio=4, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.fc1 = nn.Conv2d(ch, ch // ratio, 1, **kw)
        self.fc2 = nn.Conv2d(ch // ratio, ch, 1, **kw)

    def forward(self, x):
        s = x.mean((1, 2), keepdim=True)
        return x * F.hardsigmoid(self.fc2(nn.relu(self.fc1(s))))


class ESBlock1(tnn.Module):
    """Stride-1 block: split, pw + dw + SE + pw on one half, shuffle."""

    def __init__(self, ch, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        half = ch // 2
        self.pw1 = ConvBNAct(half, half, 1, **kw)
        self.dw = ConvBNAct(half, half, 3, groups=half, act=None, **kw)
        self.se = SE(half, **kw)
        self.pw2 = ConvBNAct(half, half, 1, **kw)

    def forward(self, x):
        x1, x2 = x.chunk(2, -1)
        y = self.pw2(self.se(self.dw(self.pw1(x2))))
        return channel_shuffle(torch.cat([x1, y], -1))


class ESBlock2(tnn.Module):
    """Stride-2 block: two downsampling branches, fused by a depthwise and
    a pointwise conv, shuffled."""

    def __init__(self, cin, cout, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        half = cout // 2
        self.b1_dw = ConvBNAct(cin, cin, 3, stride=2, groups=cin, act=None,
                               **kw)
        self.b1_pw = ConvBNAct(cin, half, 1, **kw)
        self.b2_pw1 = ConvBNAct(cin, half, 1, **kw)
        self.b2_dw = ConvBNAct(half, half, 3, stride=2, groups=half,
                               act=None, **kw)
        self.b2_se = SE(half, **kw)
        self.b2_pw2 = ConvBNAct(half, half, 1, **kw)
        self.dp = ConvBNAct(cout, cout, 3, groups=cout, act=None, **kw)
        self.pw = ConvBNAct(cout, cout, 1, **kw)

    def forward(self, x):
        y1 = self.b1_pw(self.b1_dw(x))
        y2 = self.b2_pw2(self.b2_se(self.b2_dw(self.b2_pw1(x))))
        return channel_shuffle(self.pw(self.dp(torch.cat([y1, y2], -1))))


class ESNet(tnn.Module):
    def __init__(self, scale=1.0, num_classes=1000,
                 stage_repeats=(3, 7, 3), stage_out=(116, 232, 464),
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        s = lambda c: make_divisible(c * scale, 8)  # noqa: E731
        self.stem = ConvBNAct(3, s(24), 3, 2, **kw)
        self.pool = nn.MaxPool2d(3, 2, 1)
        blocks = []
        cin = s(24)
        for n, c in zip(stage_repeats, stage_out):
            blocks.append(ESBlock2(cin, s(c), **kw))
            blocks += [ESBlock1(s(c), **kw) for _ in range(n)]
            cin = s(c)
        self.blocks = tnn.ModuleList(blocks)
        self.head = ConvBNAct(cin, 1024, 1, **kw)
        self.gap = nn.GlobalAvgPool2d()
        self.fc = nn.Linear(1024, num_classes, **kw)

    def forward(self, x):
        x = self.pool(self.stem(x))
        for b in self.blocks:
            x = b(x)
        return self.fc(self.gap(self.head(x)))


def esnet_x1_0(pretrained=False, **kw):
    return ESNet(1.0, **kw)


def esnet_x0_5(pretrained=False, **kw):
    return ESNet(0.5, **kw)


class LCV2Block(tnn.Module):
    def __init__(self, cin, cout, stride, dw_size=3, use_se=False,
                 shortcut=True, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.dw1 = ConvBNAct(cin, cin, dw_size, stride=stride, groups=cin,
                             act=None, **kw)
        self.se = SE(cin, **kw) if use_se else None
        self.pw1 = ConvBNAct(cin, cout, 1, **kw)
        self.shortcut = shortcut and stride == 1 and cin == cout

    def forward(self, x):
        y = self.dw1(x)
        if self.se is not None:
            y = self.se(y)
        y = self.pw1(y)
        return x + y if self.shortcut else y


class PPLCNetV2(tnn.Module):
    def __init__(self, scale=1.0, num_classes=1000, dropout=0.2, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        s = lambda c: make_divisible(c * scale, 8)  # noqa: E731
        self.stem = nn.Sequential(ConvBNAct(3, s(32), 3, 2, **kw),
                                  LCV2Block(s(32), s(64), 1, **kw))
        cfg = [(128, 2), (256, 2), (512, 4), (1024, 2)]  # cout, blocks
        blocks = []
        cin = s(64)
        for ci, (cout, n) in enumerate(cfg):
            for bi in range(n):
                blocks.append(LCV2Block(cin, s(cout), 2 if bi == 0 else 1,
                                        dw_size=5 if ci >= 2 else 3,
                                        use_se=(ci == 3 and bi > 0), **kw))
                cin = s(cout)
        self.blocks = tnn.ModuleList(blocks)
        self.gap = nn.GlobalAvgPool2d(keepdims=True)
        self.last = nn.Conv2d(cin, 1280, 1, **kw)
        self.drop = nn.Dropout(dropout, generator=generator)
        self.fc = nn.Linear(1280, num_classes, **kw)

    def forward(self, x):
        x = self.stem(x)
        for b in self.blocks:
            x = b(x)
        x = F.hardswish(self.last(self.gap(x)))
        return self.fc(self.drop(x[:, 0, 0, :]))


def pp_lcnet_v2(pretrained=False, scale=1.0, **kw):
    return PPLCNetV2(scale, **kw)
