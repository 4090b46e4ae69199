"""MobileNetV3 small and large (counterpart of
``tlxcv_tpu/models/classification/mobilenetv3.py``), NHWC.

The JAX model's attribute names (``blocks.3.se.fc2``).  The squeeze-and-
excite gate is ``F.hardsigmoid``, ``relu6(x + 3) / 6``, the reference's
``jax.nn.hard_sigmoid``.
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn as tnn

from ... import nn
from ...device import resolve_device
from .utils import make_divisible

__all__ = ["MobileNetV3", "mobilenet_v3_small", "mobilenet_v3_large"]


class SqueezeExcite(tnn.Module):
    def __init__(self, channels, reduction=4, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        mid = make_divisible(channels // reduction, 8)
        self.fc1 = nn.Conv2d(channels, mid, 1, **kw)
        self.fc2 = nn.Conv2d(mid, channels, 1, **kw)

    def forward(self, x):
        s = nn.relu(self.fc1(x.mean((1, 2), keepdim=True)))
        return x * F.hardsigmoid(self.fc2(s))


class Bneck(tnn.Module):
    def __init__(self, cin, exp, cout, k, stride, use_se, act, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.use_res = stride == 1 and cin == cout
        self.expand = exp != cin
        if self.expand:
            self.conv1 = nn.Conv2d(cin, exp, 1, bias=False, **kw)
            self.bn1 = nn.BatchNorm(exp, device=device)
        self.conv2 = nn.Conv2d(exp, exp, k, stride=stride, padding=k // 2,
                               groups=exp, bias=False, **kw)
        self.bn2 = nn.BatchNorm(exp, device=device)
        self.se = SqueezeExcite(exp, **kw) if use_se else None
        self.conv3 = nn.Conv2d(exp, cout, 1, bias=False, **kw)
        self.bn3 = nn.BatchNorm(cout, device=device)
        self.act = nn.get_activation(act)

    def forward(self, x):
        out = x
        if self.expand:
            out = self.act(self.bn1(self.conv1(out)))
        out = self.act(self.bn2(self.conv2(out)))
        if self.se is not None:
            out = self.se(out)
        out = self.bn3(self.conv3(out))
        return x + out if self.use_res else out


_LARGE = [  # k, exp, out, se, act, stride
    (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2), (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1), (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1), (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2), (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1),
]
_SMALL = [
    (3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1), (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1), (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2), (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1),
]


class MobileNetV3(tnn.Module):
    def __init__(self, config="large", scale=1.0, num_classes=1000,
                 with_pool=True, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        cfg = _LARGE if config == "large" else _SMALL
        last_exp = 960 if config == "large" else 576
        s = lambda c: make_divisible(c * scale, 8)  # noqa: E731
        self.stem_conv = nn.Conv2d(3, s(16), 3, stride=2, padding=1,
                                   bias=False, **kw)
        self.stem_bn = nn.BatchNorm(s(16), device=device)
        blocks = []
        cin = s(16)
        for k, exp, out, se, act, stride in cfg:
            blocks.append(Bneck(cin, s(exp), s(out), k, stride, se, act, **kw))
            cin = s(out)
        self.blocks = tnn.ModuleList(blocks)
        self.last_conv = nn.Conv2d(cin, s(last_exp), 1, bias=False, **kw)
        self.last_bn = nn.BatchNorm(s(last_exp), device=device)
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.pool = nn.GlobalAvgPool2d()
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(s(last_exp), 1280, **kw),
                nn.Activation("hardswish"),
                nn.Dropout(0.2, generator=generator),
                nn.Linear(1280, num_classes, **kw))

    def forward(self, x):
        x = F.hardswish(self.stem_bn(self.stem_conv(x)))
        for b in self.blocks:
            x = b(x)
        x = F.hardswish(self.last_bn(self.last_conv(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x)
        return x


def mobilenet_v3_small(pretrained=False, scale=1.0, **kw):
    return MobileNetV3("small", scale, **kw)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kw):
    return MobileNetV3("large", scale, **kw)
