"""SE-ResNeXt and ResNeSt (counterpart of
``tlxcv_tpu/models/classification/se_resnext.py``), NHWC.

The JAX models' attribute names (``blocks.4.conv2.layers.0``,
``blocks.2.splat.fc2``).  SE-ResNeXt's 3x3 convs are grouped 32 ways:
float on cuDNN, and after ``ops.quant.quantize_weights`` and calibration
one int8 GEMM launch per group (``nn.layers.Conv2d._grouped_int8``).
ResNeSt's split attention takes a softmax over its radix splits, the
channels read as ``(radix, ch)``.
"""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...device import resolve_device

__all__ = ["SEResNeXt", "se_resnext50_32x4d", "ResNeSt", "resnest50"]


def _conv_bn(cin, cout, k=1, stride=1, padding=0, groups=1, relu=True,
             kw=None):
    """The layers of a bias-less conv, its BatchNorm and (``relu``) a
    ReLU."""
    return [nn.Conv2d(cin, cout, k, stride=stride, padding=padding,
                      groups=groups, bias=False, **kw),
            nn.BatchNorm(cout, device=kw["device"]),
            *([nn.Activation("relu")] if relu else [])]


class SEBlock(tnn.Module):
    def __init__(self, ch, reduction=16, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.fc1 = nn.Linear(ch, ch // reduction, **kw)
        self.fc2 = nn.Linear(ch // reduction, ch, **kw)

    def forward(self, x):
        s = x.mean((1, 2))
        s = torch.sigmoid(self.fc2(nn.relu(self.fc1(s))))
        return x * s[:, None, None, :]


class SEResNeXtBlock(tnn.Module):
    def __init__(self, cin, planes, stride=1, cardinality=32, width=4,
                 downsample=False, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        d = planes * width * cardinality // 64
        self.conv1 = nn.Sequential(*_conv_bn(cin, d, kw=kw))
        self.conv2 = nn.Sequential(*_conv_bn(d, d, 3, stride, 1,
                                             groups=cardinality, kw=kw))
        self.conv3 = nn.Sequential(*_conv_bn(d, planes * 4, relu=False,
                                             kw=kw))
        self.se = SEBlock(planes * 4, **kw)
        self.downsample = (nn.Sequential(*_conv_bn(
            cin, planes * 4, stride=stride, relu=False, kw=kw))
            if downsample else None)

    def forward(self, x):
        out = self.se(self.conv3(self.conv2(self.conv1(x))))
        identity = x if self.downsample is None else self.downsample(x)
        return nn.relu(out + identity)


_COUNTS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class SEResNeXt(tnn.Module):
    def __init__(self, depth=50, cardinality=32, width=4, num_classes=1000,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.stem = nn.Sequential(*_conv_bn(3, 64, 7, 2, 3, kw=kw),
                                  nn.MaxPool2d(3, 2, 1))
        blocks = []
        cin = 64
        for si, (n, planes) in enumerate(zip(_COUNTS[depth],
                                             (64, 128, 256, 512))):
            for bi in range(n):
                stride = 2 if (bi == 0 and si > 0) else 1
                blocks.append(SEResNeXtBlock(cin, planes, stride, cardinality,
                                             width, downsample=(bi == 0),
                                             **kw))
                cin = planes * 4
        self.blocks = tnn.ModuleList(blocks)
        self.pool = nn.GlobalAvgPool2d()
        self.fc = nn.Linear(cin, num_classes, **kw)

    def forward(self, x):
        x = self.stem(x)
        for b in self.blocks:
            x = b(x)
        return self.fc(self.pool(x))


def se_resnext50_32x4d(pretrained=False, **kw):
    return SEResNeXt(50, **kw)


def radix_softmax(att, radix, ch):
    """The split attention's weights: ``att`` [B, 1, 1, radix * ch] read as
    (radix, ch), a softmax over the radix."""
    return torch.softmax(att.reshape(att.shape[0], 1, 1, radix, ch), dim=3)


class SplitAttention(tnn.Module):
    """ResNeSt's split-attention conv (radix 2)."""

    def __init__(self, cin, ch, radix=2, groups=1, reduction=4, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.radix = radix
        self.conv = nn.Sequential(*_conv_bn(cin, ch * radix, 3, 1, 1,
                                            groups=groups * radix, kw=kw))
        inter = max(ch * radix // reduction, 32)
        self.fc1 = nn.Conv2d(ch, inter, 1, groups=groups, **kw)
        self.bn1 = nn.BatchNorm(inter, device=device)
        self.fc2 = nn.Conv2d(inter, ch * radix, 1, groups=groups, **kw)
        self.ch = ch

    def forward(self, x):
        x = self.conv(x)
        b, h, w, _ = x.shape
        splits = x.reshape(b, h, w, self.radix, self.ch)
        gap = splits.sum(3).mean((1, 2), keepdim=True)
        att = self.fc2(nn.relu(self.bn1(self.fc1(gap))))
        return (splits * radix_softmax(att, self.radix, self.ch)).sum(3)


class ResNeStBlock(tnn.Module):
    def __init__(self, cin, planes, stride=1, downsample=False, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv1 = nn.Sequential(*_conv_bn(cin, planes, kw=kw))
        self.splat = SplitAttention(planes, planes, **kw)
        self.avg = nn.AvgPool2d(3, stride, 1) if stride > 1 else None
        self.conv3 = nn.Sequential(*_conv_bn(planes, planes * 4, relu=False,
                                             kw=kw))
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.AvgPool2d(stride, stride) if stride > 1 else nn.Identity(),
                *_conv_bn(cin, planes * 4, relu=False, kw=kw))

    def forward(self, x):
        out = self.splat(self.conv1(x))
        if self.avg is not None:
            out = self.avg(out)
        out = self.conv3(out)
        identity = x if self.downsample is None else self.downsample(x)
        return nn.relu(out + identity)


class ResNeSt(tnn.Module):
    def __init__(self, depth=50, num_classes=1000, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.stem = nn.Sequential(
            *_conv_bn(3, 32, 3, 2, 1, kw=kw),
            *_conv_bn(32, 32, 3, 1, 1, kw=kw),
            *_conv_bn(32, 64, 3, 1, 1, kw=kw), nn.MaxPool2d(3, 2, 1))
        blocks = []
        cin = 64
        for si, (n, planes) in enumerate(zip(_COUNTS[depth],
                                             (64, 128, 256, 512))):
            for bi in range(n):
                stride = 2 if (bi == 0 and si > 0) else 1
                blocks.append(ResNeStBlock(cin, planes, stride,
                                           downsample=(bi == 0), **kw))
                cin = planes * 4
        self.blocks = tnn.ModuleList(blocks)
        self.pool = nn.GlobalAvgPool2d()
        self.fc = nn.Linear(cin, num_classes, **kw)

    def forward(self, x):
        x = self.stem(x)
        for b in self.blocks:
            x = b(x)
        return self.fc(self.pool(x))


def resnest50(pretrained=False, **kw):
    return ResNeSt(50, **kw)
