"""ResNet-vD backbone (counterpart of
``tlxcv_tpu/models/backbones/resnet_vd.py``): the deep stem of three 3x3
convs, shortcuts that average-pool before their 1x1 conv, and the
``output_stride`` dilations DeepLab uses, NHWC."""
from __future__ import annotations

from torch import nn as tnn

from ... import nn
from ...device import resolve_device

__all__ = ["ResNetVD", "resnet18_vd", "resnet34_vd", "resnet50_vd",
           "resnet101_vd", "resnet152_vd"]


class ConvBNReLU(tnn.Module):
    """Conv, BatchNorm and an optional ReLU; ``avg_first`` puts a 2x2
    average pool before a stride-1 conv (the vD shortcut)."""

    def __init__(self, cin, cout, k, stride=1, dilation=1, act=True,
                 avg_first=False, device=None, generator=None):
        super().__init__()
        self.avg = nn.AvgPool2d(2, 2, 0) if avg_first else None
        self.conv = nn.Conv2d(cin, cout, k, stride=1 if avg_first else stride,
                              padding=(k - 1) // 2 * dilation,
                              dilation=dilation, bias=False, device=device,
                              generator=generator)
        self.bn = nn.BatchNorm(cout, device=device)
        self.act = act

    def forward(self, x):
        if self.avg is not None:
            x = self.avg(x)
        x = self.bn(self.conv(x))
        return nn.relu(x) if self.act else x


class BottleneckVD(tnn.Module):
    def __init__(self, cin, planes, stride=1, shortcut=True, if_first=False,
                 dilation=1, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv0 = ConvBNReLU(cin, planes, 1, **kw)
        self.conv1 = ConvBNReLU(planes, planes, 3, stride=stride,
                                dilation=dilation, **kw)
        self.conv2 = ConvBNReLU(planes, planes * 4, 1, act=False, **kw)
        self.shortcut = shortcut
        if not shortcut:
            self.short = ConvBNReLU(cin, planes * 4, 1, act=False,
                                    avg_first=not if_first and stride != 1,
                                    **kw)

    def forward(self, x):
        out = self.conv2(self.conv1(self.conv0(x)))
        identity = x if self.shortcut else self.short(x)
        return nn.relu(out + identity)


class BasicBlockVD(tnn.Module):
    def __init__(self, cin, planes, stride=1, shortcut=True, if_first=False,
                 dilation=1, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv0 = ConvBNReLU(cin, planes, 3, stride=stride,
                                dilation=dilation, **kw)
        self.conv1 = ConvBNReLU(planes, planes, 3, act=False, **kw)
        self.shortcut = shortcut
        if not shortcut:
            self.short = ConvBNReLU(cin, planes, 1, act=False,
                                    avg_first=not if_first and stride != 1,
                                    **kw)

    def forward(self, x):
        out = self.conv1(self.conv0(x))
        identity = x if self.shortcut else self.short(x)
        return nn.relu(out + identity)


_DEPTHS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
           101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class ResNetVD(tnn.Module):
    """Returns the four stages' outputs (C2..C5).  ``output_stride`` 8 or
    16 dilates the last stages instead of striding them; the first block
    of a dilated stage uses half its dilation."""

    def __init__(self, layers=50, output_stride=8, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        depths = _DEPTHS[layers]
        bottleneck = layers >= 50
        block = BottleneckVD if bottleneck else BasicBlockVD
        exp = 4 if bottleneck else 1
        if output_stride == 8:
            dilations, strides = (1, 1, 2, 4), (1, 2, 1, 1)
        elif output_stride == 16:
            dilations, strides = (1, 1, 1, 2), (1, 2, 2, 1)
        else:
            dilations, strides = (1, 1, 1, 1), (1, 2, 2, 2)

        self.stem = nn.Sequential(
            ConvBNReLU(3, 32, 3, stride=2, **kw), ConvBNReLU(32, 32, 3, **kw),
            ConvBNReLU(32, 64, 3, **kw))
        self.maxpool = nn.MaxPool2d(3, 2, 1)

        planes = (64, 128, 256, 512)
        stages = []
        cin = 64
        for si, (n, p, s, d) in enumerate(zip(depths, planes, strides,
                                              dilations)):
            blocks = []
            for bi in range(n):
                dd = max(d // 2, 1) if (d > 1 and bi == 0) else d
                blocks.append(block(cin, p, stride=s if bi == 0 else 1,
                                    shortcut=bi != 0, if_first=si == 0,
                                    dilation=dd, **kw))
                cin = p * exp
            stages.append(tnn.ModuleList(blocks))
        self.stages = tnn.ModuleList(stages)
        self.feat_channels = [p * exp for p in planes]

    def forward(self, x):
        x = self.maxpool(self.stem(x))
        feats = []
        for blocks in self.stages:
            for b in blocks:
                x = b(x)
            feats.append(x)
        return feats


def resnet18_vd(**kw):
    return ResNetVD(18, **kw)


def resnet34_vd(**kw):
    return ResNetVD(34, **kw)


def resnet50_vd(**kw):
    return ResNetVD(50, **kw)


def resnet101_vd(**kw):
    return ResNetVD(101, **kw)


def resnet152_vd(**kw):
    return ResNetVD(152, **kw)
