"""ResNet / wide-ResNet / ResNeXt family (counterpart of
``tlxcv_tpu/models/classification/resnet.py``).

NHWC images ``[B, H, W, C]`` at the public call, the JAX model's attribute
names (``layer1.layers.0.conv1``), so the bridge needs no name table.  The
ReLUs go through ``nn.relu`` looked up at call time, which the int8
quantization trace patches.
"""
from __future__ import annotations

from torch import nn as tnn

from ... import nn
from ...core import init as I
from ...device import resolve_device

__all__ = [
    "ResNet", "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "wide_resnet50_2", "wide_resnet101_2", "resnext50_32x4d",
    "resnext101_32x4d", "resnext101_64x4d",
]


def conv3x3(cin, cout, stride=1, groups=1, dilation=1, **kw):
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=dilation,
                     dilation=dilation, groups=groups, bias=False, **kw)


def conv1x1(cin, cout, stride=1, **kw):
    return nn.Conv2d(cin, cout, 1, stride=stride, bias=False, **kw)


class BasicBlock(tnn.Module):
    expansion = 1

    def __init__(self, in_channels, out_channels, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, device=None,
                 generator=None):
        super().__init__()
        if dilation > 1:
            raise NotImplementedError(
                "Dilation > 1 not supported in BasicBlock")
        kw = dict(device=device, generator=generator)
        self.conv1 = conv3x3(in_channels, out_channels, stride, **kw)
        self.bn1 = nn.BatchNorm(out_channels, device=device)
        self.conv2 = conv3x3(out_channels, out_channels, **kw)
        self.bn2 = nn.BatchNorm(out_channels, device=device)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = nn.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return nn.relu(out + identity)


class BottleneckBlock(tnn.Module):
    expansion = 4

    def __init__(self, in_channels, out_channels, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        width = int(out_channels * (base_width / 64.0)) * groups
        self.conv1 = conv1x1(in_channels, width, **kw)
        self.bn1 = nn.BatchNorm(width, device=device)
        self.conv2 = conv3x3(width, width, stride, groups, dilation, **kw)
        self.bn2 = nn.BatchNorm(width, device=device)
        self.conv3 = conv1x1(width, out_channels * self.expansion, **kw)
        self.bn3 = nn.BatchNorm(out_channels * self.expansion, device=device)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = nn.relu(self.bn1(self.conv1(x)))
        out = nn.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return nn.relu(out + identity)


_DEPTH_CFG = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (BottleneckBlock, (3, 4, 6, 3)),
    101: (BottleneckBlock, (3, 4, 23, 3)),
    152: (BottleneckBlock, (3, 8, 36, 3)),
}


class ResNet(tnn.Module):
    """Returns logits [N, num_classes]; ``features()`` returns the C2-C5
    pyramid for detection/segmentation necks."""

    def __init__(self, block=None, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, strides=(2, 1, 2, 2, 2),
                 in_channels=3, device=None, generator=None):
        """``strides`` = (conv1, layer1..layer4)."""
        super().__init__()
        device = resolve_device(device)
        if block is None:
            block, layer_counts = _DEPTH_CFG[depth]
        else:
            layer_counts = _DEPTH_CFG[depth][1]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.groups = groups
        self.base_width = width
        kw = dict(device=device, generator=generator)

        self.conv1 = nn.Conv2d(in_channels, 64, 7, stride=strides[0],
                               padding=3, bias=False, **kw)
        self.bn1 = nn.BatchNorm(64, device=device)
        self.maxpool = nn.MaxPool2d(3, 2, 1)

        self.inplanes = 64
        self.layer1 = self._make_layer(block, 64, layer_counts[0], strides[1],
                                       **kw)
        self.layer2 = self._make_layer(block, 128, layer_counts[1],
                                       strides[2], **kw)
        self.layer3 = self._make_layer(block, 256, layer_counts[2],
                                       strides[3], **kw)
        self.layer4 = self._make_layer(block, 512, layer_counts[3],
                                       strides[4], **kw)
        self.feat_channels = [c * block.expansion for c in (64, 128, 256, 512)]

        if with_pool:
            self.avgpool = nn.GlobalAvgPool2d()
        if num_classes > 0:
            self.fc = nn.Linear(
                512 * block.expansion, num_classes,
                w_init=lambda s, **k: I.normal(s, std=0.01, **k), **kw)

    def _make_layer(self, block, planes, blocks, stride, **kw):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                conv1x1(self.inplanes, planes * block.expansion, stride,
                        **kw),
                nn.BatchNorm(planes * block.expansion, device=kw["device"]),
            )
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, **kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, **kw))
        return nn.Sequential(*layers)

    def stem(self, x):
        return self.maxpool(nn.relu(self.bn1(self.conv1(x))))

    def features(self, x):
        """C2..C5 feature pyramid (NHWC)."""
        x = self.stem(x)
        c2 = self.layer1(x)
        c3 = self.layer2(c2)
        c4 = self.layer3(c3)
        c5 = self.layer4(c4)
        return [c2, c3, c4, c5]

    def forward(self, x):
        x = self.features(x)[-1]
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(x)
        return x


def _resnet(depth, **kwargs):
    return ResNet(depth=depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(18, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(34, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(50, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(101, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(152, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    return _resnet(50, width=128, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    return _resnet(101, width=128, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return _resnet(50, groups=32, width=4, **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    return _resnet(101, groups=32, width=4, **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    return _resnet(101, groups=64, width=4, **kwargs)
