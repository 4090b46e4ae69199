"""RedNet, a ResNet with involutions (counterpart of
``tlxcv_tpu/models/classification/rednet.py``), NHWC.

The JAX model's attribute names (``blocks.3.inv.span``).  Involution
builds a kernel per pixel and per group of 16 channels from the pixel
itself and applies it to the pixel's neighbourhood, which ``ops.image.
unfold`` gathers (channel-major within a patch, as the reference's).
"""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...device import resolve_device
from ...ops.image import unfold

__all__ = ["RedNet", "rednet26", "rednet50", "rednet101"]


class Involution(tnn.Module):
    def __init__(self, channels, kernel_size=7, stride=1, group_channels=16,
                 reduction=4, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.channels = channels
        self.kernel_size = kernel_size
        self.stride = stride
        self.groups = channels // group_channels
        self.group_channels = group_channels
        self.reduce = nn.Sequential(
            nn.Conv2d(channels, channels // reduction, 1, bias=False, **kw),
            nn.BatchNorm(channels // reduction, device=device),
            nn.Activation("relu"))
        self.span = nn.Conv2d(channels // reduction,
                              self.groups * kernel_size * kernel_size, 1,
                              **kw)
        self.pool = nn.AvgPool2d(stride, stride) if stride > 1 else None

    def forward(self, x):
        k = self.kernel_size
        ref = x if self.pool is None else self.pool(x)
        weight = self.span(self.reduce(ref))  # [B, OH, OW, G*k*k]
        b, oh, ow, _ = weight.shape
        weight = weight.reshape(b, oh * ow, self.groups, k * k)
        patches, _ = unfold(x, k, stride=self.stride, padding=(k - 1) // 2)
        # [B, L, C*k*k], channel-major within a patch -> [B, L, G, C/G, k*k]
        patches = patches.reshape(b, oh * ow, self.groups,
                                  self.group_channels, k * k)
        out = torch.einsum("blgck,blgk->blgc", patches, weight)
        return out.reshape(b, oh, ow, self.channels)


class BottleneckRed(tnn.Module):
    def __init__(self, cin, planes, stride=1, downsample=False, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv1 = nn.Sequential(
            nn.Conv2d(cin, planes, 1, bias=False, **kw),
            nn.BatchNorm(planes, device=device), nn.Activation("relu"))
        self.inv = Involution(planes, 7, stride, **kw)
        self.bn2 = nn.BatchNorm(planes, device=device)
        self.conv3 = nn.Sequential(
            nn.Conv2d(planes, planes * 4, 1, bias=False, **kw),
            nn.BatchNorm(planes * 4, device=device))
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, planes * 4, 1, stride=stride, bias=False, **kw),
                nn.BatchNorm(planes * 4, device=device))

    def forward(self, x):
        out = self.conv1(x)
        out = nn.relu(self.bn2(self.inv(out)))
        out = self.conv3(out)
        identity = x if self.downsample is None else self.downsample(x)
        return nn.relu(out + identity)


class RedNet(tnn.Module):
    def __init__(self, depth=26, num_classes=1000, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        counts = {26: (1, 2, 4, 1), 38: (2, 3, 5, 2), 50: (3, 4, 6, 3),
                  101: (3, 4, 23, 3)}[depth]
        self.stem = nn.Sequential(
            nn.Conv2d(3, 32, 3, stride=2, padding=1, bias=False, **kw),
            nn.BatchNorm(32, device=device), nn.Activation("relu"))
        self.stem_inv = Involution(32, 3, 1, **kw)
        self.stem2 = nn.Sequential(
            nn.BatchNorm(32, device=device), nn.Activation("relu"),
            nn.Conv2d(32, 64, 3, padding=1, bias=False, **kw),
            nn.BatchNorm(64, device=device), nn.Activation("relu"),
            nn.MaxPool2d(3, 2, 1))
        blocks = []
        cin = 64
        for si, (n, planes) in enumerate(zip(counts, (64, 128, 256, 512))):
            for bi in range(n):
                stride = 2 if (bi == 0 and si > 0) else 1
                blocks.append(BottleneckRed(cin, planes, stride,
                                            downsample=(bi == 0), **kw))
                cin = planes * 4
        self.blocks = tnn.ModuleList(blocks)
        self.pool = nn.GlobalAvgPool2d()
        self.fc = nn.Linear(cin, num_classes, **kw)

    def forward(self, x):
        x = self.stem2(self.stem_inv(self.stem(x)))
        for b in self.blocks:
            x = b(x)
        return self.fc(self.pool(x))


def rednet26(pretrained=False, **kw):
    return RedNet(26, **kw)


def rednet50(pretrained=False, **kw):
    return RedNet(50, **kw)


def rednet101(pretrained=False, **kw):
    return RedNet(101, **kw)
