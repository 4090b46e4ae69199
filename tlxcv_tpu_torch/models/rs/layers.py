"""Shared remote-sensing blocks (counterpart of
``tlxcv_tpu/models/rs/layers.py``), NHWC."""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn

__all__ = ["Conv1x1", "Conv3x3", "Conv7x7", "MaxPool2x2", "ConvTransposed3x3",
           "CBAM", "ChannelAttention", "SpatialAttention"]


class _ConvBlock(tnn.Module):
    """Conv with 'same' padding, optional BatchNorm and ReLU; the conv has
    a bias unless a BatchNorm follows it (unless ``bias`` says)."""

    def __init__(self, cin, cout, k, norm=False, act=False, bias=None,
                 device=None, generator=None, **kw):
        super().__init__()
        if bias is None:
            bias = not norm
        self.conv = nn.Conv2d(cin, cout, k, padding=k // 2, bias=bias,
                              device=device, generator=generator, **kw)
        self.norm = nn.BatchNorm(cout, device=device) if norm else None
        self.act = act

    def forward(self, x):
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return nn.relu(x) if self.act else x


class Conv1x1(_ConvBlock):
    def __init__(self, cin, cout, norm=False, act=False, **kw):
        super().__init__(cin, cout, 1, norm, act, **kw)


class Conv3x3(_ConvBlock):
    def __init__(self, cin, cout, norm=False, act=False, **kw):
        super().__init__(cin, cout, 3, norm, act, **kw)


class Conv7x7(_ConvBlock):
    def __init__(self, cin, cout, norm=False, act=False, **kw):
        super().__init__(cin, cout, 7, norm, act, **kw)


class MaxPool2x2(nn.MaxPool2d):
    def __init__(self):
        super().__init__(2, 2)


class ConvTransposed3x3(tnn.Module):
    """Stride-2 transposed 3x3 conv (doubles H and W), optional BatchNorm
    and ReLU."""

    def __init__(self, cin, cout, norm=False, act=False, device=None,
                 generator=None):
        super().__init__()
        self.conv = nn.ConvTranspose2d(cin, cout, 3, stride=2, padding=1,
                                       output_padding=1, bias=not norm,
                                       device=device, generator=generator)
        self.norm = nn.BatchNorm(cout, device=device) if norm else None
        self.act = act

    def forward(self, x):
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return nn.relu(x) if self.act else x


class ChannelAttention(tnn.Module):
    def __init__(self, channels, ratio=8, device=None, generator=None):
        super().__init__()
        kw = dict(bias=False, device=device, generator=generator)
        self.fc1 = nn.Conv2d(channels, channels // ratio, 1, **kw)
        self.fc2 = nn.Conv2d(channels // ratio, channels, 1, **kw)

    def forward(self, x):
        avg = self.fc2(nn.relu(self.fc1(x.mean((1, 2), keepdim=True))))
        mx = self.fc2(nn.relu(self.fc1(x.amax((1, 2), keepdim=True))))
        return torch.sigmoid(avg + mx)


class SpatialAttention(tnn.Module):
    def __init__(self, kernel_size=7, device=None, generator=None):
        super().__init__()
        self.conv = nn.Conv2d(2, 1, kernel_size, padding=kernel_size // 2,
                              bias=False, device=device, generator=generator)

    def forward(self, x):
        pooled = torch.cat([x.mean(-1, keepdim=True),
                            x.amax(-1, keepdim=True)], -1)
        return torch.sigmoid(self.conv(pooled))


class CBAM(tnn.Module):
    def __init__(self, channels, ratio=8, kernel_size=7, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.ca = ChannelAttention(channels, ratio, **kw)
        self.sa = SpatialAttention(kernel_size, **kw)

    def forward(self, x):
        x = x * self.ca(x)
        return x * self.sa(x)
