"""Shared segmentation layers (counterpart of
``tlxcv_tpu/models/segmentation/layers.py``), NHWC.  ``DepthwiseConvBN`` and
``SeparableConvBNReLU`` run float grouped convolutions (cuDNN on the card).
"""
from __future__ import annotations

import torch
from torch import nn

from ...nn.layers import (AdaptiveAvgPool2d, BatchNorm, Conv2d, Dropout,
                          get_activation)
from ...ops.image import interpolate

__all__ = ["ConvBNReLU", "ConvBN", "SeparableConvBNReLU", "DepthwiseConvBN",
           "AuxLayer", "ASPPModule", "PPModule"]


class ConvBNReLU(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, padding="same",
                 stride=1, dilation=1, groups=1, act="relu", device=None,
                 generator=None):
        super().__init__()
        if padding == "same":
            padding = (kernel_size - 1) // 2 * dilation
        self.conv = Conv2d(in_channels, out_channels, kernel_size,
                           stride=stride, padding=padding, dilation=dilation,
                           groups=groups, bias=False, device=device,
                           generator=generator)
        self.bn = BatchNorm(out_channels, device=device)
        self.act = get_activation(act)

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class ConvBN(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, padding="same",
                 stride=1, dilation=1, groups=1, device=None, generator=None):
        super().__init__()
        if padding == "same":
            padding = (kernel_size - 1) // 2 * dilation
        self.conv = Conv2d(in_channels, out_channels, kernel_size,
                           stride=stride, padding=padding, dilation=dilation,
                           groups=groups, bias=False, device=device,
                           generator=generator)
        self.bn = BatchNorm(out_channels, device=device)

    def forward(self, x):
        return self.bn(self.conv(x))


class DepthwiseConvBN(nn.Module):
    def __init__(self, in_channels, kernel_size, stride=1, dilation=1,
                 device=None, generator=None):
        super().__init__()
        self.conv = ConvBN(in_channels, in_channels, kernel_size,
                           stride=stride, dilation=dilation,
                           groups=in_channels, device=device,
                           generator=generator)

    def forward(self, x):
        return self.conv(x)


class SeparableConvBNReLU(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 dilation=1, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.depthwise = ConvBNReLU(in_channels, in_channels, kernel_size,
                                    stride=stride, dilation=dilation,
                                    groups=in_channels, **kw)
        self.pointwise = ConvBNReLU(in_channels, out_channels, 1, padding=0,
                                    **kw)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class AuxLayer(nn.Module):
    """Auxiliary head: 3x3 conv, dropout, 1x1 classifier."""

    def __init__(self, in_channels, inter_channels, out_channels,
                 dropout_prob=0.1, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv = ConvBNReLU(in_channels, inter_channels, 3, **kw)
        self.dropout = Dropout(dropout_prob)
        self.classifier = Conv2d(inter_channels, out_channels, 1, **kw)

    def forward(self, x):
        return self.classifier(self.dropout(self.conv(x)))


class ASPPModule(nn.Module):
    """Atrous spatial pyramid pooling."""

    def __init__(self, aspp_ratios, in_channels, out_channels,
                 use_sep_conv=False, image_pooling=True, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        blocks = []
        for ratio in aspp_ratios:
            if use_sep_conv and ratio > 1:
                blocks.append(SeparableConvBNReLU(
                    in_channels, out_channels, 3, dilation=ratio, **kw))
            else:
                blocks.append(ConvBNReLU(
                    in_channels, out_channels, 1 if ratio == 1 else 3,
                    dilation=ratio, **kw))
        self.blocks = nn.ModuleList(blocks)
        self.image_pooling = image_pooling
        if image_pooling:
            self.global_conv = ConvBNReLU(in_channels, out_channels, 1,
                                          padding=0, **kw)
        n = len(aspp_ratios) + int(image_pooling)
        self.project = ConvBNReLU(out_channels * n, out_channels, 1,
                                  padding=0, **kw)
        self.dropout = Dropout(0.1)

    def forward(self, x):
        outs = [blk(x) for blk in self.blocks]
        if self.image_pooling:
            gp = self.global_conv(x.mean((1, 2), keepdim=True))
            outs.append(gp.expand(*outs[0].shape[:3], gp.shape[-1]))
        return self.dropout(self.project(torch.cat(outs, -1)))


class PPModule(nn.Module):
    """Pyramid pooling (PSP style)."""

    def __init__(self, in_channels, out_channels, bin_sizes=(1, 2, 3, 6),
                 dim_reduction=True, align_corners=False, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.bin_sizes = tuple(bin_sizes)
        inter = in_channels // len(bin_sizes) if dim_reduction else in_channels
        self.stages = nn.ModuleList([
            ConvBNReLU(in_channels, inter, 1, padding=0, **kw)
            for _ in bin_sizes])
        self.align_corners = align_corners
        self.project = ConvBNReLU(
            in_channels + inter * len(bin_sizes), out_channels, 3, **kw)

    def forward(self, x):
        outs = [x]
        for size, stage in zip(self.bin_sizes, self.stages):
            feat = stage(AdaptiveAvgPool2d((size, size))(x))
            outs.append(interpolate(feat, size=x.shape[1:3], mode="bilinear",
                                    align_corners=self.align_corners))
        return self.project(torch.cat(outs, -1))
