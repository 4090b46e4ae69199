"""DeepLabV3 and DeepLabV3+ on ResNet-vD (counterpart of
``tlxcv_tpu/models/segmentation/deeplab.py``), NHWC."""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...device import resolve_device
from ...ops.image import interpolate
from ..backbones.resnet_vd import resnet50_vd, resnet101_vd
from .layers import ASPPModule, ConvBNReLU, SeparableConvBNReLU

__all__ = ["DeepLabV3", "DeepLabV3P", "deeplabv3", "deeplabv3p"]


class DeepLabV3PHead(tnn.Module):
    def __init__(self, num_classes, backbone_channels, low_level_channels,
                 aspp_ratios=(1, 12, 24, 36), aspp_out=256, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.aspp = ASPPModule(aspp_ratios, backbone_channels, aspp_out,
                               use_sep_conv=True, **kw)
        self.low_conv = ConvBNReLU(low_level_channels, 48, 1, padding=0, **kw)
        self.fuse1 = SeparableConvBNReLU(aspp_out + 48, 256, 3, **kw)
        self.fuse2 = SeparableConvBNReLU(256, 256, 3, **kw)
        self.classifier = nn.Conv2d(256, num_classes, 1, **kw)

    def forward(self, low, high):
        x = interpolate(self.aspp(high), size=low.shape[1:3],
                        mode="bilinear")
        x = torch.cat([x, self.low_conv(low)], -1)
        return self.classifier(self.fuse2(self.fuse1(x)))


class DeepLabV3P(tnn.Module):
    def __init__(self, num_classes=19, backbone=None,
                 backbone_indices=(0, 3), device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.backbone = backbone if backbone is not None else resnet50_vd(
            **kw)
        self.indices = backbone_indices
        chs = self.backbone.feat_channels
        self.head = DeepLabV3PHead(num_classes, chs[backbone_indices[1]],
                                   chs[backbone_indices[0]], **kw)

    def forward(self, x):
        feats = self.backbone(x)
        logits = self.head(feats[self.indices[0]], feats[self.indices[1]])
        return interpolate(logits, size=x.shape[1:3], mode="bilinear")


class DeepLabV3(tnn.Module):
    def __init__(self, num_classes=19, backbone=None, backbone_index=3,
                 aspp_ratios=(1, 12, 24, 36), device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.backbone = backbone if backbone is not None else resnet50_vd(
            **kw)
        self.index = backbone_index
        self.aspp = ASPPModule(aspp_ratios,
                               self.backbone.feat_channels[backbone_index],
                               256, **kw)
        self.classifier = nn.Conv2d(256, num_classes, 1, **kw)

    def forward(self, x):
        feats = self.backbone(x)
        logits = self.classifier(self.aspp(feats[self.index]))
        return interpolate(logits, size=x.shape[1:3], mode="bilinear")


def _backbone(name, device, generator):
    factory = resnet101_vd if "101" in str(name) else resnet50_vd
    return factory(device=device, generator=generator)


def deeplabv3(num_classes=19, backbone="resnet50_vd", device=None,
              generator=None, **kw):
    device = resolve_device(device)
    return DeepLabV3(num_classes=num_classes,
                     backbone=_backbone(backbone, device, generator),
                     device=device, generator=generator, **kw)


def deeplabv3p(num_classes=19, backbone="resnet50_vd", device=None,
               generator=None, **kw):
    device = resolve_device(device)
    return DeepLabV3P(num_classes=num_classes,
                      backbone=_backbone(backbone, device, generator),
                      device=device, generator=generator, **kw)
