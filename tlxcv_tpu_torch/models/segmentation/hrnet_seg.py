"""HRNet semantic segmentation (counterpart of
``tlxcv_tpu/models/segmentation/hrnet_seg.py``): an FCN head over the
concat of the upsampled branches, and the contrastive variant's
projection head, NHWC."""
from __future__ import annotations

from torch import nn

from ...device import resolve_device
from ...nn.layers import Activation, Conv2d, Sequential
from ...ops.image import interpolate
from ..backbones.hrnet import HRNet, hrnet_w18, hrnet_w48
from .layers import ConvBNReLU

__all__ = ["FCN", "HRNetW48Contrast", "hrnet_seg_w18", "hrnet_seg_w48"]


class FCNHead(nn.Module):
    def __init__(self, in_channels, num_classes, channels=None, device=None,
                 generator=None):
        super().__init__()
        channels = channels or in_channels
        self.conv = ConvBNReLU(in_channels, channels, 1, padding=0,
                               device=device, generator=generator)
        self.cls = Conv2d(channels, num_classes, 1, device=device,
                          generator=generator)

    def forward(self, x):
        return self.cls(self.conv(x))


class FCN(nn.Module):
    """FCN over an HRNet backbone; logits at the input's size."""

    def __init__(self, num_classes=19, backbone: HRNet = None, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self.backbone = backbone if backbone is not None else hrnet_w18(
            device=device, generator=generator)
        self.head = FCNHead(self.backbone.feat_channels[0], num_classes,
                            device=device, generator=generator)

    def forward(self, x):
        logits = self.head(self.backbone.concat_features(x))
        return interpolate(logits, size=x.shape[1:3], mode="bilinear")


class HRNetW48Contrast(nn.Module):
    """Segmentation head and, in training mode, a projection head for
    contrastive training (unit-norm embeddings)."""

    def __init__(self, num_classes=19, proj_dim=256, backbone: HRNet = None,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.backbone = backbone if backbone is not None else hrnet_w48(**kw)
        cin = self.backbone.feat_channels[0]
        self.seg_head = Sequential(ConvBNReLU(cin, cin, 3, **kw),
                                   Conv2d(cin, num_classes, 1, **kw))
        self.proj_head = Sequential(Conv2d(cin, cin, 1, **kw),
                                    Activation("relu"),
                                    Conv2d(cin, proj_dim, 1, **kw))

    def forward(self, x):
        feat = self.backbone.concat_features(x)
        logits = interpolate(self.seg_head(feat), size=x.shape[1:3],
                             mode="bilinear")
        if self.training:
            proj = self.proj_head(feat)
            proj = proj / (proj.norm(dim=-1, keepdim=True) + 1e-9)
            return {"seg": logits, "embed": proj}
        return logits


def hrnet_seg_w18(num_classes=19, device=None, generator=None):
    device = resolve_device(device)
    return FCN(num_classes, hrnet_w18(device=device, generator=generator),
               device=device, generator=generator)


def hrnet_seg_w48(num_classes=19, device=None, generator=None):
    device = resolve_device(device)
    return FCN(num_classes, hrnet_w48(device=device, generator=generator),
               device=device, generator=generator)
