"""Remote-sensing segmentation (counterpart of ``tlxcv_tpu/models/rs/
seg.py``), NHWC: FarSeg, the PaddleRS UNet, and DeepLabV3+ (the
segmentation zoo's).  ``model(x)`` returns logits [B, H, W, classes] at
the input's size.  No kernel of ours runs here: FarSeg's FPN merges by
``ops.image.interpolate`` nearest plus an add, as the reference does (not
``upsample_add``), and its other resizes are bilinear with
``align_corners=True``."""
from __future__ import annotations

import math

import torch
from torch import nn as tnn

from ... import nn
from ...device import resolve_device
from ...ops.image import interpolate
from ..classification.resnet import ResNet
from ..segmentation.deeplab import DeepLabV3P
from .layers import Conv1x1, Conv3x3

__all__ = ["FarSeg", "RSUNet", "DeepLabV3P"]


class FPN(tnn.Module):
    """A lateral 1x1 conv per level, the top-down path by nearest resize
    (``floor(i * in / out)``) and an add, a 3x3 conv per level."""

    def __init__(self, in_channels, out_ch=256, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.inner_blocks = tnn.ModuleList([Conv1x1(c, out_ch, **kw)
                                            for c in in_channels])
        self.layer_blocks = tnn.ModuleList([Conv3x3(out_ch, out_ch, **kw)
                                            for _ in in_channels])

    def forward(self, feats):
        last_inner = self.inner_blocks[-1](feats[-1])
        results = [self.layer_blocks[-1](last_inner)]
        for i in range(len(feats) - 2, -1, -1):
            top_down = interpolate(last_inner, size=feats[i].shape[1:3],
                                   mode="nearest")
            last_inner = self.inner_blocks[i](feats[i]) + top_down
            results.insert(0, self.layer_blocks[i](last_inner))
        return results


def _proj(cin, cout, kw):
    return nn.Sequential(nn.Conv2d(cin, cout, 1, **kw), nn.Activation("relu"),
                         nn.Conv2d(cout, cout, 1, **kw))


def _conv_bn_relu(cin, cout, kw):
    return nn.Sequential(nn.Conv2d(cin, cout, 1, **kw),
                         nn.BatchNorm(cout, device=kw["device"]),
                         nn.Activation("relu"))


class FSRelation(tnn.Module):
    """Foreground-scene relation: each level's re-encoded features gated
    by sigmoid(sum over channels of the scene projection times the level's
    content encoding); one scene projection per level with
    ``scale_aware_proj``, else one shared."""

    def __init__(self, scene_ch, channels_list, out_ch,
                 scale_aware_proj=True, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.scale_aware_proj = scale_aware_proj
        if scale_aware_proj:
            self.scene_encoder = tnn.ModuleList([
                _proj(scene_ch, out_ch, kw) for _ in channels_list])
        else:
            self.scene_encoder = _proj(scene_ch, out_ch, kw)
        self.content_encoders = tnn.ModuleList([
            _conv_bn_relu(c, out_ch, kw) for c in channels_list])
        self.feature_reencoders = tnn.ModuleList([
            _conv_bn_relu(c, out_ch, kw) for c in channels_list])

    def forward(self, scene_feature, feature_list):
        content = [enc(f) for enc, f in zip(self.content_encoders,
                                            feature_list)]
        if self.scale_aware_proj:
            scenes = [op(scene_feature) for op in self.scene_encoder]
        else:
            scenes = [self.scene_encoder(scene_feature)] * len(content)
        relations = [torch.sigmoid((sf * cf).sum(-1, keepdim=True))
                     for sf, cf in zip(scenes, content)]
        return [r * op(f) for r, op, f in zip(
            relations, self.feature_reencoders, feature_list)]


class AsymmetricDecoder(tnn.Module):
    """Each level through log2(stride / out_stride) conv-BN-ReLU layers
    (one at the output stride), each followed by a 2x bilinear upsample
    (``align_corners=True``) where the level is coarser; the levels'
    mean."""

    def __init__(self, in_ch, out_ch, in_strides=(4, 8, 16, 32),
                 out_stride=4, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.blocks = tnn.ModuleList()
        self.ups = []
        for s in in_strides:
            num_up = int(math.log2(s)) - int(math.log2(out_stride))
            self.blocks.append(tnn.ModuleList([
                nn.Sequential(
                    nn.Conv2d(in_ch if idx == 0 else out_ch, out_ch, 3,
                              padding=1, bias=False, **kw),
                    nn.BatchNorm(out_ch, device=device),
                    nn.Activation("relu"))
                for idx in range(max(num_up, 1))]))
            self.ups.append(num_up != 0)

    def forward(self, feature_list):
        outs = []
        for convs, do_up, f in zip(self.blocks, self.ups, feature_list):
            for conv in convs:
                f = conv(f)
                if do_up:
                    f = interpolate(f, scale_factor=2, mode="bilinear",
                                    align_corners=True)
            outs.append(f)
        return sum(outs) / len(outs)


class FarSeg(tnn.Module):
    """Foreground-aware relation network: a ResNet, an FPN, the
    foreground-scene relation with the C5 mean as the scene, the
    asymmetric decoder to stride 4, a 1x1 classifier resized (bilinear,
    ``align_corners=True``) to the input's size."""

    def __init__(self, num_classes=16, backbone_depth=50, in_channels=3,
                 fpn_out_channels=256, fsr_out_channels=256,
                 scale_aware_proj=True, decoder_out_channels=128,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.encoder = ResNet(depth=backbone_depth, num_classes=0,
                              with_pool=False, in_channels=in_channels, **kw)
        chs = self.encoder.feat_channels
        self.fpn = FPN(chs, fpn_out_channels, **kw)
        self.fsr = FSRelation(chs[-1], [fpn_out_channels] * 4,
                              fsr_out_channels, scale_aware_proj, **kw)
        self.decoder = AsymmetricDecoder(fsr_out_channels,
                                         decoder_out_channels, **kw)
        self.cls_head = nn.Conv2d(decoder_out_channels, num_classes, 1, **kw)

    def forward(self, x):
        feats = self.encoder.features(x)
        scene = feats[-1].mean((1, 2), keepdim=True)
        feature = self.decoder(self.fsr(scene, self.fpn(feats)))
        return interpolate(self.cls_head(feature), size=x.shape[1:3],
                           mode="bilinear", align_corners=True)


class RSUNet(tnn.Module):
    """The plain same-padding UNet of PaddleRS: five levels of two 3x3
    conv-BN-ReLU, max-pool down, transposed 2x2 convs up, the skip first
    in each concatenation, a 1x1 classifier."""

    def __init__(self, in_channels=3, num_classes=2, width=64, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        w = [width * 2 ** i for i in range(5)]

        def block(cin, cout):
            return nn.Sequential(Conv3x3(cin, cout, norm=True, act=True, **kw),
                                 Conv3x3(cout, cout, norm=True, act=True,
                                         **kw))

        self.enc = tnn.ModuleList([
            block(in_channels if i == 0 else w[i - 1], w[i])
            for i in range(5)])
        self.pool = nn.MaxPool2d(2, 2)
        self.up = tnn.ModuleList([
            nn.ConvTranspose2d(w[i], w[i - 1], 2, stride=2, **kw)
            for i in range(4, 0, -1)])
        self.dec = tnn.ModuleList([block(w[i - 1] * 2, w[i - 1])
                                   for i in range(4, 0, -1)])
        self.head = Conv1x1(w[0], num_classes, **kw)

    def forward(self, x):
        skips = []
        for i, enc in enumerate(self.enc):
            x = enc(self.pool(x) if i else x)
            skips.append(x)
        for up, dec, skip in zip(self.up, self.dec, skips[3::-1]):
            x = dec(torch.cat([skip, up(x)], -1))
        return self.head(x)
