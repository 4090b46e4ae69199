"""Fast-SCNN (counterpart of ``tlxcv_tpu/models/segmentation/fast_scnn.py``):
learning to downsample, a global feature extractor with pyramid pooling,
feature fusion and a classifier, NHWC."""
from __future__ import annotations

from torch import nn as tnn

from ... import nn
from ...device import resolve_device
from ...ops.image import interpolate
from .layers import (AuxLayer, ConvBN, ConvBNReLU, DepthwiseConvBN,
                     PPModule, SeparableConvBNReLU)

__all__ = ["FastSCNN"]


class LearningToDownsample(tnn.Module):
    def __init__(self, dw_channels1=32, dw_channels2=48, out_channels=64,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv = ConvBNReLU(3, dw_channels1, 3, stride=2, **kw)
        self.dsconv1 = SeparableConvBNReLU(dw_channels1, dw_channels2, 3,
                                           stride=2, **kw)
        self.dsconv2 = SeparableConvBNReLU(dw_channels2, out_channels, 3,
                                           stride=2, **kw)

    def forward(self, x):
        return self.dsconv2(self.dsconv1(self.conv(x)))


class InvertedBottleneck(tnn.Module):
    def __init__(self, cin, cout, expansion=6, stride=1, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        hidden = cin * expansion
        self.use_res = stride == 1 and cin == cout
        self.block = nn.Sequential(
            ConvBNReLU(cin, hidden, 1, padding=0, **kw),
            DepthwiseConvBN(hidden, 3, stride=stride, **kw),
            ConvBN(hidden, cout, 1, padding=0, **kw))

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


class GlobalFeatureExtractor(tnn.Module):
    def __init__(self, in_channels=64, block_channels=(64, 96, 128),
                 out_channels=128, expansion=6, num_blocks=(3, 3, 3),
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)

        def stage(cin, cout, n, stride):
            return nn.Sequential(
                InvertedBottleneck(cin, cout, expansion, stride, **kw),
                *[InvertedBottleneck(cout, cout, expansion, 1, **kw)
                  for _ in range(n - 1)])

        self.bottleneck1 = stage(in_channels, block_channels[0],
                                 num_blocks[0], 2)
        self.bottleneck2 = stage(block_channels[0], block_channels[1],
                                 num_blocks[1], 2)
        self.bottleneck3 = stage(block_channels[1], block_channels[2],
                                 num_blocks[2], 1)
        self.ppm = PPModule(block_channels[2], out_channels, **kw)

    def forward(self, x):
        return self.ppm(self.bottleneck3(self.bottleneck2(
            self.bottleneck1(x))))


class FeatureFusion(tnn.Module):
    def __init__(self, high_ch=64, low_ch=128, out_ch=128, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.dwconv = ConvBNReLU(low_ch, out_ch, 3, dilation=1, **kw)
        self.low_proj = ConvBN(out_ch, out_ch, 1, padding=0, **kw)
        self.high_proj = ConvBN(high_ch, out_ch, 1, padding=0, **kw)

    def forward(self, high, low):
        low = interpolate(low, size=high.shape[1:3], mode="bilinear")
        low = self.low_proj(self.dwconv(low))
        return nn.relu(self.high_proj(high) + low)


class FastSCNN(tnn.Module):
    """Logits at the input's size; with ``enable_auxiliary_loss``, the list
    of those and the auxiliary head's (in eval too, as the reference)."""

    def __init__(self, num_classes=19, enable_auxiliary_loss=False,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.ltd = LearningToDownsample(**kw)
        self.gfe = GlobalFeatureExtractor(**kw)
        self.fusion = FeatureFusion(**kw)
        self.classifier = nn.Sequential(
            SeparableConvBNReLU(128, 128, 3, **kw),
            SeparableConvBNReLU(128, 128, 3, **kw),
            nn.Dropout(0.1), nn.Conv2d(128, num_classes, 1, **kw))
        self.aux = (AuxLayer(64, 32, num_classes, **kw)
                    if enable_auxiliary_loss else None)
        self.enable_aux = enable_auxiliary_loss

    def forward(self, x):
        size = x.shape[1:3]
        high = self.ltd(x)
        fused = self.fusion(high, self.gfe(high))
        logits = interpolate(self.classifier(fused), size=size,
                             mode="bilinear")
        if self.enable_aux:
            return [logits, interpolate(self.aux(high), size=size,
                                        mode="bilinear")]
        return logits
