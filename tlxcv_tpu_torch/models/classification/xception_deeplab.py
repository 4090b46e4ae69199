"""Xception DeepLab-variant classifiers (counterpart of
``tlxcv_tpu/models/classification/xception_deeplab.py``), NHWC: the
Xception blocks with a padded stem and a three-conv exit flow."""
from __future__ import annotations

from torch import nn as tnn

from ... import nn
from ...device import resolve_device
from .xception import SeparableConv, XceptionBlock

__all__ = ["XceptionDeeplab", "xception_deeplab", "xception41_deeplab",
           "xception65_deeplab"]


class XceptionDeeplab(tnn.Module):
    def __init__(self, num_classes=1000, middle_blocks=16, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        relu = lambda: nn.Activation("relu")  # noqa: E731
        self.stem = nn.Sequential(
            nn.Conv2d(3, 32, 3, stride=2, padding=1, bias=False, **kw),
            nn.BatchNorm(32, device=device), relu(),
            nn.Conv2d(32, 64, 3, padding=1, bias=False, **kw),
            nn.BatchNorm(64, device=device), relu())
        self.entry = nn.Sequential(
            XceptionBlock(64, 128, 2, 2, start_with_relu=False, **kw),
            XceptionBlock(128, 256, 2, 2, **kw),
            XceptionBlock(256, 728, 2, 2, **kw))
        self.middle = tnn.ModuleList([XceptionBlock(728, 728, 3, **kw)
                                      for _ in range(middle_blocks)])
        self.exit1 = XceptionBlock(728, 1024, 2, 2, grow_first=False, **kw)
        self.exit2 = nn.Sequential(
            SeparableConv(1024, 1536, **kw), relu(),
            SeparableConv(1536, 1536, **kw), relu(),
            SeparableConv(1536, 2048, **kw), relu())
        self.pool = nn.GlobalAvgPool2d()
        self.fc = nn.Linear(2048, num_classes, **kw)

    def forward(self, x):
        x = self.entry(self.stem(x))
        for blk in self.middle:
            x = blk(x)
        x = self.exit2(self.exit1(x))
        return self.fc(self.pool(x))


def xception_deeplab(pretrained=False, **kw):
    return XceptionDeeplab(**kw)


def xception65_deeplab(pretrained=False, **kw):
    return XceptionDeeplab(middle_blocks=16, **kw)


def xception41_deeplab(pretrained=False, **kw):
    # 8 middle-flow blocks
    return XceptionDeeplab(middle_blocks=8, **kw)
