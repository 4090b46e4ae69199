"""Xception-41 and -65 (counterpart of
``tlxcv_tpu/models/classification/xception.py``), NHWC."""
from __future__ import annotations

from torch import nn as tnn

from ... import nn
from ...device import resolve_device

__all__ = ["Xception", "xception41", "xception65", "xception"]


class SeparableConv(tnn.Module):
    """3x3 depthwise, 1x1 pointwise, BatchNorm."""

    def __init__(self, cin, cout, stride=1, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.dw = nn.Conv2d(cin, cin, 3, stride=stride, padding=1,
                            groups=cin, bias=False, **kw)
        self.pw = nn.Conv2d(cin, cout, 1, bias=False, **kw)
        self.bn = nn.BatchNorm(cout, device=device)

    def forward(self, x):
        return self.bn(self.pw(self.dw(x)))


class XceptionBlock(tnn.Module):
    """``reps`` separable convs, each after a ReLU (the first one's
    dropped when not ``start_with_relu``), widening at the first
    (``grow_first``) or the last; a 3x3 max pool when strided; plus the
    input, through a 1x1 conv and BatchNorm when the shape changes."""

    def __init__(self, cin, cout, reps, stride=1, start_with_relu=True,
                 grow_first=True, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.skip = cout != cin or stride != 1
        if self.skip:
            self.skip_conv = nn.Conv2d(cin, cout, 1, stride=stride,
                                       bias=False, **kw)
            self.skip_bn = nn.BatchNorm(cout, device=device)
        seps = []
        c = cin
        for i in range(reps):
            out = cout if (grow_first or i == reps - 1) else cin
            seps.append(SeparableConv(c, out, **kw))
            c = out
        self.seps = tnn.ModuleList(seps)
        self.relu_first = start_with_relu
        self.stride = stride
        self.pool = nn.MaxPool2d(3, stride, 1) if stride != 1 else None

    def forward(self, x):
        out = x
        for i, sep in enumerate(self.seps):
            if i > 0 or self.relu_first:
                out = nn.relu(out)
            out = sep(out)
        if self.pool is not None:
            out = self.pool(out)
        skip = self.skip_bn(self.skip_conv(x)) if self.skip else x
        return out + skip


class Xception(tnn.Module):
    def __init__(self, num_classes=1000, middle_blocks=8, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.stem = nn.Sequential(
            nn.Conv2d(3, 32, 3, stride=2, bias=False, **kw),
            nn.BatchNorm(32, device=device), nn.Activation("relu"),
            nn.Conv2d(32, 64, 3, bias=False, **kw),
            nn.BatchNorm(64, device=device), nn.Activation("relu"))
        self.block1 = XceptionBlock(64, 128, 2, 2, start_with_relu=False,
                                    **kw)
        self.block2 = XceptionBlock(128, 256, 2, 2, **kw)
        self.block3 = XceptionBlock(256, 728, 2, 2, **kw)
        self.middle = tnn.ModuleList([XceptionBlock(728, 728, 3, **kw)
                                      for _ in range(middle_blocks)])
        self.block12 = XceptionBlock(728, 1024, 2, 2, grow_first=False, **kw)
        self.conv3 = SeparableConv(1024, 1536, **kw)
        self.conv4 = SeparableConv(1536, 2048, **kw)
        self.pool = nn.GlobalAvgPool2d()
        self.fc = nn.Linear(2048, num_classes, **kw)

    def forward(self, x):
        x = self.stem(x)
        x = self.block3(self.block2(self.block1(x)))
        for blk in self.middle:
            x = blk(x)
        x = self.block12(x)
        x = nn.relu(self.conv3(x))
        x = nn.relu(self.conv4(x))
        return self.fc(self.pool(x))


def xception41(pretrained=False, **kw):
    return Xception(**kw)


def xception65(pretrained=False, **kw):
    # 16 middle-flow blocks
    return Xception(middle_blocks=16, **kw)


xception = xception41
