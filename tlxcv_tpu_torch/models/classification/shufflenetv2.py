"""ShuffleNetV2 x0.25 to x2.0 (counterpart of
``tlxcv_tpu/models/classification/shufflenetv2.py``), NHWC."""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...device import resolve_device

__all__ = ["ShuffleNetV2", "channel_shuffle", "shufflenet_v2_x0_25",
           "shufflenet_v2_x0_33", "shufflenet_v2_x0_5", "shufflenet_v2_x1_0",
           "shufflenet_v2_x1_5", "shufflenet_v2_x2_0"]


def channel_shuffle(x, groups=2):
    """Channels viewed as ``[groups, C / groups]`` and transposed: output
    channel ``j * groups + g`` is input channel ``g * C / groups + j``."""
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, groups, c // groups).transpose(-1, -2)
    return x.reshape(n, h, w, c)


class ConvBN(tnn.Module):
    def __init__(self, cin, cout, k, stride=1, groups=1, act="relu",
                 device=None, generator=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                              groups=groups, bias=False, device=device,
                              generator=generator)
        self.bn = nn.BatchNorm(cout, device=device)
        self.act = nn.get_activation(act) if act else None

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act else x


class InvertedUnit(tnn.Module):
    def __init__(self, cin, cout, stride, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.stride = stride
        branch = cout // 2
        if stride > 1:
            self.b1_dw = ConvBN(cin, cin, 3, stride, groups=cin, act=None,
                                **kw)
            self.b1_pw = ConvBN(cin, branch, 1, **kw)
            in2 = cin
        else:
            in2 = cin // 2
        self.b2_pw1 = ConvBN(in2, branch, 1, **kw)
        self.b2_dw = ConvBN(branch, branch, 3, stride, groups=branch,
                            act=None, **kw)
        self.b2_pw2 = ConvBN(branch, branch, 1, **kw)

    def forward(self, x):
        if self.stride > 1:
            x1 = self.b1_pw(self.b1_dw(x))
            x2 = x
        else:
            x1, x2 = x.chunk(2, -1)
        x2 = self.b2_pw2(self.b2_dw(self.b2_pw1(x2)))
        return channel_shuffle(torch.cat([x1, x2], -1))


_CHANNELS = {
    0.25: (24, 24, 48, 96, 512), 0.33: (24, 32, 64, 128, 512),
    0.5: (24, 48, 96, 192, 1024), 1.0: (24, 116, 232, 464, 1024),
    1.5: (24, 176, 352, 704, 1024), 2.0: (24, 244, 488, 976, 2048),
}
_REPEATS = (4, 8, 4)


class ShuffleNetV2(tnn.Module):
    def __init__(self, scale=1.0, num_classes=1000, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        chs = _CHANNELS[scale]
        self.stem = ConvBN(3, chs[0], 3, 2, **kw)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        blocks = []
        cin = chs[0]
        for stage, reps in enumerate(_REPEATS):
            cout = chs[stage + 1]
            for i in range(reps):
                blocks.append(InvertedUnit(cin, cout, 2 if i == 0 else 1,
                                           **kw))
                cin = cout
        self.blocks = tnn.ModuleList(blocks)
        self.head = ConvBN(cin, chs[-1], 1, **kw)
        self.pool = nn.GlobalAvgPool2d()
        self.fc = nn.Linear(chs[-1], num_classes, **kw)

    def forward(self, x):
        x = self.maxpool(self.stem(x))
        for b in self.blocks:
            x = b(x)
        return self.fc(self.pool(self.head(x)))


def shufflenet_v2_x0_25(pretrained=False, **kw):
    return ShuffleNetV2(0.25, **kw)


def shufflenet_v2_x0_33(pretrained=False, **kw):
    return ShuffleNetV2(0.33, **kw)


def shufflenet_v2_x0_5(pretrained=False, **kw):
    return ShuffleNetV2(0.5, **kw)


def shufflenet_v2_x1_0(pretrained=False, **kw):
    return ShuffleNetV2(1.0, **kw)


def shufflenet_v2_x1_5(pretrained=False, **kw):
    return ShuffleNetV2(1.5, **kw)


def shufflenet_v2_x2_0(pretrained=False, **kw):
    return ShuffleNetV2(2.0, **kw)
