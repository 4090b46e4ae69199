"""ReXNet 1.0 and 1.3 (counterpart of
``tlxcv_tpu/models/classification/rexnet.py``), NHWC.  A block whose
stride is 1 and whose width does not shrink adds its input onto its first
``cin`` output channels (``channel_pad_add``)."""
from __future__ import annotations

from math import ceil

import torch
import torch.nn.functional as F
from torch import nn as tnn

from ... import nn
from ...device import resolve_device

__all__ = ["ReXNet", "rexnet_1_0", "rexnet_1_3", "channel_pad_add"]


def channel_pad_add(out, x):
    """``out`` plus ``x`` zero-padded on its channels to ``out``'s."""
    return out + F.pad(x, (0, out.shape[-1] - x.shape[-1]))


class SE(tnn.Module):
    def __init__(self, ch, se_ratio=12, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        mid = ch // se_ratio
        self.fc1 = nn.Conv2d(ch, mid, 1, **kw)
        self.bn = nn.BatchNorm(mid, device=device)
        self.fc2 = nn.Conv2d(mid, ch, 1, **kw)

    def forward(self, x):
        s = x.mean((1, 2), keepdim=True)
        s = nn.relu(self.bn(self.fc1(s)))
        return x * torch.sigmoid(self.fc2(s))


class LinearBottleneck(tnn.Module):
    def __init__(self, cin, cout, t, stride, use_se=True, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.use_shortcut = stride == 1 and cin <= cout
        self.cin = cin
        layers = []
        ch = cin
        if t != 1:
            dw_ch = cin * t
            layers += [nn.Conv2d(cin, dw_ch, 1, bias=False, **kw),
                       nn.BatchNorm(dw_ch, device=device),
                       nn.Activation("silu")]
            ch = dw_ch
        layers += [nn.Conv2d(ch, ch, 3, stride=stride, padding=1, groups=ch,
                             bias=False, **kw),
                   nn.BatchNorm(ch, device=device)]
        self.body = nn.Sequential(*layers)
        self.se = SE(ch, **kw) if use_se else None
        self.act = nn.Activation("relu6")
        self.proj = nn.Sequential(nn.Conv2d(ch, cout, 1, bias=False, **kw),
                                  nn.BatchNorm(cout, device=device))
        self.cout = cout

    def forward(self, x):
        out = self.body(x)
        if self.se is not None:
            out = self.se(out)
        out = self.proj(self.act(out))
        return channel_pad_add(out, x) if self.use_shortcut else out


class ReXNet(tnn.Module):
    def __init__(self, width_mult=1.0, depth_mult=1.0, num_classes=1000,
                 use_se=True, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        layers = [ceil(n * depth_mult) for n in (1, 2, 2, 3, 3, 5)]
        strides = [1, 2, 2, 2, 1, 2]
        depth = sum(layers)
        stem_ch = 32 / width_mult if width_mult < 1.0 else 32
        inplanes = 16 / width_mult if width_mult < 1.0 else 16
        final_ch = 180
        stem_out = int(round(stem_ch * width_mult))
        self.stem = nn.Sequential(
            nn.Conv2d(3, stem_out, 3, stride=2, padding=1, bias=False, **kw),
            nn.BatchNorm(stem_out, device=device), nn.Activation("silu"))
        strides_full = sum([[s] + [1] * (n - 1)
                            for s, n in zip(strides, layers)], [])
        ts = [1] * layers[0] + [6] * (depth - layers[0])
        blocks = []
        cin = stem_out
        cur = inplanes
        for i, (t, s) in enumerate(zip(ts, strides_full)):
            cout = int(round(cur * width_mult))
            blocks.append(LinearBottleneck(cin, cout, t, s,
                                           use_se=use_se and i > layers[0],
                                           **kw))
            cin = cout
            cur += final_ch / depth
        self.blocks = tnn.ModuleList(blocks)
        pen = int(1280 * max(1.0, width_mult))
        self.head = nn.Sequential(nn.Conv2d(cin, pen, 1, bias=False, **kw),
                                  nn.BatchNorm(pen, device=device),
                                  nn.Activation("silu"))
        self.pool = nn.GlobalAvgPool2d()
        self.drop = nn.Dropout(0.2, generator=generator)
        self.fc = nn.Linear(pen, num_classes, **kw)

    def forward(self, x):
        x = self.stem(x)
        for b in self.blocks:
            x = b(x)
        return self.fc(self.drop(self.pool(self.head(x))))


def rexnet_1_0(pretrained=False, **kw):
    return ReXNet(1.0, **kw)


def rexnet_1_3(pretrained=False, **kw):
    return ReXNet(1.3, **kw)
