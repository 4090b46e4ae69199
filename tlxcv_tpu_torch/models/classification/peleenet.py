"""PeleeNet and HarDNet-39/68/85 (counterpart of
``tlxcv_tpu/models/classification/peleenet.py``), NHWC."""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...device import resolve_device

__all__ = ["PeleeNet", "peleenet", "HarDNet", "hardnet68", "hardnet85",
           "hardnet39", "CombConv", "hard_links"]


class ConvBNReLU(tnn.Module):
    def __init__(self, cin, cout, k=3, stride=1, act=True, device=None,
                 generator=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                              bias=False, device=device, generator=generator)
        self.bn = nn.BatchNorm(cout, device=device)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return nn.relu(x) if self.act else x


class CombConv(tnn.Module):
    """Depthwise-separable layer of HarDNet's depthwise variant: a 1x1
    pointwise conv, then a depthwise conv and BatchNorm."""

    def __init__(self, cin, cout, k=3, stride=1, device=None,
                 generator=None):
        super().__init__()
        self.pw = ConvBNReLU(cin, cout, 1, device=device, generator=generator)
        self.dw = nn.Conv2d(cout, cout, k, stride=stride, padding=k // 2,
                            groups=cout, bias=False, device=device,
                            generator=generator)
        self.dw_bn = nn.BatchNorm(cout, device=device)

    def forward(self, x):
        return self.dw_bn(self.dw(self.pw(x)))


class StemBlock(tnn.Module):
    def __init__(self, out=32, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.c1 = ConvBNReLU(3, out, 3, 2, **kw)
        self.left = nn.Sequential(ConvBNReLU(out, out // 2, 1, **kw),
                                  ConvBNReLU(out // 2, out, 3, 2, **kw))
        self.right = nn.MaxPool2d(2, 2)
        self.fuse = ConvBNReLU(out * 2, out, 1, **kw)

    def forward(self, x):
        x = self.c1(x)
        return self.fuse(torch.cat([self.left(x), self.right(x)], -1))


class TwoWayDense(tnn.Module):
    def __init__(self, cin, growth, bottleneck_width, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        mid = growth * bottleneck_width // 2
        self.a = nn.Sequential(ConvBNReLU(cin, mid, 1, **kw),
                               ConvBNReLU(mid, growth // 2, 3, **kw))
        self.b = nn.Sequential(ConvBNReLU(cin, mid, 1, **kw),
                               ConvBNReLU(mid, growth // 2, 3, **kw),
                               ConvBNReLU(growth // 2, growth // 2, 3, **kw))

    def forward(self, x):
        return torch.cat([x, self.a(x), self.b(x)], -1)


class PeleeNet(tnn.Module):
    def __init__(self, num_classes=1000, growth=32, block_cfg=(3, 4, 8, 6),
                 bw=(1, 2, 4, 4), device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.stem = StemBlock(32, **kw)
        blocks = []
        cin = 32
        for si, (n, w) in enumerate(zip(block_cfg, bw)):
            for _ in range(n):
                blocks.append(TwoWayDense(cin, growth, w, **kw))
                cin += growth
            blocks.append(ConvBNReLU(cin, cin, 1, **kw))
            if si < len(block_cfg) - 1:
                blocks.append(nn.AvgPool2d(2, 2))
        self.blocks = tnn.ModuleList(blocks)
        self.pool = nn.GlobalAvgPool2d()
        self.drop = nn.Dropout(0.05, generator=generator)
        self.fc = nn.Linear(cin, num_classes, **kw)

    def forward(self, x):
        x = self.stem(x)
        for b in self.blocks:
            x = b(x)
        return self.fc(self.drop(self.pool(x)))


def peleenet(pretrained=False, **kw):
    return PeleeNet(**kw)


def hard_links(i):
    """Layer ``i`` (from 1) of a harmonic dense block: the power ``j`` of
    the largest power of two dividing ``i``, and the earlier outputs it
    reads, ``i - 2^p`` for p = 0..j (output 0 is the block's input)."""
    j = 0
    while i % (2 ** (j + 1)) == 0:
        j += 1
    return j, sorted({i - 2 ** p for p in range(j + 1) if i - 2 ** p >= 0})


class HarDBlock(tnn.Module):
    """Harmonic dense block: layer i reads the outputs ``hard_links(i)``
    and grows ``growth * grmul^j`` channels (rounded down to even); the
    block returns its odd layers' outputs and its last one's."""

    def __init__(self, cin, growth, grmul, n_layers, depthwise=False,
                 device=None, generator=None):
        super().__init__()
        self.links = []
        layers = []
        self.out_channels = 0
        chs = [cin]
        for i in range(1, n_layers + 1):
            j, links = hard_links(i)
            ch = int(int(growth * (grmul ** j) / 2) * 2)
            layers.append((CombConv if depthwise else ConvBNReLU)(
                sum(chs[k] for k in links), ch, 3, device=device,
                generator=generator))
            self.links.append(links)
            chs.append(ch)
            if i == n_layers or i % 2 == 1:
                self.out_channels += ch
        self.layers = tnn.ModuleList(layers)
        self.n_layers = n_layers

    def forward(self, x):
        feats = [x]
        for layer, links in zip(self.layers, self.links):
            inp = torch.cat([feats[k] for k in links], -1) \
                if len(links) > 1 else feats[links[0]]
            feats.append(layer(inp))
        return torch.cat([feats[i] for i in range(1, self.n_layers + 1)
                          if i == self.n_layers or i % 2 == 1], -1)


class HarDNet(tnn.Module):
    """Defaults: the HarDNet-68 configuration."""

    def __init__(self, num_classes=1000, first_ch=(32, 64),
                 ch_list=(128, 256, 320, 640), gr=(14, 16, 20, 40),
                 n_layers=(8, 16, 16, 16), downsample=(1, 0, 1, 1),
                 grmul=1.7, depthwise=False, drop=0.1, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        if depthwise:
            self.stem = nn.Sequential(
                ConvBNReLU(3, first_ch[0], 3, 2, **kw),
                CombConv(first_ch[0], first_ch[1], 3, stride=2, **kw))
        else:
            self.stem = nn.Sequential(
                ConvBNReLU(3, first_ch[0], 3, 2, **kw),
                ConvBNReLU(first_ch[0], first_ch[1], 3, **kw),
                nn.MaxPool2d(3, 2, 1))
        blocks = []
        cin = first_ch[1]
        for i in range(len(ch_list)):
            blk = HarDBlock(cin, gr[i], grmul, n_layers[i],
                            depthwise=depthwise, **kw)
            blocks.append(blk)
            blocks.append(ConvBNReLU(blk.out_channels, ch_list[i], 1, **kw))
            cin = ch_list[i]
            if downsample[i]:
                blocks.append(CombConv(cin, cin, 3, stride=2, **kw)
                              if depthwise else nn.MaxPool2d(2, 2))
        self.blocks = tnn.ModuleList(blocks)
        self.pool = nn.GlobalAvgPool2d()
        self.drop = nn.Dropout(drop, generator=generator)
        self.fc = nn.Linear(cin, num_classes, **kw)

    def forward(self, x):
        x = self.stem(x)
        for b in self.blocks:
            x = b(x)
        return self.fc(self.drop(self.pool(x)))


def hardnet68(pretrained=False, **kw):
    return HarDNet(**kw)


def hardnet85(pretrained=False, **kw):
    return HarDNet(first_ch=(48, 96), ch_list=(192, 256, 320, 480, 720),
                   gr=(24, 24, 28, 36, 48), n_layers=(8, 16, 16, 16, 16),
                   downsample=(1, 0, 1, 0, 1), grmul=1.7, drop=0.2, **kw)


def hardnet39(pretrained=False, **kw):
    # the depthwise-separable variant
    return HarDNet(first_ch=(24, 48), ch_list=(96, 320, 640),
                   gr=(16, 20, 64), n_layers=(4, 16, 8),
                   downsample=(1, 1, 0), grmul=1.6, depthwise=True,
                   drop=0.05, **kw)
