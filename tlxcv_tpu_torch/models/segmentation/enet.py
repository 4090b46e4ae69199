"""ENet (counterpart of ``tlxcv_tpu/models/segmentation/enet.py``), NHWC:
the initial block, bottlenecks (regular, down, up, dilated, asymmetric)
and a transposed-conv head.  The down blocks pool with their argmax, and
the up blocks scatter through those indices (``ops.image``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn as tnn

from ... import nn
from ...device import resolve_device
from ...ops.image import max_pool2d_with_argmax, max_unpool2d

__all__ = ["ENet"]


class InitialBlock(tnn.Module):
    def __init__(self, cin=3, cout=16, device=None, generator=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout - cin, 3, stride=2, padding=1,
                              bias=False, device=device, generator=generator)
        self.bn = nn.BatchNorm(cout, device=device)
        self.pool = nn.MaxPool2d(2, 2)

    def forward(self, x):
        out = torch.cat([self.conv(x), self.pool(x)], -1)
        return nn.relu(self.bn(out))


class Bottleneck(tnn.Module):
    def __init__(self, cin, cout, internal_ratio=4, kind="regular",
                 dilation=1, kernel_size=3, dropout=0.1, device=None,
                 generator=None):
        super().__init__()
        kw = dict(bias=False, device=device, generator=generator)
        mid = cin // internal_ratio
        self.kind = kind
        down = kind == "down"
        self.conv1 = nn.Conv2d(cin, mid, 2 if down else 1,
                               stride=2 if down else 1, **kw)
        self.bn1 = nn.BatchNorm(mid, device=device)
        if kind == "asymmetric":
            self.conv2a = nn.Conv2d(mid, mid, (kernel_size, 1),
                                    padding=(kernel_size // 2, 0), **kw)
            self.bn2a = nn.BatchNorm(mid, device=device)
            self.conv2 = nn.Conv2d(mid, mid, (1, kernel_size),
                                   padding=(0, kernel_size // 2), **kw)
        elif kind == "up":
            self.conv2 = nn.ConvTranspose2d(mid, mid, 2, stride=2, **kw)
        else:
            self.conv2 = nn.Conv2d(mid, mid, kernel_size,
                                   padding=dilation * (kernel_size // 2),
                                   dilation=dilation, **kw)
        self.bn2 = nn.BatchNorm(mid, device=device)
        self.conv3 = nn.Conv2d(mid, cout, 1, **kw)
        self.bn3 = nn.BatchNorm(cout, device=device)
        self.drop = nn.Dropout(dropout)
        self.cin, self.cout = cin, cout
        if kind == "up":
            self.main_conv = nn.Conv2d(cin, cout, 1, **kw)
            self.main_bn = nn.BatchNorm(cout, device=device)

    def forward(self, x, indices=None, output_hw=None):
        """A down block returns (output, its pool's argmax indices); an up
        block takes a down block's indices and its input's size."""
        out = nn.relu(self.bn1(self.conv1(x)))
        if self.kind == "asymmetric":
            out = nn.relu(self.bn2a(self.conv2a(out)))
        out = nn.relu(self.bn2(self.conv2(out)))
        out = self.drop(self.bn3(self.conv3(out)))
        if self.kind == "down":
            main, idx = max_pool2d_with_argmax(x, 2, 2)
            if self.cout > self.cin:  # zero channels on the main branch
                main = F.pad(main, (0, self.cout - self.cin))
            return nn.relu(main + out), idx
        if self.kind == "up":
            main = max_unpool2d(self.main_bn(self.main_conv(x)), indices,
                                output_hw)
            return nn.relu(main + out)
        return nn.relu(x + out)


def _stage(device, generator):
    """Stage 2's and stage 3's eight 128-channel bottlenecks."""
    kw = dict(device=device, generator=generator)
    return tnn.ModuleList([
        Bottleneck(128, 128, **kw),
        Bottleneck(128, 128, dilation=2, kind="dilated", **kw),
        Bottleneck(128, 128, kind="asymmetric", kernel_size=5, **kw),
        Bottleneck(128, 128, dilation=4, kind="dilated", **kw),
        Bottleneck(128, 128, **kw),
        Bottleneck(128, 128, dilation=8, kind="dilated", **kw),
        Bottleneck(128, 128, kind="asymmetric", kernel_size=5, **kw),
        Bottleneck(128, 128, dilation=16, kind="dilated", **kw)])


class ENet(tnn.Module):
    def __init__(self, num_classes=19, encoder_relu=True, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.initial = InitialBlock(**kw)
        self.down1 = Bottleneck(16, 64, kind="down", dropout=0.01, **kw)
        self.s1 = tnn.ModuleList([Bottleneck(64, 64, dropout=0.01, **kw)
                                  for _ in range(4)])
        self.down2 = Bottleneck(64, 128, kind="down", **kw)
        self.s2 = _stage(device, generator)
        self.s3 = _stage(device, generator)
        self.up4 = Bottleneck(128, 64, kind="up", **kw)
        self.s4 = tnn.ModuleList([Bottleneck(64, 64, **kw) for _ in range(2)])
        self.up5 = Bottleneck(64, 16, kind="up", **kw)
        self.s5 = tnn.ModuleList([Bottleneck(16, 16, **kw)])
        self.final = nn.ConvTranspose2d(16, num_classes, 3, stride=2,
                                        padding=1, output_padding=1, **kw)

    def forward(self, x):
        x = self.initial(x)
        hw1 = x.shape[1:3]
        x, idx1 = self.down1(x)
        for b in self.s1:
            x = b(x)
        hw2 = x.shape[1:3]
        x, idx2 = self.down2(x)
        for b in (*self.s2, *self.s3):
            x = b(x)
        x = self.up4(x, indices=idx2[..., :64], output_hw=hw2)
        for b in self.s4:
            x = b(x)
        x = self.up5(x, indices=idx1[..., :16], output_hw=hw1)
        for b in self.s5:
            x = b(x)
        return self.final(x)
