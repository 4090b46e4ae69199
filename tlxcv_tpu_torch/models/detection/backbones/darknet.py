"""DarkNet-53 backbone, NHWC (counterpart of
``tlxcv_tpu/models/detection/backbones/darknet.py``), with the JAX
package's attribute names so that ``utils.bridge`` needs no name table."""
from __future__ import annotations

from torch import nn as tnn

from .... import nn

__all__ = ["BasicBlock", "Blocks", "ConvBNLayer", "DarkNet", "DownSample",
           "darknet53"]


class ConvBNLayer(tnn.Module):
    """Conv (no bias), BatchNorm, then leaky ReLU at slope 0.1 (``act=
    "leaky"``) or any activation ``nn.get_activation`` knows."""

    def __init__(self, ch_in, ch_out, filter_size=3, stride=1, padding=0,
                 groups=1, act="leaky", device=None, generator=None):
        super().__init__()
        self.conv = nn.Conv2d(ch_in, ch_out, filter_size, stride=stride,
                              padding=padding, groups=groups, bias=False,
                              device=device, generator=generator)
        self.bn = nn.BatchNorm(ch_out, device=device)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        if self.act == "leaky":
            return nn.leaky_relu(x, 0.1)
        return nn.get_activation(self.act)(x)


class DownSample(tnn.Module):
    def __init__(self, ch_in, ch_out, device=None, generator=None):
        super().__init__()
        self.conv = ConvBNLayer(ch_in, ch_out, 3, stride=2, padding=1,
                                device=device, generator=generator)

    def forward(self, x):
        return self.conv(x)


class BasicBlock(tnn.Module):
    def __init__(self, ch_in, ch_out, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv1 = ConvBNLayer(ch_in, ch_out, 1, padding=0, **kw)
        self.conv2 = ConvBNLayer(ch_out, ch_out * 2, 3, padding=1, **kw)

    def forward(self, x):
        return x + self.conv2(self.conv1(x))


class Blocks(tnn.Module):
    def __init__(self, ch_in, ch_out, count, device=None, generator=None):
        super().__init__()
        self.blocks = tnn.ModuleList(
            [BasicBlock(ch_in if i == 0 else ch_out * 2, ch_out,
                        device=device, generator=generator)
             for i in range(count)])

    def forward(self, x):
        for b in self.blocks:
            x = b(x)
        return x


class DarkNet(tnn.Module):
    """Returns the feature maps of stages ``return_idx`` (default C3, C4,
    C5: strides 8, 16, 32)."""

    def __init__(self, depth=53, return_idx=(2, 3, 4), device=None,
                 generator=None):
        super().__init__()
        if depth != 53:
            raise ValueError(f"DarkNet depth {depth}: only 53 is defined")
        kw = dict(device=device, generator=generator)
        stages = (1, 2, 8, 8, 4)
        self.return_idx = tuple(return_idx)
        self.conv0 = ConvBNLayer(3, 32, 3, padding=1, **kw)
        self.downsample0 = DownSample(32, 64, **kw)
        self.stages = tnn.ModuleList()
        self.downsamples = tnn.ModuleList()
        ch_in = 64
        for i, count in enumerate(stages):
            out = 32 * (2 ** i)
            self.stages.append(Blocks(ch_in, out, count, **kw))
            ch_in = out * 2
            if i < len(stages) - 1:
                self.downsamples.append(DownSample(ch_in, ch_in * 2, **kw))
                ch_in = ch_in * 2
        self.out_channels = [64 * (2 ** i) for i in self.return_idx]

    def forward(self, x):
        x = self.downsample0(self.conv0(x))
        outs = []
        for i, stage in enumerate(self.stages):
            x = stage(x)
            if i in self.return_idx:
                outs.append(x)
            if i < len(self.stages) - 1:
                x = self.downsamples[i](x)
        return outs


def darknet53(**kwargs):
    return DarkNet(depth=53, **kwargs)
