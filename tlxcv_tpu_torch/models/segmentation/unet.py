"""UNet with valid padding and crop-concat skips (counterpart of
``tlxcv_tpu/models/segmentation/unet.py``), NHWC.  At depth 3 the output is
40 px smaller than the input on each axis; an input whose halvings stay
whole keeps every crop centred."""
from __future__ import annotations

import math

import torch
from torch import nn as tnn

from ... import nn
from ...core import init as I
from ...device import resolve_device

__all__ = ["Unet", "unet", "crop_concat"]


def _filters(layer_idx, filters_root):
    return 2 ** layer_idx * filters_root


def _trunc_init(filters, kernel_size):
    std = math.sqrt(2 / (kernel_size ** 2 * filters))
    return lambda shape, **kw: I.truncated_normal(shape, std=std, **kw)


class ConvBlock(tnn.Module):
    def __init__(self, in_ch, layer_idx, filters_root, kernel_size,
                 dropout_rate, padding, activation, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        f = _filters(layer_idx, filters_root)
        pad = 0 if padding.upper() == "VALID" else kernel_size // 2
        self.conv1 = nn.Conv2d(in_ch, f, kernel_size, padding=pad,
                               w_init=_trunc_init(f, kernel_size), **kw)
        self.drop1 = nn.Dropout(dropout_rate)
        self.conv2 = nn.Conv2d(f, f, kernel_size, padding=pad,
                               w_init=_trunc_init(f, kernel_size), **kw)
        self.drop2 = nn.Dropout(dropout_rate)
        self.act = nn.get_activation(activation)
        self.out_ch = f

    def forward(self, x):
        x = self.act(self.drop1(self.conv1(x)))
        return self.act(self.drop2(self.conv2(x)))


class UpconvBlock(tnn.Module):
    def __init__(self, in_ch, layer_idx, filters_root, kernel_size, pool_size,
                 activation, device=None, generator=None):
        super().__init__()
        f = _filters(layer_idx + 1, filters_root)
        self.upconv = nn.ConvTranspose2d(in_ch, f // 2, pool_size,
                                         stride=pool_size,
                                         w_init=_trunc_init(f, kernel_size),
                                         device=device, generator=generator)
        self.act = nn.get_activation(activation)
        self.out_ch = f // 2

    def forward(self, x):
        return self.act(self.upconv(x))


def crop_concat(x, down_layer):
    """Centre-crop the skip connection to x's spatial size, then concat the
    two on the channel axis (skip first), NHWC."""
    hd = (down_layer.shape[1] - x.shape[1]) // 2
    wd = (down_layer.shape[2] - x.shape[2]) // 2
    cropped = down_layer[:, hd:hd + x.shape[1], wd:wd + x.shape[2], :]
    return torch.cat([cropped, x], -1)


class Unet(tnn.Module):
    def __init__(self, nx=172, ny=172, channels=1, num_classes=2,
                 layer_depth=3, filters_root=64, kernel_size=3, pool_size=2,
                 dropout_rate=0.5, padding="VALID", activation="relu",
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        dev = dict(device=device, generator=generator)
        self.layer_depth = layer_depth
        self.num_classes = num_classes
        kw = dict(filters_root=filters_root, kernel_size=kernel_size,
                  dropout_rate=dropout_rate, padding=padding,
                  activation=activation, **dev)

        down, pools = [], []
        cin = channels
        for li in range(layer_depth - 1):
            blk = ConvBlock(cin, li, **kw)
            down.append(blk)
            pools.append(nn.MaxPool2d(pool_size, pool_size))
            cin = blk.out_ch
        self.down_blocks = tnn.ModuleList(down)
        self.pools = tnn.ModuleList(pools)
        self.bottleneck = ConvBlock(cin, layer_depth - 1, **kw)
        cin = self.bottleneck.out_ch

        ups, decs = [], []  # deepest first: layer_depth - 2 .. 0
        for li in range(layer_depth - 2, -1, -1):
            up = UpconvBlock(cin, li, filters_root, kernel_size, pool_size,
                             activation, **dev)
            ups.append(up)
            dec = ConvBlock(up.out_ch + down[li].out_ch, li, **kw)
            decs.append(dec)
            cin = dec.out_ch
        self.up_blocks = tnn.ModuleList(ups)
        self.dec_blocks = tnn.ModuleList(decs)

        self.head = nn.Conv2d(cin, num_classes, 1,
                              w_init=_trunc_init(filters_root, kernel_size),
                              **dev)
        self.act = nn.get_activation(activation)

    def forward(self, x):
        skips = []
        for blk, pool in zip(self.down_blocks, self.pools):
            x = blk(x)
            skips.append(x)
            x = pool(x)
        x = self.bottleneck(x)
        for i, (up, dec) in enumerate(zip(self.up_blocks, self.dec_blocks)):
            x = dec(crop_concat(up(x), skips[self.layer_depth - 2 - i]))
        return self.act(self.head(x))


def unet(**kwargs):
    return Unet(**kwargs)
