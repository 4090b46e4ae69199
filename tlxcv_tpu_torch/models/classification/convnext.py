"""ConvNeXt (counterpart of
``tlxcv_tpu/models/classification/convnext.py``), NHWC, the layout it was
designed for.

The JAX model's attribute names, with the stages a list of lists
(``stages.2.4.pwconv1``).  The layer scale ``gamma`` starts at 1e-6.
"""
from __future__ import annotations

import numpy as np
from torch import nn as tnn

from ... import nn
from ...core import init as I
from ...device import resolve_device

__all__ = ["ConvNeXt", "convnext_tiny", "convnext_small", "convnext_base",
           "convnext_large"]

gelu = nn.get_activation("gelu")


class ConvNeXtBlock(tnn.Module):
    def __init__(self, dim, drop_path=0.0, layer_scale=1e-6, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim, **kw)
        self.norm = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.pwconv1 = nn.Linear(dim, 4 * dim, **kw)
        self.pwconv2 = nn.Linear(4 * dim, dim, **kw)
        self.gamma = (tnn.Parameter(I.constant((dim,), layer_scale,
                                               device=device))
                      if layer_scale > 0 else None)
        self.drop_path = nn.DropPath(drop_path)

    def forward(self, x):
        y = self.norm(self.dwconv(x))
        y = self.pwconv2(gelu(self.pwconv1(y)))
        if self.gamma is not None:
            y = y * self.gamma.to(y.dtype)
        return x + self.drop_path(y)


class ConvNeXt(tnn.Module):
    def __init__(self, in_chans=3, num_classes=1000, depths=(3, 3, 9, 3),
                 dims=(96, 192, 384, 768), drop_path_rate=0.0, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        downsample = [nn.Sequential(
            nn.Conv2d(in_chans, dims[0], 4, stride=4, **kw),
            nn.LayerNorm(dims[0], eps=1e-6, device=device))]
        for i in range(3):
            downsample.append(nn.Sequential(
                nn.LayerNorm(dims[i], eps=1e-6, device=device),
                nn.Conv2d(dims[i], dims[i + 1], 2, stride=2, **kw)))
        self.downsample = tnn.ModuleList(downsample)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.stages = tnn.ModuleList()
        di = 0
        for i, depth in enumerate(depths):
            self.stages.append(tnn.ModuleList([
                ConvNeXtBlock(dims[i], dpr[di + j], **kw)
                for j in range(depth)]))
            di += depth
        self.norm = nn.LayerNorm(dims[-1], eps=1e-6, device=device)
        self.head = nn.Linear(dims[-1], num_classes, **kw)

    def forward(self, x):
        for down, blocks in zip(self.downsample, self.stages):
            x = down(x)
            for blk in blocks:
                x = blk(x)
        return self.head(self.norm(x.mean((1, 2))))


def convnext_tiny(pretrained=False, **kw):
    return ConvNeXt(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768), **kw)


def convnext_small(pretrained=False, **kw):
    return ConvNeXt(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768), **kw)


def convnext_base(pretrained=False, **kw):
    return ConvNeXt(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024), **kw)


def convnext_large(pretrained=False, **kw):
    return ConvNeXt(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536), **kw)
