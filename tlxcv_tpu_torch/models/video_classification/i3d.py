"""Inception I3D (counterpart of
``tlxcv_tpu/models/video_classification/i3d.py``), NDHWC clips
``[B, T, H, W, C]`` in, per-frame logits ``[B, T/8, classes]`` out.

Every conv is ``nn.Conv3d`` at "SAME" (lax's rule: the stem's 7x7x7 at
stride 2 pads (2, 3) on an even side); BatchNorm takes eps 1e-3 and keeps
0.99 of its running statistics a step, over 5-D inputs.
"""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...device import resolve_device

__all__ = ["InceptionI3d", "Unit3D", "InceptionModule"]


class Unit3D(tnn.Module):
    def __init__(self, cin, cout, kernel_shape=(1, 1, 1), stride=(1, 1, 1),
                 activation="relu", use_batch_norm=True, use_bias=False,
                 device=None, generator=None):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, kernel_shape, stride=stride,
                              padding="SAME", bias=use_bias, device=device,
                              generator=generator)
        self.bn = (nn.BatchNorm(cout, eps=1e-3, momentum=0.99, device=device)
                   if use_batch_norm else None)
        self.act = nn.get_activation(activation) if activation else None

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.act is not None:
            x = self.act(x)
        return x


class InceptionModule(tnn.Module):
    def __init__(self, cin, out_channels, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        b0, b1a, b1b, b2a, b2b, b3b = out_channels
        self.b0 = Unit3D(cin, b0, **kw)
        self.b1a = Unit3D(cin, b1a, **kw)
        self.b1b = Unit3D(b1a, b1b, (3, 3, 3), **kw)
        self.b2a = Unit3D(cin, b2a, **kw)
        self.b2b = Unit3D(b2a, b2b, (3, 3, 3), **kw)
        self.b3a = nn.MaxPool3d(3, 1, 1)
        self.b3b = Unit3D(cin, b3b, **kw)
        self.out_channels = b0 + b1b + b2b + b3b

    def forward(self, x):
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)),
                          self.b2b(self.b2a(x)), self.b3b(self.b3a(x))], -1)


class InceptionI3d(tnn.Module):
    """Input [B, T, H, W, C]; returns per-frame logits [B, T', classes]
    (T' = T/8 for T a multiple of 8).  ``device=None`` builds on the CUDA
    card."""

    def __init__(self, num_classes=400, in_channels=3, dropout_keep_prob=0.5,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.conv1 = Unit3D(in_channels, 64, (7, 7, 7), (2, 2, 2), **kw)
        self.pool1 = nn.MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1))
        self.conv2b = Unit3D(64, 64, **kw)
        self.conv2c = Unit3D(64, 192, (3, 3, 3), **kw)
        self.pool2 = nn.MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1))
        self.mixed_3b = InceptionModule(192, (64, 96, 128, 16, 32, 32), **kw)
        self.mixed_3c = InceptionModule(256, (128, 128, 192, 32, 96, 64),
                                        **kw)
        self.pool3 = nn.MaxPool3d(3, 2, 1)
        self.mixed_4b = InceptionModule(480, (192, 96, 208, 16, 48, 64), **kw)
        self.mixed_4c = InceptionModule(512, (160, 112, 224, 24, 64, 64),
                                        **kw)
        self.mixed_4d = InceptionModule(512, (128, 128, 256, 24, 64, 64),
                                        **kw)
        self.mixed_4e = InceptionModule(512, (112, 144, 288, 32, 64, 64),
                                        **kw)
        self.mixed_4f = InceptionModule(528, (256, 160, 320, 32, 128, 128),
                                        **kw)
        self.pool4 = nn.MaxPool3d((2, 2, 2), (2, 2, 2))
        self.mixed_5b = InceptionModule(832, (256, 160, 320, 32, 128, 128),
                                        **kw)
        self.mixed_5c = InceptionModule(832, (384, 192, 384, 48, 128, 128),
                                        **kw)
        self.dropout = nn.Dropout(1.0 - dropout_keep_prob)
        self.logits = Unit3D(1024, num_classes, use_batch_norm=False,
                             use_bias=True, activation=None, **kw)

    def forward(self, x):
        x = self.pool1(self.conv1(x))
        x = self.pool2(self.conv2c(self.conv2b(x)))
        x = self.mixed_3c(self.mixed_3b(x))
        x = self.pool3(x)
        x = self.mixed_4f(self.mixed_4e(self.mixed_4d(
            self.mixed_4c(self.mixed_4b(x)))))
        x = self.pool4(x)
        x = self.mixed_5c(self.mixed_5b(x))
        # the spatial mean, time kept: summed in f32, as jnp.mean sums a
        # bf16 tensor, then back to the activations' dtype
        x = x.float().mean((2, 3), keepdim=True).to(x.dtype)
        x = self.dropout(x)
        return self.logits(x)[:, :, 0, 0, :]  # [B, T', classes]
