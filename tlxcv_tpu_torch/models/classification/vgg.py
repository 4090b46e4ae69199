"""VGG-11/13/16/19 (counterpart of
``tlxcv_tpu/models/classification/vgg.py``), NHWC.

The JAX model's attribute names (``features.layers.3.weight``).  The
adaptive pool's 7x7 map is flattened in H, W, C order, as the JAX model
flattens its NHWC tensor, so the bridge's first Linear lines up.
"""
from __future__ import annotations

from torch import nn as tnn

from ... import nn
from ...core import init as I
from ...device import resolve_device

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
          512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


class VGG(tnn.Module):
    def __init__(self, cfg, batch_norm=False, num_classes=1000, dropout=0.5,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        layers = []
        cin = 3
        for v in _CFGS[cfg]:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers.append(nn.Conv2d(cin, v, 3, padding=1, **kw))
                if batch_norm:
                    layers.append(nn.BatchNorm(v, device=device))
                layers.append(nn.Activation("relu"))
                cin = v
        self.features = nn.Sequential(*layers)
        self.pool = nn.AdaptiveAvgPool2d((7, 7))
        self.classifier = nn.Sequential(
            nn.Linear(512 * 7 * 7, 4096, **kw), nn.Activation("relu"),
            nn.Dropout(dropout, generator=generator),
            nn.Linear(4096, 4096, **kw), nn.Activation("relu"),
            nn.Dropout(dropout, generator=generator),
            nn.Linear(4096, num_classes,
                      w_init=lambda s, **k: I.normal(s, std=0.01, **k), **kw))

    def forward(self, x):
        x = self.pool(self.features(x))
        return self.classifier(x.reshape(x.shape[0], -1))


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return VGG("A", batch_norm, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return VGG("B", batch_norm, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return VGG("D", batch_norm, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return VGG("E", batch_norm, **kwargs)
