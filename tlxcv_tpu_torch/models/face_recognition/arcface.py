"""ArcFace (counterpart of
``tlxcv_tpu/models/face_recognition/arcface.py``), NHWC.

``ArcHead.weight`` is a bare ``(embed, classes)`` parameter, as the JAX
package's ``Param``, so the bridge copies it untransposed.  The embedding
flattens the backbone's last NHWC map in H, W, C order; its ``dense`` is
sized for an ``input_size // 32`` square map, so at the default 112 px,
where ResNet-50's map is 4 x 4 rather than 3 x 3, the forward fails, as
the reference's does.
"""
from __future__ import annotations

import math

import torch
from torch import nn as tnn

from ... import nn
from ...core import init as I
from ...device import resolve_device
from ...ops.losses import softmax_cross_entropy
from ..classification.resnet import ResNet

__all__ = ["ArcFace", "ArcHead", "NormHead"]


def _unit_rows(x, dim):
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + 1e-9)


class ArcHead(tnn.Module):
    def __init__(self, num_classes=10575, embed_size=128, margin=0.5,
                 logist_scale=64.0, device=None, generator=None):
        super().__init__()
        self.num_classes = num_classes
        self.margin = margin
        self.logist_scale = logist_scale
        self.weight = tnn.Parameter(I.xavier_uniform(
            (embed_size, num_classes), generator=generator,
            device=resolve_device(device)))
        self.cos_m = math.cos(margin)
        self.sin_m = math.sin(margin)
        self.th = math.cos(math.pi - margin)
        self.mm = self.sin_m * margin

    def forward(self, embeds, labels, margin=None):
        """Scaled cosine logits, the labelled class's angle widened by the
        margin: the constructor's (``margin=None``), or ``margin`` (a
        float or a tensor), as a margin warm-up schedule passes it."""
        e, w = _unit_rows(embeds, 1), _unit_rows(self.weight, 0)
        # each normalised in its own dtype, then the product in the
        # promoted one, as the reference's ``e @ w`` promotes f32
        # embeddings and bf16 weights (the Trainer's bf16 policy)
        dtype = torch.promote_types(e.dtype, w.dtype)
        cos_t = e.to(dtype) @ w.to(dtype)
        if margin is None:
            cos_m, sin_m, th, mm = self.cos_m, self.sin_m, self.th, self.mm
        else:
            margin = torch.as_tensor(margin, dtype=cos_t.dtype,
                                     device=cos_t.device)
            cos_m, sin_m = torch.cos(margin), torch.sin(margin)
            th, mm = torch.cos(math.pi - margin), sin_m * margin
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t ** 2, 0.0, 1.0))
        cos_mt = cos_t * cos_m - sin_t * sin_m
        cos_mt = torch.where(cos_t > th, cos_mt, cos_t - mm)
        target = labels.long()[:, None] == torch.arange(
            self.num_classes, device=labels.device)
        return torch.where(target, cos_mt, cos_t) * self.logist_scale


class NormHead(tnn.Module):
    def __init__(self, embed_size, num_classes, device=None, generator=None):
        super().__init__()
        self.dense = nn.Linear(embed_size, num_classes, device=device,
                               generator=generator)

    def forward(self, x):
        return self.dense(x)


class ArcFace(tnn.Module):
    def __init__(self, input_size=112, embed_size=512, logist_scale=64,
                 num_classes=10575, backbone=None, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.backbone = backbone if backbone is not None else ResNet(
            depth=50, num_classes=0, with_pool=False, **kw)
        feat_ch = self.backbone.feat_channels[-1]
        fh = input_size // 32
        self.bn = nn.BatchNorm(feat_ch, momentum=0.99, eps=1.001e-5,
                               device=device)
        self.drop = nn.Dropout(0.5)
        self.dense = nn.Linear(feat_ch * fh * fh, embed_size, **kw)
        self.bn2 = nn.BatchNorm(embed_size, momentum=0.99, eps=1.001e-5,
                                device=device)
        self.head = ArcHead(num_classes, embed_size,
                            logist_scale=logist_scale, **kw)

    def embed(self, x):
        """Unit-norm embeddings [B, embed_size] of NHWC images."""
        x = self.drop(self.bn(self.backbone.features(x)[-1]))
        x = self.bn2(self.dense(x.reshape(x.shape[0], -1)))
        return _unit_rows(x, 1)

    def forward(self, x, labels=None):
        e = self.embed(x)
        return e if labels is None else self.head(e, labels)

    def loss_fn(self, embeds, labels, margin=None):
        return softmax_cross_entropy(self.head(embeds, labels, margin=margin),
                                     labels)
