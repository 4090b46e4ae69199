"""FastFCN: joint pyramid upsampling and the context-encoding head
(counterpart of ``tlxcv_tpu/models/segmentation/fastfcn.py``), NHWC."""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...core import init as I
from ...device import full_f32, resolve_device
from ...ops.image import interpolate
from ..backbones.resnet_vd import resnet50_vd
from .layers import AuxLayer, ConvBNReLU, SeparableConvBNReLU

__all__ = ["FastFCN", "fastfcn", "JPU", "Encoding", "EncModule", "EncHead"]


class JPU(tnn.Module):
    """Joint pyramid upsampling over C3..C5: each projected, resized to
    C3's size (an identity where a dilated backbone keeps one stride),
    concatenated and run through four dilated separable convs."""

    def __init__(self, in_channels, width=512, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.convs = tnn.ModuleList([ConvBNReLU(ch, width, 3, **kw)
                                     for ch in in_channels])
        rates = (1, 2, 4, 8)
        self.dilations = tnn.ModuleList([
            SeparableConvBNReLU(3 * width, width, 3, dilation=r, **kw)
            for r in rates])
        self.out_channels = width * len(rates)

    def forward(self, feats):
        feats = [conv(f) for conv, f in zip(self.convs, feats)]
        size = feats[0].shape[1:3]
        x = torch.cat([feats[0]] + [interpolate(f, size=size, mode="bilinear")
                                    for f in feats[1:]], -1)
        return torch.cat([d(x) for d in self.dilations], -1)


class Encoding(tnn.Module):
    """Learned codebook encoding: each pixel softly assigned to K
    codewords, softmax over the codes of ``scale_k * |x - c_k|^2``, and the
    assigned residuals summed over the pixels: ``E_k = sum_n A_nk (x_n -
    c_k)``, [N, K, C].

    The reference builds the residuals [N, HW, K, C] (537 M elements an
    image at EncNet's 1024x2048 frame).  This computes the same function
    expanded, with no such tensor: ``|x - c|^2 = |x|^2 - 2 x.c + |c|^2`` and
    ``E = A^T x - (sum_n A) c``, in f32 (TF32 off) whatever the input
    dtype (float64 in float64, a CPU reference); the output in the type
    the reference's arithmetic promotes to."""

    def __init__(self, channels, num_codes=32, device=None, generator=None):
        super().__init__()
        std = 1.0 / ((num_codes * channels) ** 0.5)
        kw = dict(generator=generator, device=resolve_device(device))
        self.codewords = tnn.Parameter(
            I.uniform((num_codes, channels), -std, std, **kw))
        self.scale = tnn.Parameter(I.uniform((num_codes,), -1, 0, **kw))
        self.num_codes = num_codes

    def forward(self, x):
        n, h, w, c = x.shape
        out_dtype = torch.promote_types(x.dtype, self.codewords.dtype)
        acc = torch.float64 if out_dtype == torch.float64 else torch.float32
        flat = x.reshape(n, h * w, c).to(acc)
        cw = self.codewords.to(acc)
        with full_f32():
            d2 = ((flat * flat).sum(-1, keepdim=True) - 2 * flat @ cw.T
                  + (cw * cw).sum(-1))                       # [N, HW, K]
            assign = torch.softmax(self.scale.to(acc) * d2, -1)
            enc = assign.transpose(1, 2) @ flat \
                - assign.sum(1)[..., None] * cw              # [N, K, C]
        return enc.to(out_dtype)


class EncModule(tnn.Module):
    """1x1 projection, Encoding, BatchNorm over the K codes, ReLU, the mean
    over codes, and a sigmoid channel gate applied as ``relu(x + x *
    gamma)``; returns the encoded feature and the gated map."""

    def __init__(self, in_channels, num_codes=32, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.encoding_project = ConvBNReLU(in_channels, in_channels, 1,
                                           padding=0, **kw)
        self.encoding = Encoding(in_channels, num_codes, **kw)
        self.enc_bn = nn.BatchNorm(num_codes, device=device)
        self.fc = nn.Linear(in_channels, in_channels, **kw)

    def forward(self, x):
        en = self.encoding(self.encoding_project(x))     # [N, K, C]
        en = nn.relu(self.enc_bn(en.transpose(1, 2)).transpose(1, 2))
        feat = en.mean(1)                                # [N, C]
        gamma = torch.sigmoid(self.fc(feat))
        return feat, nn.relu(x + x * gamma[:, None, None, :])


class EncHead(tnn.Module):
    """Bottleneck (1x1 after JPU, else 3x3), EncModule and the classifier;
    with ``use_se_loss`` also the semantic-encoding logits [N, classes]."""

    def __init__(self, in_channels, num_classes, num_codes=32, mid=512,
                 from_jpu=False, use_se_loss=True, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        if from_jpu:
            self.bottleneck = ConvBNReLU(in_channels, mid, 1, padding=0, **kw)
        else:
            self.bottleneck = ConvBNReLU(in_channels, mid, 3, **kw)
        self.enc_module = EncModule(mid, num_codes, **kw)
        self.cls = nn.Conv2d(mid, num_classes, 1, **kw)
        self.se_layer = (nn.Linear(mid, num_classes, **kw) if use_se_loss
                         else None)

    def forward(self, x):
        feat, out = self.enc_module(self.bottleneck(x))
        logits = self.cls(out)
        if self.se_layer is not None:
            return logits, self.se_layer(feat)
        return logits


class FastFCN(tnn.Module):
    """Logits at the input's size.  In training with
    ``enable_auxiliary_loss``, the list of those, the auxiliary head's
    logits over C4 and (with ``use_se_loss``) the semantic-encoding
    logits."""

    def __init__(self, num_classes=19, backbone=None, num_codes=32,
                 enable_auxiliary_loss=False, use_se_loss=True, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.backbone = backbone if backbone is not None else resnet50_vd(
            output_stride=32, **kw)
        chs = self.backbone.feat_channels[1:]  # C3, C4, C5
        self.jpu = JPU(chs, width=512, **kw)
        self.head = EncHead(self.jpu.out_channels, num_classes, num_codes,
                            from_jpu=True, use_se_loss=use_se_loss, **kw)
        self.aux = (AuxLayer(chs[1], 256, num_classes, **kw)
                    if enable_auxiliary_loss else None)
        self.enable_aux = enable_auxiliary_loss

    def forward(self, x):
        size = x.shape[1:3]
        feats = self.backbone(x)[1:]
        head_out = self.head(self.jpu(feats))
        logits, se = head_out if isinstance(head_out, tuple) \
            else (head_out, None)
        logits = interpolate(logits, size=size, mode="bilinear")
        if self.training and self.enable_aux:
            outs = [logits, interpolate(self.aux(feats[1]), size=size,
                                        mode="bilinear")]
            return outs + ([se] if se is not None else [])
        return logits


def fastfcn(num_classes=19, **kw):
    return FastFCN(num_classes=num_classes, **kw)
