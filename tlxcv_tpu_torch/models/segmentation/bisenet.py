"""BiSeNet V2 (counterpart of ``tlxcv_tpu/models/segmentation/bisenet.py``):
a detail branch, a semantic branch, bilateral guided aggregation and a
segmentation head, NHWC.  The four auxiliary heads run only in training."""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...device import resolve_device
from ...ops.image import interpolate
from .layers import ConvBN, ConvBNReLU, DepthwiseConvBN

__all__ = ["BiSeNetV2"]


class StemBlock(tnn.Module):
    def __init__(self, cin, cout, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv = ConvBNReLU(cin, cout, 3, stride=2, **kw)
        self.left = nn.Sequential(
            ConvBNReLU(cout, cout // 2, 1, padding=0, **kw),
            ConvBNReLU(cout // 2, cout, 3, stride=2, **kw))
        self.right = nn.MaxPool2d(3, 2, 1)
        self.fuse = ConvBNReLU(cout * 2, cout, 3, **kw)

    def forward(self, x):
        x = self.conv(x)
        return self.fuse(torch.cat([self.left(x), self.right(x)], -1))


class GatherExpand(tnn.Module):
    def __init__(self, cin, cout, stride=1, expand=6, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        mid = cin * expand
        self.stride = stride
        self.conv1 = ConvBNReLU(cin, cin, 3, **kw)
        if stride == 2:
            self.dw1 = DepthwiseConvBN(cin, 3, stride=2, **kw)
            self.shortcut = nn.Sequential(
                DepthwiseConvBN(cin, 3, stride=2, **kw),
                ConvBN(cin, cout, 1, padding=0, **kw))
        self.dw_mid = nn.Sequential(
            nn.Conv2d(cin, mid, 1, bias=False, **kw),
            nn.BatchNorm(mid, device=device))
        self.dw2 = DepthwiseConvBN(mid, 3, **kw)
        self.proj = ConvBN(mid, cout, 1, padding=0, **kw)
        self.cin, self.cout = cin, cout

    def forward(self, x):
        out = self.conv1(x)
        if self.stride == 2:
            out = self.dw1(out)
        out = self.dw2(nn.relu(self.dw_mid(out)))
        out = self.proj(out)
        res = self.shortcut(x) if self.stride == 2 else x
        if self.stride == 1 and self.cin != self.cout:
            return nn.relu(out)
        return nn.relu(out + res)


class ContextEmbedding(tnn.Module):
    def __init__(self, cin, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.bn = nn.BatchNorm(cin, device=device)
        self.conv1 = ConvBNReLU(cin, cin, 1, padding=0, **kw)
        self.conv3 = nn.Conv2d(cin, cin, 3, padding=1, **kw)

    def forward(self, x):
        gap = x.mean((1, 2), keepdim=True)
        return self.conv3(self.conv1(self.bn(gap)) + x)


class DetailBranch(tnn.Module):
    def __init__(self, channels=(64, 64, 128), device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        c1, c2, c3 = channels
        self.stage = nn.Sequential(
            ConvBNReLU(3, c1, 3, stride=2, **kw), ConvBNReLU(c1, c1, 3, **kw),
            ConvBNReLU(c1, c2, 3, stride=2, **kw), ConvBNReLU(c2, c2, 3, **kw),
            ConvBNReLU(c2, c2, 3, **kw),
            ConvBNReLU(c2, c3, 3, stride=2, **kw), ConvBNReLU(c3, c3, 3, **kw),
            ConvBNReLU(c3, c3, 3, **kw))

    def forward(self, x):
        return self.stage(x)


class SemanticBranch(tnn.Module):
    def __init__(self, channels=(16, 32, 64, 128), device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        c1, c2, c3, c4 = channels
        self.stem = StemBlock(3, c1, **kw)
        self.stage3 = nn.Sequential(GatherExpand(c1, c2, 2, **kw),
                                    GatherExpand(c2, c2, **kw))
        self.stage4 = nn.Sequential(GatherExpand(c2, c3, 2, **kw),
                                    GatherExpand(c3, c3, **kw))
        self.stage5 = nn.Sequential(
            GatherExpand(c3, c4, 2, **kw), GatherExpand(c4, c4, **kw),
            GatherExpand(c4, c4, **kw), GatherExpand(c4, c4, **kw))
        self.ce = ContextEmbedding(c4, **kw)

    def forward(self, x):
        s2 = self.stem(x)
        s3 = self.stage3(s2)
        s4 = self.stage4(s3)
        s5 = self.stage5(s4)
        return s2, s3, s4, self.ce(s5)


class BGA(tnn.Module):
    """Bilateral guided aggregation."""

    def __init__(self, ch=128, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.db_dw = nn.Sequential(DepthwiseConvBN(ch, 3, **kw),
                                   nn.Conv2d(ch, ch, 1, **kw))
        self.db_down = nn.Sequential(ConvBN(ch, ch, 3, stride=2, **kw),
                                     nn.AvgPool2d(3, 2, 1))
        self.sb_dw = nn.Sequential(DepthwiseConvBN(ch, 3, **kw),
                                   nn.Conv2d(ch, ch, 1, **kw))
        self.sb_conv = ConvBN(ch, ch, 3, **kw)
        self.proj = ConvBN(ch, ch, 3, **kw)

    def forward(self, detail, semantic):
        d1 = self.db_dw(detail)
        d2 = self.db_down(detail)
        s1 = self.sb_conv(semantic)
        s2 = self.sb_dw(semantic)
        size = detail.shape[1:3]
        left = d1 * torch.sigmoid(interpolate(s1, size=size, mode="bilinear"))
        right = interpolate(d2 * torch.sigmoid(s2), size=size,
                            mode="bilinear")
        return self.proj(left + right)


class SegHead(tnn.Module):
    def __init__(self, cin, mid, num_classes, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv = ConvBNReLU(cin, mid, 3, **kw)
        self.drop = nn.Dropout(0.1)
        self.cls = nn.Conv2d(mid, num_classes, 1, **kw)

    def forward(self, x):
        return self.cls(self.drop(self.conv(x)))


class BiSeNetV2(tnn.Module):
    """Logits at the input's size; in training, the list of those and the
    four auxiliary heads' logits (over the semantic branch's stages)."""

    def __init__(self, num_classes=19, lambd=0.25, align_corners=False,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        c1, c2, c3 = 64, 64, 128
        sb = (int(c1 * lambd), int(c2 * lambd), c3 // 2, c3)
        self.detail = DetailBranch((c1, c2, c3), **kw)
        self.semantic = SemanticBranch(sb, **kw)
        self.bga = BGA(c3, **kw)
        self.head = SegHead(c3, c3, num_classes, **kw)
        self.aux_heads = tnn.ModuleList(
            [SegHead(ch, c1, num_classes, **kw) for ch in sb])
        self.align_corners = align_corners

    def forward(self, x):
        size = x.shape[1:3]
        feats = self.semantic(x)
        fused = self.bga(self.detail(x), feats[3])
        logits = interpolate(self.head(fused), size=size, mode="bilinear",
                             align_corners=self.align_corners)
        if self.training:
            return [logits] + [
                interpolate(h(f), size=size, mode="bilinear",
                            align_corners=self.align_corners)
                for h, f in zip(self.aux_heads, feats)]
        return logits
