"""PVTv2, the Pyramid Vision Transformer v2 (counterpart of
``tlxcv_tpu/models/classification/pvt_v2.py``).

NHWC images at the public call and the JAX model's attribute names
(``stages.2.1.attn.kv``).  As in the reference, the spatial-reduction
attention takes the softmax of its own product in plain PyTorch; it does
not go through ``nn.attention.scaled_dot_product_attention``.
"""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...device import resolve_device

__all__ = ["PVTv2", "pvt_v2_b0", "pvt_v2_b1", "pvt_v2_b2"]

gelu = nn.get_activation("gelu")


class SRAttention(tnn.Module):
    """Spatial-reduction attention: k and v from a map downsampled by a
    ``sr_ratio`` strided conv."""

    def __init__(self, dim, num_heads, sr_ratio=1, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.scale = self.head_dim ** -0.5
        self.q = nn.Linear(dim, dim, **kw)
        self.kv = nn.Linear(dim, dim * 2, **kw)
        self.proj = nn.Linear(dim, dim, **kw)
        self.sr_ratio = sr_ratio
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio, **kw)
            self.norm = nn.LayerNorm(dim, device=device)

    def forward(self, x, hw):
        b, n, c = x.shape
        h, w = hw
        q = self.q(x).reshape(b, n, self.num_heads, self.head_dim
                              ).transpose(1, 2)
        src = x
        if self.sr_ratio > 1:
            src = self.sr(x.reshape(b, h, w, c))
            src = self.norm(src.reshape(b, -1, c))
        kv = self.kv(src).reshape(b, -1, 2, self.num_heads, self.head_dim)
        k, v = kv.permute(2, 0, 3, 1, 4)
        attn = torch.softmax((q * self.scale) @ k.transpose(-1, -2), -1)
        out = (attn @ v).transpose(1, 2).reshape(b, n, c)
        return self.proj(out)


class MixFFN(tnn.Module):
    """fc1, a depthwise 3x3 over the token map, GELU, fc2."""

    def __init__(self, dim, hidden, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.fc1 = nn.Linear(dim, hidden, **kw)
        self.dw = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden, **kw)
        self.fc2 = nn.Linear(hidden, dim, **kw)

    def forward(self, x, hw):
        b, n, _ = x.shape
        h, w = hw
        y = self.fc1(x)
        y = self.dw(y.reshape(b, h, w, -1)).reshape(b, n, -1)
        return self.fc2(gelu(y))


class PVTBlock(tnn.Module):
    def __init__(self, dim, num_heads, mlp_ratio, sr_ratio, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.norm1 = nn.LayerNorm(dim, device=device)
        self.attn = SRAttention(dim, num_heads, sr_ratio, **kw)
        self.norm2 = nn.LayerNorm(dim, device=device)
        self.ffn = MixFFN(dim, int(dim * mlp_ratio), **kw)

    def forward(self, x, hw):
        x = x + self.attn(self.norm1(x), hw)
        return x + self.ffn(self.norm2(x), hw)


class PVTv2(tnn.Module):
    def __init__(self, dims=(32, 64, 160, 256), depths=(2, 2, 2, 2),
                 num_heads=(1, 2, 5, 8), sr_ratios=(8, 4, 2, 1),
                 mlp_ratios=(8, 8, 4, 4), num_classes=1000, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.embeds = tnn.ModuleList()
        self.norms_in = tnn.ModuleList()
        self.stages = tnn.ModuleList()
        self.norms_out = tnn.ModuleList()
        cin = 3
        for i, dim in enumerate(dims):
            k, s = (7, 4) if i == 0 else (3, 2)
            self.embeds.append(nn.Conv2d(cin, dim, k, stride=s,
                                         padding=k // 2, **kw))
            self.norms_in.append(nn.LayerNorm(dim, device=device))
            self.stages.append(tnn.ModuleList([
                PVTBlock(dim, num_heads[i], mlp_ratios[i], sr_ratios[i], **kw)
                for _ in range(depths[i])]))
            self.norms_out.append(nn.LayerNorm(dim, device=device))
            cin = dim
        self.head = nn.Linear(dims[-1], num_classes, **kw)

    def forward(self, x):
        for embed, nin, blocks, nout in zip(self.embeds, self.norms_in,
                                            self.stages, self.norms_out):
            x = embed(x)
            b, h, w, c = x.shape
            seq = nin(x.reshape(b, h * w, c))
            for blk in blocks:
                seq = blk(seq, (h, w))
            x = nout(seq).reshape(b, h, w, c)
        return self.head(x.mean((1, 2)))


def pvt_v2_b0(pretrained=False, **kw):
    return PVTv2(dims=(32, 64, 160, 256), depths=(2, 2, 2, 2), **kw)


def pvt_v2_b1(pretrained=False, **kw):
    return PVTv2(dims=(64, 128, 320, 512), depths=(2, 2, 2, 2), **kw)


def pvt_v2_b2(pretrained=False, **kw):
    return PVTv2(dims=(64, 128, 320, 512), depths=(3, 4, 6, 3), **kw)
