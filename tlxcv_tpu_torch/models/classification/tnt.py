"""TNT (Transformer in Transformer) and PP-HGNet (counterpart of
``tlxcv_tpu/models/classification/tnt.py``).

NHWC images at the public call and the JAX models' attribute names.  Both
of TNT's attentions, the inner one over the 16 pixel tokens of a patch
(head dim 6, which the flash wrapper pads to 32) and the outer one over
the patch tokens, are ``nn.attention.MultiHeadAttention``: on the card, one
launch of the flash-attention kernel each.
"""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...core import init as I
from ...device import resolve_device
from ...nn.attention import MultiHeadAttention
from .vision_transformer import Mlp

__all__ = ["TNT", "tnt_s", "PPHGNet", "pp_hgnet_small"]


class TNTBlock(tnn.Module):
    def __init__(self, outer_dim, inner_dim, outer_heads, inner_heads,
                 num_pixels, mlp_ratio=4.0, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.inner_norm1 = nn.LayerNorm(inner_dim, device=device)
        self.inner_attn = MultiHeadAttention(inner_dim, inner_heads,
                                             qkv_bias=False, **kw)
        self.inner_norm2 = nn.LayerNorm(inner_dim, device=device)
        self.inner_mlp = Mlp(inner_dim, int(inner_dim * mlp_ratio), **kw)
        self.proj_norm1 = nn.LayerNorm(inner_dim * num_pixels, device=device)
        self.proj = nn.Linear(inner_dim * num_pixels, outer_dim, **kw)
        self.proj_norm2 = nn.LayerNorm(outer_dim, device=device)
        self.outer_norm1 = nn.LayerNorm(outer_dim, device=device)
        self.outer_attn = MultiHeadAttention(outer_dim, outer_heads,
                                             qkv_bias=False, **kw)
        self.outer_norm2 = nn.LayerNorm(outer_dim, device=device)
        self.outer_mlp = Mlp(outer_dim, int(outer_dim * mlp_ratio), **kw)
        self.num_pixels = num_pixels

    def forward(self, pixels, patches):
        # the inner transformer over each patch's pixel tokens
        pixels = pixels + self.inner_attn(self.inner_norm1(pixels))
        pixels = pixels + self.inner_mlp(self.inner_norm2(pixels))
        # fold the pixel tokens into the patch tokens (not the class token)
        _, n_pix, c_in = pixels.shape
        flat = pixels.reshape(patches.shape[0], -1, n_pix * c_in)
        upd = self.proj_norm2(self.proj(self.proj_norm1(flat)))
        patches = torch.cat([patches[:, :1], patches[:, 1:] + upd], 1)
        patches = patches + self.outer_attn(self.outer_norm1(patches))
        patches = patches + self.outer_mlp(self.outer_norm2(patches))
        return pixels, patches


class TNT(tnn.Module):
    """Logits ``[B, num_classes]`` of NHWC images ``[B, H, W, 3]``."""

    def __init__(self, img_size=224, patch_size=16, inner_stride=4,
                 outer_dim=384, inner_dim=24, depth=6, outer_heads=6,
                 inner_heads=4, num_classes=1000, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.n_patches = (img_size // patch_size) ** 2
        self.n_pixels = (patch_size // inner_stride) ** 2
        self.pixel_embed = nn.Conv2d(3, inner_dim, 7, stride=inner_stride,
                                     padding=3, **kw)
        self.patch_size = patch_size
        self.inner_stride = inner_stride
        self.pixel_pos = tnn.Parameter(I.truncated_normal(
            (1, self.n_pixels, inner_dim), std=0.02, **kw))
        self.patch_pos = tnn.Parameter(I.truncated_normal(
            (1, self.n_patches + 1, outer_dim), std=0.02, **kw))
        self.cls_token = tnn.Parameter(I.truncated_normal(
            (1, 1, outer_dim), std=0.02, **kw))
        self.norm_proj = nn.LayerNorm(self.n_pixels * inner_dim, device=device)
        self.patch_proj = nn.Linear(self.n_pixels * inner_dim, outer_dim, **kw)
        self.blocks = tnn.ModuleList([
            TNTBlock(outer_dim, inner_dim, outer_heads, inner_heads,
                     self.n_pixels, **kw) for _ in range(depth)])
        self.norm = nn.LayerNorm(outer_dim, device=device)
        self.head = nn.Linear(outer_dim, num_classes, **kw)
        self.outer_dim = outer_dim
        self.inner_dim = inner_dim

    def forward(self, x):
        b, h, w, _ = x.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        pix = self.pixel_embed(x)  # [B, H/s, W/s, inner]
        ppp = p // self.inner_stride
        pix = pix.reshape(b, gh, ppp, gw, ppp, self.inner_dim)
        pix = pix.permute(0, 1, 3, 2, 4, 5).reshape(
            b * gh * gw, ppp * ppp, self.inner_dim)
        pix = pix + self.pixel_pos.to(pix.dtype)
        patches = self.patch_proj(self.norm_proj(pix.reshape(b, gh * gw, -1)))
        cls = self.cls_token.to(x.dtype).expand(b, 1, self.outer_dim)
        patches = torch.cat([cls, patches], 1)
        patches = patches + self.patch_pos.to(patches.dtype)
        for blk in self.blocks:
            pix, patches = blk(pix, patches)
        return self.head(self.norm(patches)[:, 0])


def tnt_s(pretrained=False, **kw):
    """The reference's TNT-S: its defaults, depth 6."""
    return TNT(**kw)


def _conv_bn_relu(cin, cout, stride=1, kw=None):
    return nn.Sequential(
        nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False, **kw),
        nn.BatchNorm(cout, device=kw["device"]), nn.Activation("relu"))


class HGBlock(tnn.Module):
    """PP-HGNet block: chained 3x3 convs, their outputs and the input
    concatenated, squeezed by a 1x1."""

    def __init__(self, cin, mid, cout, layers=6, identity=False, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.convs = tnn.ModuleList([_conv_bn_relu(cin if i == 0 else mid,
                                                   mid, kw=kw)
                                     for i in range(layers)])
        total = cin + layers * mid
        self.squeeze = nn.Sequential(
            nn.Conv2d(total, cout, 1, bias=False, **kw),
            nn.BatchNorm(cout, device=device), nn.Activation("relu"))
        self.identity = identity

    def forward(self, x):
        feats = [x]
        y = x
        for conv in self.convs:
            y = conv(y)
            feats.append(y)
        out = self.squeeze(torch.cat(feats, -1))
        return out + x if self.identity else out


class PPHGNet(tnn.Module):
    def __init__(self, num_classes=1000, stem_channels=(48, 48, 96),
                 stage_cfg=((96, 96, 224, 1, False),
                            (224, 128, 448, 1, True),
                            (448, 160, 512, 2, True),
                            (512, 192, 768, 1, True)),
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        stem, cin = [], 3
        for i, c in enumerate(stem_channels):
            stem.append(_conv_bn_relu(cin, c, 2 if i == 0 else 1, kw))
            cin = c
        self.stem = nn.Sequential(*stem)
        self.pool0 = nn.MaxPool2d(3, 2, 1)
        blocks = []
        for _, mid, bout, n, downsample in stage_cfg:
            if downsample:
                blocks.append(nn.Sequential(
                    nn.Conv2d(cin, cin, 3, stride=2, padding=1, groups=cin,
                              bias=False, **kw),
                    nn.BatchNorm(cin, device=device)))
            for bi in range(n):
                blocks.append(HGBlock(cin if bi == 0 else bout, mid, bout,
                                      identity=bi > 0, **kw))
                cin = bout
        self.blocks = tnn.ModuleList(blocks)
        self.gap = nn.GlobalAvgPool2d(keepdims=True)
        self.last = nn.Conv2d(cin, 2048, 1, **kw)
        self.fc = nn.Linear(2048, num_classes, **kw)

    def forward(self, x):
        x = self.pool0(self.stem(x))
        for b in self.blocks:
            x = b(x)
        x = nn.relu(self.last(self.gap(x)))
        return self.fc(x[:, 0, 0, :])


def pp_hgnet_small(pretrained=False, **kw):
    return PPHGNet(**kw)
