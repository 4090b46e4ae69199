"""Twins: PCPVT (``CPVTV2``) and SVT (``ALTGVT``) (counterpart of
``tlxcv_tpu/models/classification/gvt.py``).

NHWC images at the public call and the JAX models' attribute names
(``blocks.2.3.attn.kv``, ``pos_block.1.proj``).  Locally-grouped attention
(LSA, within ws x ws windows) and global sub-sampled attention (GSA, k
and v from a strided conv) take the softmax of their own products in plain
PyTorch, as the reference does.  A conditional position encoding (PEG: a
depthwise 3x3 and a residual) follows block 0 of every stage; the head
averages the tokens.
"""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...device import resolve_device
from .vision_transformer import Mlp

__all__ = ["CPVTV2", "ALTGVT", "pcpvt_small", "pcpvt_base", "pcpvt_large",
           "alt_gvt_small", "alt_gvt_base", "alt_gvt_large"]


class PatchEmbed(tnn.Module):
    """Conv patchify and a LayerNorm over the tokens; returns the tokens
    and the map's (h, w)."""

    def __init__(self, patch_size, in_chans, embed_dim, device=None,
                 generator=None):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size,
                              stride=patch_size, device=device,
                              generator=generator)
        self.norm = nn.LayerNorm(embed_dim, device=device)

    def forward(self, x):
        x = self.proj(x)
        b, h, w, c = x.shape
        return self.norm(x.reshape(b, h * w, c)), (h, w)


class GroupAttention(tnn.Module):
    """LSA: attention within ws x ws groups of tokens."""

    def __init__(self, dim, num_heads, ws, qkv_bias=True, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.scale = self.head_dim ** -0.5
        self.ws = ws
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias, **kw)
        self.proj = nn.Linear(dim, dim, **kw)

    def forward(self, x, hw):
        h, w = hw
        b, n, c = x.shape
        ws = self.ws
        hg, wg = h // ws, w // ws
        g = hg * wg
        x = x.reshape(b, hg, ws, wg, ws, c).permute(0, 1, 3, 2, 4, 5)
        qkv = self.qkv(x).reshape(b, g, ws * ws, 3, self.num_heads,
                                  self.head_dim).permute(3, 0, 1, 4, 2, 5)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.softmax((q @ k.transpose(-1, -2)) * self.scale, -1)
        out = (attn @ v).transpose(2, 3)
        out = out.reshape(b, hg, wg, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        return self.proj(out.reshape(b, n, c))


class GSAttention(tnn.Module):
    """GSA: k and v from the map downsampled by a ``sr_ratio`` strided
    conv; separate q and kv projections."""

    def __init__(self, dim, num_heads, sr_ratio=1, qkv_bias=True,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.scale = self.head_dim ** -0.5
        self.sr_ratio = sr_ratio
        self.q = nn.Linear(dim, dim, bias=qkv_bias, **kw)
        self.kv = nn.Linear(dim, dim * 2, bias=qkv_bias, **kw)
        self.proj = nn.Linear(dim, dim, **kw)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio, **kw)
            self.norm = nn.LayerNorm(dim, device=device)

    def forward(self, x, hw):
        h, w = hw
        b, n, c = x.shape
        q = self.q(x).reshape(b, n, self.num_heads, self.head_dim)
        q = q.transpose(1, 2)
        if self.sr_ratio > 1:
            x_ = self.sr(x.reshape(b, h, w, c))
            x_ = self.norm(x_.reshape(b, -1, c))
        else:
            x_ = x
        kv = self.kv(x_).reshape(b, x_.shape[1], 2, self.num_heads,
                                 self.head_dim)
        k, v = kv.permute(2, 0, 3, 1, 4)
        attn = torch.softmax((q @ k.transpose(-1, -2)) * self.scale, -1)
        out = (attn @ v).transpose(1, 2).reshape(b, n, c)
        return self.proj(out)


class GroupBlock(tnn.Module):
    """Pre-norm block: GSA where ``ws`` is 1, else LSA."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, qkv_bias=True,
                 sr_ratio=1, ws=1, eps=1e-6, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.norm1 = nn.LayerNorm(dim, eps=eps, device=device)
        if ws == 1:
            self.attn = GSAttention(dim, num_heads, sr_ratio, qkv_bias, **kw)
        else:
            self.attn = GroupAttention(dim, num_heads, ws, qkv_bias, **kw)
        self.norm2 = nn.LayerNorm(dim, eps=eps, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), **kw)

    def forward(self, x, hw):
        x = x + self.attn(self.norm1(x), hw)
        return x + self.mlp(self.norm2(x))


class PosCNN(tnn.Module):
    """PEG: a depthwise 3x3 over the token map plus the tokens."""

    def __init__(self, embed_dim, device=None, generator=None):
        super().__init__()
        self.proj = nn.Conv2d(embed_dim, embed_dim, 3, stride=1, padding=1,
                              groups=embed_dim, device=device,
                              generator=generator)

    def forward(self, x, hw):
        h, w = hw
        b, n, c = x.shape
        feat = x.reshape(b, h, w, c)
        return (self.proj(feat) + feat).reshape(b, n, c)


class CPVTV2(tnn.Module):
    """PCPVT: a pyramid of GSA blocks with PEG; with ``wss`` (``ALTGVT``)
    even blocks are LSA over ``wss[stage]`` windows."""

    def __init__(self, patch_size=4, in_chans=3, num_classes=1000,
                 embed_dims=(64, 128, 320, 512), num_heads=(1, 2, 5, 8),
                 mlp_ratios=(8, 8, 4, 4), qkv_bias=True,
                 depths=(3, 4, 6, 3), sr_ratios=(8, 4, 2, 1),
                 wss=None, eps=1e-6, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.depths = tuple(depths)
        self.patch_embeds = tnn.ModuleList()
        cin = in_chans
        for i, dim in enumerate(embed_dims):
            self.patch_embeds.append(PatchEmbed(
                patch_size if i == 0 else 2, cin, dim, **kw))
            cin = dim
        self.blocks = tnn.ModuleList()
        for k in range(len(depths)):
            stage = []
            for i in range(depths[k]):
                ws = 1 if wss is None or i % 2 == 1 else wss[k]
                stage.append(GroupBlock(
                    embed_dims[k], num_heads[k], mlp_ratios[k], qkv_bias,
                    sr_ratio=sr_ratios[k], ws=ws, eps=eps, **kw))
            self.blocks.append(tnn.ModuleList(stage))
        self.pos_block = tnn.ModuleList([PosCNN(dim, **kw)
                                         for dim in embed_dims])
        self.norm = nn.LayerNorm(embed_dims[-1], eps=eps, device=device)
        self.head = (nn.Linear(embed_dims[-1], num_classes, **kw)
                     if num_classes > 0 else nn.Identity())

    def forward(self, x):
        b = x.shape[0]
        for i in range(len(self.depths)):
            x, (h, w) = self.patch_embeds[i](x)
            for j, blk in enumerate(self.blocks[i]):
                x = blk(x, (h, w))
                if j == 0:
                    x = self.pos_block[i](x, (h, w))  # PEG after block 0
            if i < len(self.depths) - 1:
                x = x.reshape(b, h, w, x.shape[-1])
        return self.head(self.norm(x).mean(1))


class ALTGVT(CPVTV2):
    """Twins-SVT: even blocks LSA over ``wss`` windows, odd blocks GSA."""

    def __init__(self, wss=(7, 7, 7, 7), **kwargs):
        super().__init__(wss=wss, **kwargs)


def pcpvt_small(pretrained=False, **kw):
    return CPVTV2(patch_size=4, embed_dims=(64, 128, 320, 512),
                  num_heads=(1, 2, 5, 8), mlp_ratios=(8, 8, 4, 4),
                  qkv_bias=True, depths=(3, 4, 6, 3),
                  sr_ratios=(8, 4, 2, 1), **kw)


def pcpvt_base(pretrained=False, **kw):
    return CPVTV2(patch_size=4, embed_dims=(64, 128, 320, 512),
                  num_heads=(1, 2, 5, 8), mlp_ratios=(8, 8, 4, 4),
                  qkv_bias=True, depths=(3, 4, 18, 3),
                  sr_ratios=(8, 4, 2, 1), **kw)


def pcpvt_large(pretrained=False, **kw):
    return CPVTV2(patch_size=4, embed_dims=(64, 128, 320, 512),
                  num_heads=(1, 2, 5, 8), mlp_ratios=(8, 8, 4, 4),
                  qkv_bias=True, depths=(3, 8, 27, 3),
                  sr_ratios=(8, 4, 2, 1), **kw)


def alt_gvt_small(pretrained=False, **kw):
    return ALTGVT(patch_size=4, embed_dims=(64, 128, 256, 512),
                  num_heads=(2, 4, 8, 16), mlp_ratios=(4, 4, 4, 4),
                  qkv_bias=True, depths=(2, 2, 10, 4), wss=(7, 7, 7, 7),
                  sr_ratios=(8, 4, 2, 1), **kw)


def alt_gvt_base(pretrained=False, **kw):
    return ALTGVT(patch_size=4, embed_dims=(96, 192, 384, 768),
                  num_heads=(3, 6, 12, 24), mlp_ratios=(4, 4, 4, 4),
                  qkv_bias=True, depths=(2, 2, 18, 2), wss=(7, 7, 7, 7),
                  sr_ratios=(8, 4, 2, 1), **kw)


def alt_gvt_large(pretrained=False, **kw):
    return ALTGVT(patch_size=4, embed_dims=(128, 256, 512, 1024),
                  num_heads=(4, 8, 16, 32), mlp_ratios=(4, 4, 4, 4),
                  qkv_bias=True, depths=(2, 2, 18, 2), wss=(7, 7, 7, 7),
                  sr_ratios=(8, 4, 2, 1), **kw)
