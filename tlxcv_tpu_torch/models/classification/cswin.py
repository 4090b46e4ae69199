"""CSWin Transformer (counterpart of
``tlxcv_tpu/models/classification/cswin.py``).

NHWC images at the public call and the JAX model's attribute names
(``stages.2.5.attns.1.get_v``, ``merges.0.1``).  Cross-shaped window
attention: half the heads attend within horizontal stripes, half within
vertical ones (the last stage: all heads, horizontal), each plus a
locally-enhanced position encoding, a depthwise 3x3 of V over the whole
map.  The stripes' softmax is plain PyTorch, as in the reference.
"""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...device import resolve_device
from .vision_transformer import Mlp

__all__ = ["CSWinTransformer", "cswin_tiny", "cswin_small"]


class LePEAttention(tnn.Module):
    """Stripe attention for one orientation."""

    def __init__(self, dim, heads, split_size, horizontal, device=None,
                 generator=None):
        super().__init__()
        self.heads = heads
        self.head_dim = dim // heads
        self.scale = self.head_dim ** -0.5
        self.split = split_size
        self.horizontal = horizontal
        self.get_v = nn.Conv2d(dim, dim, 3, padding=1, groups=dim,
                               device=device, generator=generator)

    def _stripes(self, x, h, w):
        """[B, H, W, C] -> [B * stripes, stripe length, C]: rows of
        ``split`` pixels (horizontal) or columns of ``split`` (vertical)."""
        b, s = x.shape[0], self.split
        if self.horizontal:
            return x.reshape(b * (h // s), s * w, -1)
        x = x.reshape(b, h, w // s, s, -1).permute(0, 2, 1, 3, 4)
        return x.reshape(b * (w // s), h * s, -1)

    def _unstripes(self, x, b, h, w):
        """The inverse of ``_stripes``."""
        s = self.split
        if self.horizontal:
            return x.reshape(b, h, w, -1)
        x = x.reshape(b, w // s, h, s, -1).permute(0, 2, 1, 3, 4)
        return x.reshape(b, h, w, -1)

    def forward(self, q, k, v, hw):
        h, w = hw
        b = q.shape[0]
        lepe = self.get_v(v.reshape(b, h, w, -1))
        qs, ks, vs = (self._stripes(t.reshape(b, h, w, -1), h, w)
                      for t in (q, k, v))
        bn, n, c = qs.shape

        def split_heads(t):
            return t.reshape(bn, n, self.heads, self.head_dim).transpose(1, 2)

        attn = torch.softmax((split_heads(qs) * self.scale)
                             @ split_heads(ks).transpose(-1, -2), -1)
        out = (attn @ split_heads(vs)).transpose(1, 2).reshape(bn, n, c)
        out = self._unstripes(out, b, h, w) + lepe
        return out.reshape(b, h * w, c)


class CSWinBlock(tnn.Module):
    def __init__(self, dim, heads, split_size, hw, mlp_ratio=4.0, last=False,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.norm1 = nn.LayerNorm(dim, device=device)
        self.qkv = nn.Linear(dim, dim * 3, **kw)
        self.hw = hw
        self.last = last
        if last:
            attns = [LePEAttention(dim, heads, split_size, True, **kw)]
        else:
            attns = [LePEAttention(dim // 2, heads // 2, split_size, True,
                                   **kw),
                     LePEAttention(dim // 2, heads // 2, split_size, False,
                                   **kw)]
        self.attns = tnn.ModuleList(attns)
        self.proj = nn.Linear(dim, dim, **kw)
        self.norm2 = nn.LayerNorm(dim, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), **kw)

    def forward(self, x):
        b, n, c = x.shape
        q, k, v = self.qkv(self.norm1(x)).reshape(b, n, 3, c).permute(
            2, 0, 1, 3)
        if self.last:
            att = self.attns[0](q, k, v, self.hw)
        else:
            halves = [t.chunk(2, -1) for t in (q, k, v)]
            att = torch.cat([attn(*(t[i] for t in halves), self.hw)
                             for i, attn in enumerate(self.attns)], -1)
        x = x + self.proj(att)
        return x + self.mlp(self.norm2(x))


class CSWinTransformer(tnn.Module):
    def __init__(self, img_size=224, embed_dim=64, depths=(1, 2, 21, 1),
                 heads=(2, 4, 8, 16), split_sizes=(1, 2, 7, 7),
                 num_classes=1000, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.stem = nn.Conv2d(3, embed_dim, 7, stride=4, padding=3, **kw)
        self.stem_norm = nn.LayerNorm(embed_dim, device=device)
        hw = img_size // 4
        self.stages = tnn.ModuleList()
        self.merges = tnn.ModuleList()
        dim = embed_dim
        for i, (depth, h) in enumerate(zip(depths, heads)):
            last = i == len(depths) - 1
            self.stages.append(tnn.ModuleList([
                CSWinBlock(dim, h, split_sizes[i], (hw, hw), last=last, **kw)
                for _ in range(depth)]))
            if not last:
                self.merges.append(tnn.ModuleList([
                    nn.Conv2d(dim, dim * 2, 3, stride=2, padding=1, **kw),
                    nn.LayerNorm(dim * 2, device=device)]))
                dim *= 2
                hw = (hw + 1) // 2  # k3 s2 p1 conv output size
        self.norm = nn.LayerNorm(dim, device=device)
        self.head = nn.Linear(dim, num_classes, **kw)

    def forward(self, x):
        x = self.stem(x)
        b, h, w, c = x.shape
        x = self.stem_norm(x.reshape(b, h * w, c))
        for i, blocks in enumerate(self.stages):
            for blk in blocks:
                x = blk(x)
            if i < len(self.merges):
                conv, norm = self.merges[i]
                x = conv(x.reshape(b, h, w, -1))
                h, w = x.shape[1:3]
                x = norm(x.reshape(b, h * w, -1))
        return self.head(self.norm(x).mean(1))


def cswin_tiny(pretrained=False, **kw):
    return CSWinTransformer(embed_dim=64, depths=(1, 2, 21, 1),
                            heads=(2, 4, 8, 16), **kw)


def cswin_small(pretrained=False, **kw):
    return CSWinTransformer(embed_dim=64, depths=(2, 4, 32, 2),
                            heads=(2, 4, 8, 16), **kw)
