"""LeViT (counterpart of ``tlxcv_tpu/models/classification/levit.py``).

NHWC images at the public call and the JAX model's attribute names
(``blocks.4.m.attention_biases``, ``patch_embed.layers.2.c``).  Linear
layers are followed by a BatchNorm over the last axis of the [B, N, C]
tokens (``nn.BatchNorm`` normalises every axis but the last, in eval and
in train mode).  Each attention adds a learned bias per head and per
offset between query and key positions, gathered by a static index table
(``_offset_table``, numpy, a non-persistent buffer), to its scores and
takes their softmax in plain PyTorch, as the reference does.  With
``distillation``, a train-mode forward returns both heads' logits, an
eval-mode one their mean.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch
from torch import nn as tnn

from ... import nn
from ...device import resolve_device

__all__ = ["LeViT", "levit_128s", "levit_128", "levit_192", "levit_256",
           "levit_384"]


class ConvBN(tnn.Module):
    """Conv (no bias) and BatchNorm."""

    def __init__(self, cin, cout, ks=1, stride=1, pad=0, groups=1,
                 bn_weight_init=1.0, device=None, generator=None):
        super().__init__()
        self.c = nn.Conv2d(cin, cout, ks, stride=stride, padding=pad,
                           groups=groups, bias=False, device=device,
                           generator=generator)
        self.bn = nn.BatchNorm(cout, device=device)
        if bn_weight_init == 0:
            torch.nn.init.zeros_(self.bn.weight)

    def forward(self, x):
        return self.bn(self.c(x))


class LinearBN(tnn.Module):
    """Bias-less Linear and a BatchNorm over the tokens' last axis."""

    def __init__(self, a, b, bn_weight_init=1.0, device=None, generator=None):
        super().__init__()
        self.c = nn.Linear(a, b, bias=False, device=device,
                           generator=generator)
        self.bn = nn.BatchNorm(b, device=device)
        if bn_weight_init == 0:
            torch.nn.init.zeros_(self.bn.weight)

    def forward(self, x):
        return self.bn(self.c(x))


class BNLinear(tnn.Module):
    """BatchNorm and Linear: the classifier head."""

    def __init__(self, a, b, device=None, generator=None):
        super().__init__()
        self.bn = nn.BatchNorm(a, device=device)
        self.l = nn.Linear(a, b, device=device, generator=generator)

    def forward(self, x):
        return self.l(self.bn(x))


def _b16_stem(n, kw):
    """Four stride-2 ConvBNs with hardswish between them."""
    return nn.Sequential(
        ConvBN(3, n // 8, 3, 2, 1, **kw), nn.Activation("hardswish"),
        ConvBN(n // 8, n // 4, 3, 2, 1, **kw), nn.Activation("hardswish"),
        ConvBN(n // 4, n // 2, 3, 2, 1, **kw), nn.Activation("hardswish"),
        ConvBN(n // 2, n, 3, 2, 1, **kw))


def _offset_table(points_q, points_k, stride=1):
    """Static id of each (query, key) pair's offset: idxs [Nq, Nk] int32,
    ids numbered in order of first appearance, and the number of distinct
    offsets."""
    offsets = {}
    idxs = []
    for p1 in points_q:
        for p2 in points_k:
            off = (abs(p1[0] * stride - p2[0]), abs(p1[1] * stride - p2[1]))
            if off not in offsets:
                offsets[off] = len(offsets)
            idxs.append(offsets[off])
    idxs = np.asarray(idxs, np.int32).reshape(len(points_q), len(points_k))
    return idxs, len(offsets)


def _grid(resolution):
    return list(itertools.product(range(resolution), range(resolution)))


class _BiasedAttention(tnn.Module):
    """The learned per-offset bias table and its static index map."""

    def _bias_table(self, num_heads, idxs, n_off, device):
        self.attention_biases = tnn.Parameter(
            torch.zeros((num_heads, n_off), device=device))
        self.register_buffer("bias_idxs", torch.as_tensor(
            idxs, dtype=torch.long, device=device), persistent=False)

    def _attend(self, q, k, v, dtype):
        bias = self.attention_biases[:, self.bias_idxs]  # [H, Nq, Nk]
        attn = (q @ k.transpose(-1, -2)) * self.scale + bias.to(dtype)
        return torch.softmax(attn, -1) @ v


class LeViTAttention(_BiasedAttention):
    def __init__(self, dim, key_dim, num_heads, attn_ratio, resolution,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.num_heads = num_heads
        self.key_dim = key_dim
        self.scale = key_dim ** -0.5
        self.d = int(attn_ratio * key_dim)
        self.dh = self.d * num_heads
        self.h = self.dh + key_dim * num_heads * 2
        self.qkv = LinearBN(dim, self.h, **kw)
        self.proj = nn.Sequential(nn.Activation("hardswish"),
                                  LinearBN(self.dh, dim, bn_weight_init=0,
                                           **kw))
        pts = _grid(resolution)
        self._bias_table(num_heads, *_offset_table(pts, pts), device)

    def forward(self, x):
        b, n, _ = x.shape
        qkv = self.qkv(x).reshape(b, n, self.num_heads,
                                  self.h // self.num_heads)
        kd = self.key_dim
        q, k, v = (t.transpose(1, 2) for t in
                   (qkv[..., :kd], qkv[..., kd:2 * kd], qkv[..., 2 * kd:]))
        out = self._attend(q, k, v, x.dtype)
        return self.proj(out.transpose(1, 2).reshape(b, n, self.dh))


class AttentionSubsample(_BiasedAttention):
    """Stage transition: k and v at full resolution, q from every
    ``stride``-th token; the output at the reduced resolution."""

    def __init__(self, in_dim, out_dim, key_dim, num_heads, attn_ratio,
                 stride, resolution, resolution_out, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.num_heads = num_heads
        self.key_dim = key_dim
        self.scale = key_dim ** -0.5
        self.d = int(attn_ratio * key_dim)
        self.dh = self.d * num_heads
        self.stride = stride
        self.resolution = resolution
        self.resolution_out = resolution_out
        self.kv = LinearBN(in_dim, self.dh + key_dim * num_heads, **kw)
        self.q = LinearBN(in_dim, key_dim * num_heads, **kw)
        self.proj = nn.Sequential(nn.Activation("hardswish"),
                                  LinearBN(self.dh, out_dim, **kw))
        self._bias_table(num_heads, *_offset_table(
            _grid(resolution_out), _grid(resolution), stride=stride), device)

    def forward(self, x):
        b, n, c = x.shape
        r, s = self.resolution, self.stride
        kv = self.kv(x).reshape(b, n, self.num_heads, -1)
        k = kv[..., :self.key_dim].transpose(1, 2)
        v = kv[..., self.key_dim:].transpose(1, 2)
        xq = x.reshape(b, r, r, c)[:, ::s, ::s].reshape(b, -1, c)
        nq = xq.shape[1]
        q = self.q(xq).reshape(b, nq, self.num_heads, self.key_dim)
        out = self._attend(q.transpose(1, 2), k, v, x.dtype)
        return self.proj(out.transpose(1, 2).reshape(b, nq, self.dh))


class Residual(tnn.Module):
    def __init__(self, m, drop=0.0):
        super().__init__()
        self.m = m
        self.drop = drop

    def forward(self, x):
        return x + self.m(x)


def _mlp(dim, hidden, kw):
    return nn.Sequential(LinearBN(dim, hidden, **kw),
                         nn.Activation("hardswish"),
                         LinearBN(hidden, dim, bn_weight_init=0, **kw))


class LeViT(tnn.Module):
    def __init__(self, img_size=224, patch_size=16, num_classes=1000,
                 embed_dim=(128, 256, 384), key_dim=(16, 16, 16),
                 depth=(2, 3, 4), num_heads=(4, 6, 8),
                 attn_ratio=(2, 2, 2), mlp_ratio=(2, 2, 2),
                 down_ops=None, distillation=False, drop_path=0.0,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.num_classes = num_classes
        self.distillation = distillation
        self.embed_dim = tuple(embed_dim)
        self.patch_embed = _b16_stem(embed_dim[0], kw)
        if down_ops is None:
            down_ops = [["Subsample", key_dim[0], embed_dim[0] // key_dim[0],
                         4, 2, 2],
                        ["Subsample", key_dim[1], embed_dim[1] // key_dim[1],
                         4, 2, 2]]
        down_ops = list(down_ops) + [[""]]
        blocks = []
        resolution = img_size // patch_size
        for i, (ed, kd, dpth, nh, ar, mr, do) in enumerate(zip(
                embed_dim, key_dim, depth, num_heads, attn_ratio, mlp_ratio,
                down_ops)):
            for _ in range(dpth):
                blocks.append(Residual(LeViTAttention(
                    ed, kd, nh, ar, resolution, **kw), drop_path))
                if mr > 0:
                    blocks.append(Residual(_mlp(ed, int(ed * mr), kw),
                                           drop_path))
            if do[0] == "Subsample":
                resolution_ = (resolution - 1) // do[5] + 1
                blocks.append(AttentionSubsample(
                    embed_dim[i], embed_dim[i + 1], key_dim=do[1],
                    num_heads=do[2], attn_ratio=do[3], stride=do[5],
                    resolution=resolution, resolution_out=resolution_, **kw))
                resolution = resolution_
                if do[4] > 0:
                    blocks.append(Residual(_mlp(
                        embed_dim[i + 1], int(embed_dim[i + 1] * do[4]), kw),
                        drop_path))
        self.blocks = tnn.ModuleList(blocks)
        self.head = (BNLinear(embed_dim[-1], num_classes, **kw)
                     if num_classes > 0 else nn.Identity())
        if distillation:
            self.head_dist = (BNLinear(embed_dim[-1], num_classes, **kw)
                              if num_classes > 0 else nn.Identity())

    def forward(self, x):
        x = self.patch_embed(x)  # [B, H, W, C]
        b, h, w, c = x.shape
        x = x.reshape(b, h * w, c)
        for blk in self.blocks:
            x = blk(x)
        x = x.mean(1)
        if self.distillation:
            y, y_dist = self.head(x), self.head_dist(x)
            if self.training:
                return y, y_dist
            return (y + y_dist) / 2
        return self.head(x)


_SPEC = {
    "levit_128s": dict(embed_dim=(128, 256, 384), key_dim=(16, 16, 16),
                       num_heads=(4, 6, 8), depth=(2, 3, 4)),
    "levit_128": dict(embed_dim=(128, 256, 384), key_dim=(16, 16, 16),
                      num_heads=(4, 8, 12), depth=(4, 4, 4)),
    "levit_192": dict(embed_dim=(192, 288, 384), key_dim=(32, 32, 32),
                      num_heads=(3, 5, 6), depth=(4, 4, 4)),
    "levit_256": dict(embed_dim=(256, 384, 512), key_dim=(32, 32, 32),
                      num_heads=(4, 6, 8), depth=(4, 4, 4)),
    "levit_384": dict(embed_dim=(384, 512, 768), key_dim=(32, 32, 32),
                      num_heads=(6, 9, 12), depth=(4, 4, 4)),
}


def _levit(arch, pretrained=False, num_classes=1000, distillation=False,
           **kwargs):
    spec = dict(_SPEC[arch])
    spec.update(kwargs)
    return LeViT(num_classes=num_classes, distillation=distillation, **spec)


def levit_128s(pretrained=False, **kw):
    return _levit("levit_128s", pretrained, **kw)


def levit_128(pretrained=False, **kw):
    return _levit("levit_128", pretrained, **kw)


def levit_192(pretrained=False, **kw):
    return _levit("levit_192", pretrained, **kw)


def levit_256(pretrained=False, **kw):
    return _levit("levit_256", pretrained, **kw)


def levit_384(pretrained=False, **kw):
    return _levit("levit_384", pretrained, **kw)
