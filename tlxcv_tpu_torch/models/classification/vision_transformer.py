"""Vision Transformer (counterpart of
``tlxcv_tpu/models/classification/vision_transformer.py``).

NHWC images ``[B, H, W, 3]`` at the public call; attention goes through the
single kernel boundary ``nn.attention.scaled_dot_product_attention``.
"""
from __future__ import annotations

import torch
from torch import nn

from ...core import init as I
from ...device import resolve_device
from ...nn.attention import MultiHeadAttention
from ...nn.layers import (Conv2d, Dropout, DropPath, Identity, LayerNorm,
                          Linear, get_activation)

__all__ = [
    "VisionTransformer", "vit_small_patch16_224", "vit_base_patch16_224",
    "vit_base_patch16_384", "vit_base_patch32_384", "vit_large_patch16_224",
    "vit_large_patch16_384", "vit_large_patch32_384",
]


class Mlp(nn.Module):
    def __init__(self, in_features, hidden_features=None, out_features=None,
                 act="gelu", drop=0.0, device=None, generator=None):
        super().__init__()
        hidden = hidden_features or in_features
        out = out_features or in_features
        self.fc1 = Linear(in_features, hidden, w_init=I.xavier_uniform,
                          device=device, generator=generator)
        self.fc2 = Linear(hidden, out, w_init=I.xavier_uniform,
                          device=device, generator=generator)
        self.act = get_activation(act)
        self.drop = Dropout(drop)

    def forward(self, x):
        x = self.drop(self.act(self.fc1(x)))
        return self.drop(self.fc2(x))


class Block(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio=4.0, qkv_bias=False,
                 qk_scale=None, drop=0.0, attn_drop=0.0, drop_path=0.0,
                 epsilon=1e-6, device=None, generator=None):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=epsilon, device=device)
        self.attn = MultiHeadAttention(dim, num_heads, qkv_bias, qk_scale,
                                       attn_drop, drop, device=device,
                                       generator=generator)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=epsilon, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop=drop, device=device,
                       generator=generator)

    def forward(self, x):
        x = x + self.drop_path(self.attn(self.norm1(x)))
        x = x + self.drop_path(self.mlp(self.norm2(x)))
        return x


class PatchEmbed(nn.Module):
    def __init__(self, img_size=224, patch_size=16, in_chans=3, embed_dim=768,
                 device=None, generator=None):
        super().__init__()
        img_size = (img_size, img_size) if isinstance(img_size, int) else img_size
        patch_size = (patch_size, patch_size) if isinstance(patch_size, int) else patch_size
        self.num_patches = (img_size[0] // patch_size[0]) * (img_size[1] // patch_size[1])
        self.proj = Conv2d(in_chans, embed_dim, patch_size, stride=patch_size,
                           device=device, generator=generator)

    def forward(self, x):
        x = self.proj(x)  # [B, H', W', C]
        return x.reshape(x.shape[0], -1, x.shape[-1])


class VisionTransformer(nn.Module):
    """``device=None`` builds on the CUDA card (and raises without one);
    initial weights come from ``generator`` (torch's default when None)."""

    def __init__(self, img_size=224, patch_size=16, in_chans=3,
                 num_classes=1000, embed_dim=768, depth=12, num_heads=12,
                 mlp_ratio=4.0, qkv_bias=False, qk_scale=None, drop_rate=0.0,
                 attn_drop_rate=0.0, drop_path_rate=0.0, epsilon=1e-6,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.num_classes = num_classes
        self.embed_dim = embed_dim
        self.patch_embed = PatchEmbed(img_size, patch_size, in_chans,
                                      embed_dim, **kw)
        n = self.patch_embed.num_patches
        self.pos_embed = nn.Parameter(
            I.truncated_normal((1, n + 1, embed_dim), std=0.02, **kw))
        self.cls_token = nn.Parameter(
            I.truncated_normal((1, 1, embed_dim), std=0.02, **kw))
        self.pos_drop = Dropout(drop_rate)
        dpr = torch.linspace(0, drop_path_rate, depth).tolist()
        self.blocks = nn.ModuleList([
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, qk_scale,
                  drop_rate, attn_drop_rate, dpr[i], epsilon, **kw)
            for i in range(depth)])
        self.norm = LayerNorm(embed_dim, eps=epsilon, device=device)
        self.head = (Linear(embed_dim, num_classes,
                            w_init=lambda s, **k: I.truncated_normal(
                                s, std=0.02, **k), **kw)
                     if num_classes > 0 else Identity())

    def forward_features(self, x):
        b = x.shape[0]
        x = self.patch_embed(x)
        cls = self.cls_token.to(x.dtype).expand(b, 1, self.embed_dim)
        x = torch.cat([cls, x], dim=1)
        x = self.pos_drop(x + self.pos_embed.to(x.dtype))
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)[:, 0]

    def forward(self, x):
        return self.head(self.forward_features(x))


_CFGS = {
    "vit_small_patch16_224": dict(patch_size=16, embed_dim=768, depth=8,
                                  num_heads=8, mlp_ratio=3, qk_scale=768 ** -0.5),
    "vit_base_patch16_224": dict(patch_size=16, embed_dim=768, depth=12,
                                 num_heads=12, mlp_ratio=4, qkv_bias=True,
                                 epsilon=1e-6),
    "vit_base_patch16_384": dict(img_size=384, patch_size=16, embed_dim=768,
                                 depth=12, num_heads=12, mlp_ratio=4,
                                 qkv_bias=True, epsilon=1e-6),
    "vit_base_patch32_384": dict(img_size=384, patch_size=32, embed_dim=768,
                                 depth=12, num_heads=12, mlp_ratio=4,
                                 qkv_bias=True, epsilon=1e-6),
    "vit_large_patch16_224": dict(patch_size=16, embed_dim=1024, depth=24,
                                  num_heads=16, mlp_ratio=4, qkv_bias=True,
                                  epsilon=1e-6),
    "vit_large_patch16_384": dict(img_size=384, patch_size=16, embed_dim=1024,
                                  depth=24, num_heads=16, mlp_ratio=4,
                                  qkv_bias=True, epsilon=1e-6),
    "vit_large_patch32_384": dict(img_size=384, patch_size=32, embed_dim=1024,
                                  depth=24, num_heads=16, mlp_ratio=4,
                                  qkv_bias=True, epsilon=1e-6),
}


def _vit(arch, **kwargs):
    cfg = dict(_CFGS[arch])
    cfg.update(kwargs)
    return VisionTransformer(**cfg)


def vit_small_patch16_224(pretrained=False, **kw):
    return _vit("vit_small_patch16_224", **kw)


def vit_base_patch16_224(pretrained=False, **kw):
    return _vit("vit_base_patch16_224", **kw)


def vit_base_patch16_384(pretrained=False, **kw):
    return _vit("vit_base_patch16_384", **kw)


def vit_base_patch32_384(pretrained=False, **kw):
    return _vit("vit_base_patch32_384", **kw)


def vit_large_patch16_224(pretrained=False, **kw):
    return _vit("vit_large_patch16_224", **kw)


def vit_large_patch16_384(pretrained=False, **kw):
    return _vit("vit_large_patch16_384", **kw)


def vit_large_patch32_384(pretrained=False, **kw):
    return _vit("vit_large_patch32_384", **kw)
