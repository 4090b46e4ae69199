"""DeiT, the distilled ViT (counterpart of
``tlxcv_tpu/models/classification/deit.py``): a class and a distillation
token, two heads averaged at inference.  Attention goes through
``nn.attention.scaled_dot_product_attention`` (the flash kernel on the
card) at S = patches + 2."""
from __future__ import annotations

import torch
from torch import nn

from ...core import init as I
from ...nn.layers import Linear
from .vision_transformer import VisionTransformer

__all__ = ["DistilledVisionTransformer", "deit_tiny", "deit_small",
           "deit_base", "dvt", "distilled_vision_transformer"]


class DistilledVisionTransformer(VisionTransformer):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        kw = dict(device=self.cls_token.device,
                  generator=kwargs.get("generator"))
        n = self.patch_embed.num_patches
        self.dist_token = nn.Parameter(
            I.truncated_normal((1, 1, self.embed_dim), std=0.02, **kw))
        self.pos_embed = nn.Parameter(
            I.truncated_normal((1, n + 2, self.embed_dim), std=0.02, **kw))
        self.head_dist = Linear(self.embed_dim, self.num_classes, **kw)

    def forward_features(self, x):
        b = x.shape[0]
        x = self.patch_embed(x)
        cls = self.cls_token.to(x.dtype).expand(b, 1, self.embed_dim)
        dist = self.dist_token.to(x.dtype).expand(b, 1, self.embed_dim)
        x = torch.cat([cls, dist, x], dim=1)
        x = self.pos_drop(x + self.pos_embed.to(x.dtype))
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        return x[:, 0], x[:, 1]

    def forward(self, x):
        feat, feat_dist = self.forward_features(x)
        return (self.head(feat) + self.head_dist(feat_dist)) / 2


def _deit(kw, embed_dim, num_heads):
    return DistilledVisionTransformer(**{
        "embed_dim": embed_dim, "depth": 12, "num_heads": num_heads,
        "qkv_bias": True, **kw})


def deit_tiny(pretrained=False, **kw):
    return _deit(kw, 192, 3)


def deit_small(pretrained=False, **kw):
    return _deit(kw, 384, 6)


def deit_base(pretrained=False, **kw):
    return _deit(kw, 768, 12)


def dvt(pretrained=False, **kw):
    """Distilled ViT base: an alias of ``deit_base``."""
    return deit_base(pretrained=pretrained, **kw)


distilled_vision_transformer = dvt
