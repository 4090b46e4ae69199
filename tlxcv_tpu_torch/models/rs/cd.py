"""Remote-sensing change detection (counterpart of
``tlxcv_tpu/models/rs/cd.py``), NHWC: BIT so far.  A change detector is
called as ``model(t1, t2)`` and returns change logits [B, H, W, classes] at
the input's size.

BIT's attention runs at head dim 4 (width 32 over 8 heads): 17 calls of
``ops.cuda.attention.flash_attention`` a forward, one in the token
encoder and one in each of the 8 decoder layers for each of the two
images.  On the card the wrapper pads the head dim to the kernel's 32.
"""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...device import resolve_device
from ...nn.attention import MultiHeadAttention
from ...ops.image import interpolate
from ..classification.resnet import ResNet
from ..detection.detr import DetrAttention
from .layers import Conv1x1, Conv3x3

__all__ = ["BIT"]

_gelu = nn.get_activation("gelu")  # jax.nn.gelu: the tanh approximation


class _TransformerLayer(tnn.Module):
    def __init__(self, dim, heads, mlp_dim, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.norm1 = nn.LayerNorm(dim, device=device)
        self.attn = MultiHeadAttention(dim, heads, qkv_bias=True, **kw)
        self.norm2 = nn.LayerNorm(dim, device=device)
        self.fc1 = nn.Linear(dim, mlp_dim, **kw)
        self.fc2 = nn.Linear(mlp_dim, dim, **kw)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.fc2(_gelu(self.fc1(self.norm2(x))))


class _CrossTransformerLayer(tnn.Module):
    """Pixels (queries) attend to the semantic tokens (keys and values,
    not normalised)."""

    def __init__(self, dim, heads, mlp_dim, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.norm1 = nn.LayerNorm(dim, device=device)
        self.attn = DetrAttention(dim, heads, **kw)
        self.norm2 = nn.LayerNorm(dim, device=device)
        self.fc1 = nn.Linear(dim, mlp_dim, **kw)
        self.fc2 = nn.Linear(mlp_dim, dim, **kw)

    def forward(self, x, m):
        x = x + self.attn(self.norm1(x), m, m)
        return x + self.fc2(_gelu(self.fc1(self.norm2(x))))


class BIT(tnn.Module):
    """Bitemporal image transformer: a ResNet-18 to stride 8, ``token_len``
    semantic tokens an image (a softmax over the pixels), a token encoder
    over both images' tokens, a decoder taking each image's pixels to its
    tokens, and a head over the absolute difference, upsampled to the
    input's size."""

    def __init__(self, in_channels=3, num_classes=2, token_len=4, dim=32,
                 enc_depth=1, dec_depth=8, heads=8, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.backbone = ResNet(depth=18, num_classes=0, with_pool=False,
                               **kw)
        self.conv_squeeze = Conv3x3(self.backbone.feat_channels[1], dim,
                                    norm=True, act=True, **kw)
        self.token_len = token_len
        self.conv_att = Conv1x1(dim, token_len, **kw)
        self.encoder = tnn.ModuleList([
            _TransformerLayer(dim, heads, dim * 2, **kw)
            for _ in range(enc_depth)])
        self.decoder = tnn.ModuleList([
            _CrossTransformerLayer(dim, heads, dim * 2, **kw)
            for _ in range(dec_depth)])
        self.head = nn.Sequential(Conv3x3(dim, dim, norm=True, act=True, **kw),
                                  Conv3x3(dim, num_classes, **kw))

    def _features(self, x):
        return self.conv_squeeze(self.backbone.features(x)[1])  # stride 8

    def _tokens(self, x):
        b, h, w, c = x.shape
        att = torch.softmax(
            self.conv_att(x).reshape(b, h * w, self.token_len), 1)
        return torch.einsum("bnt,bnc->btc", att, x.reshape(b, h * w, c))

    def forward(self, t1, t2):
        x1 = self._features(t1)
        x2 = self._features(t2)
        tokens = torch.cat([self._tokens(x1), self._tokens(x2)], 1)
        for layer in self.encoder:
            tokens = layer(tokens)
        tok1, tok2 = tokens.chunk(2, 1)
        b, h, w, c = x1.shape

        def decode(x, tok):
            seq = x.reshape(b, h * w, c)
            for layer in self.decoder:
                seq = layer(seq, tok)
            return seq.reshape(b, h, w, c)

        diff = (decode(x1, tok1) - decode(x2, tok2)).abs()
        diff = interpolate(diff, size=t1.shape[1:3], mode="bilinear")
        return self.head(diff)
