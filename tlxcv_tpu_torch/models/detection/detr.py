"""DETR, the serving half (counterpart of
``tlxcv_tpu/models/detection/detr.py``): a ResNet backbone with frozen
BatchNorms, a 1x1 input projection, the post-norm transformer encoder and
decoder with sine position embeddings, and the class and box heads.  NHWC
images, the JAX model's attribute names.

Every attention goes through ``nn.attention.scaled_dot_product_attention``
and so, on the card, through the hand-written flash kernel
(``csrc/flash_attention.cu``): per forward one call in each encoder layer
(Sq = Sk = H·W), and two in each decoder layer, self-attention over the
queries (Sq = Sk = num_queries) and cross-attention from the queries to the
memory (Sq = num_queries, Sk = H·W) — 18 for DETR-R50's 6 + 6 layers.  The
heads are split as strided ``[B, H, S, D]`` views, which the kernel reads
in place.

Training (the Hungarian matcher and ``DetrLoss``) belongs to the training
slice; it also needs a backward for the flash kernel.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn as tnn

from ... import nn
from ...core import init as I
from ...device import resolve_device
from ...nn.attention import scaled_dot_product_attention
from ...ops.boxes import xywh2xyxy
from ..classification.resnet import ResNet

__all__ = ["Detr", "FrozenBatchNorm", "detr_resnet50",
           "sine_position_embedding"]


class FrozenBatchNorm(tnn.Module):
    """BatchNorm with all four tensors frozen.  They are buffers, not
    parameters (the reference's ``BatchStat``s): a cast of the parameters
    to bf16 leaves them in f32."""

    def __init__(self, n, device=None):
        super().__init__()
        for name, init in (("weight", I.ones), ("bias", I.zeros),
                           ("running_mean", I.zeros),
                           ("running_var", I.ones)):
            self.register_buffer(name, init((n,), device=device))

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + 1e-5)
        bias = self.bias - self.running_mean * scale
        return x * scale.to(x.dtype) + bias.to(x.dtype)


def _make_resnet_backbone(depth=50, freeze_bn=True, device=None,
                          generator=None):
    """The ported ResNet without head or pool.  With ``freeze_bn`` each
    BatchNorm that is a module's attribute is swapped for a
    ``FrozenBatchNorm`` under the same name, as the reference swaps them;
    the reference's swap does not reach into lists, so the BatchNorm of
    each downsample branch (``downsample.layers.1``) stays a trainable
    BatchNorm here too (the same function in eval)."""
    model = ResNet(depth=depth, num_classes=0, with_pool=False, device=device,
                   generator=generator)
    if freeze_bn:
        for mod in list(model.modules()):
            if isinstance(mod, tnn.ModuleList):
                continue
            for name, child in list(mod.named_children()):
                if isinstance(child, nn.BatchNorm):
                    setattr(mod, name, FrozenBatchNorm(
                        child.running_mean.shape[0], device=device))
    return model


def sine_position_embedding(h, w, dim=256, temperature=10000.0):
    """2D sine embeddings [H, W, dim], numpy f32."""
    half = dim // 2
    ys = (np.arange(h, dtype=np.float32) + 1.0)[:, None]
    xs = (np.arange(w, dtype=np.float32) + 1.0)[None, :]
    eps = 1e-6
    ys = ys / (h + eps) * 2 * math.pi
    xs = xs / (w + eps) * 2 * math.pi
    dim_t = temperature ** (2 * (np.arange(half // 2)) / half)
    pos_x = xs[..., None] / dim_t
    pos_y = np.broadcast_to(ys[..., None] / dim_t, (h, w, half // 2))
    pos_x = np.broadcast_to(pos_x, (h, w, half // 2))
    emb = np.concatenate([
        np.stack([np.sin(pos_y), np.cos(pos_y)], -1).reshape(h, w, -1),
        np.stack([np.sin(pos_x), np.cos(pos_x)], -1).reshape(h, w, -1),
    ], axis=-1)
    return emb.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _position_embedding(h, w, dim, device, dtype):
    """``sine_position_embedding`` as a [1, H·W, dim] tensor, built once
    per size, device and dtype."""
    with torch.inference_mode(False):  # usable outside inference too
        emb = torch.from_numpy(sine_position_embedding(h, w, dim))
        return emb.reshape(1, h * w, dim).to(device, dtype)


class DetrAttention(tnn.Module):
    """Multi-head attention with separate q, k, v projections and the
    position embeddings added to the queries and keys."""

    def __init__(self, dim, num_heads, dropout=0.0, device=None,
                 generator=None):
        super().__init__()
        kw = dict(w_init=I.xavier_uniform, device=device, generator=generator)
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.q = nn.Linear(dim, dim, **kw)
        self.k = nn.Linear(dim, dim, **kw)
        self.v = nn.Linear(dim, dim, **kw)
        self.out = nn.Linear(dim, dim, **kw)
        self.drop = nn.Dropout(dropout)

    def _split(self, x):
        """[B, N, C] -> a [B, H, N, D] view, no copy."""
        b, n, _ = x.shape
        return x.view(b, n, self.num_heads, self.head_dim).transpose(1, 2)

    def forward(self, q, k, v, q_pos=None, k_pos=None):
        qq = self.q(q if q_pos is None else q + q_pos)
        kk = self.k(k if k_pos is None else k + k_pos)
        vv = self.v(v)
        out = scaled_dot_product_attention(self._split(qq), self._split(kk),
                                           self._split(vv))
        b, h, n, d = out.shape
        out = out.transpose(1, 2).reshape(b, n, h * d)
        return self.drop(self.out(out))


class EncoderLayer(tnn.Module):
    def __init__(self, dim=256, heads=8, ffn=2048, dropout=0.1, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.attn = DetrAttention(dim, heads, dropout, **kw)
        self.norm1 = nn.LayerNorm(dim, device=device)
        self.fc1 = nn.Linear(dim, ffn, **kw)
        self.fc2 = nn.Linear(ffn, dim, **kw)
        self.norm2 = nn.LayerNorm(dim, device=device)
        self.drop = nn.Dropout(dropout)

    def forward(self, x, pos):
        x = self.norm1(x + self.attn(x, x, x, q_pos=pos, k_pos=pos))
        y = self.fc2(self.drop(nn.relu(self.fc1(x))))
        return self.norm2(x + self.drop(y))


class DecoderLayer(tnn.Module):
    def __init__(self, dim=256, heads=8, ffn=2048, dropout=0.1, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.self_attn = DetrAttention(dim, heads, dropout, **kw)
        self.norm1 = nn.LayerNorm(dim, device=device)
        self.cross_attn = DetrAttention(dim, heads, dropout, **kw)
        self.norm2 = nn.LayerNorm(dim, device=device)
        self.fc1 = nn.Linear(dim, ffn, **kw)
        self.fc2 = nn.Linear(ffn, dim, **kw)
        self.norm3 = nn.LayerNorm(dim, device=device)
        self.drop = nn.Dropout(dropout)

    def forward(self, q, memory, q_pos, mem_pos):
        q = self.norm1(q + self.self_attn(q, q, q, q_pos=q_pos, k_pos=q_pos))
        q = self.norm2(q + self.cross_attn(q, memory, memory, q_pos=q_pos,
                                           k_pos=mem_pos))
        y = self.fc2(self.drop(nn.relu(self.fc1(q))))
        return self.norm3(q + self.drop(y))


class MLP(tnn.Module):
    def __init__(self, in_dim, hidden, out_dim, layers=3, device=None,
                 generator=None):
        super().__init__()
        dims = [in_dim] + [hidden] * (layers - 1) + [out_dim]
        self.layers = tnn.ModuleList([
            nn.Linear(a, b, device=device, generator=generator)
            for a, b in zip(dims[:-1], dims[1:])])

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = nn.relu(x)
        return x


class Detr(tnn.Module):
    """The detector.  Eval: ``forward`` returns the last decoder layer's
    ``{"logits": [B, Q, C + 1], "boxes": [B, Q, 4]}`` (boxes normalized
    cxcywh after a sigmoid); train mode returns every decoder layer's
    (``aux_loss``) or the last one's in a list.  ``freeze_bn=True`` is the
    reference's semantics and assumes trained backbone weights.  The
    reference's ``matcher`` belongs to its loss and comes with it."""

    def __init__(self, num_classes=91, num_queries=100, dim=256, heads=8,
                 enc_layers=6, dec_layers=6, ffn=2048, dropout=0.1,
                 aux_loss=True, backbone_depth=50, freeze_bn=True,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.backbone = _make_resnet_backbone(backbone_depth, freeze_bn, **kw)
        c5 = 512 if backbone_depth in (18, 34) else 2048
        self.input_proj = nn.Conv2d(c5, dim, 1, **kw)
        self.query_embed = tnn.Parameter(
            I.normal((num_queries, dim), std=1.0, **kw))
        layer = dict(dim=dim, heads=heads, ffn=ffn, dropout=dropout, **kw)
        self.encoder = tnn.ModuleList([EncoderLayer(**layer)
                                       for _ in range(enc_layers)])
        self.decoder = tnn.ModuleList([DecoderLayer(**layer)
                                       for _ in range(dec_layers)])
        self.dec_norm = nn.LayerNorm(dim, device=device)
        self.class_head = nn.Linear(dim, num_classes + 1, **kw)
        self.bbox_head = MLP(dim, dim, 4, **kw)
        self.num_classes = num_classes
        self.num_queries = num_queries
        self.dim = dim
        self.aux_loss = aux_loss

    def encode(self, images):
        """(memory [B, H·W, dim], position embeddings [1, H·W, dim])."""
        feats = self.backbone.features(images)[-1]  # C5
        x = self.input_proj(feats)
        b, h, w, c = x.shape
        pos = _position_embedding(h, w, self.dim, x.device, x.dtype)
        src = x.reshape(b, h * w, c)
        for layer in self.encoder:
            src = layer(src, pos)
        return src, pos

    def decode(self, memory, pos):
        """Every decoder layer's normalized output [B, Q, dim] (the last
        one's alone in eval)."""
        b = memory.shape[0]
        q_pos = self.query_embed[None].expand(
            b, self.num_queries, self.dim).to(memory.dtype)
        q = torch.zeros_like(q_pos)
        inter = []
        for i, layer in enumerate(self.decoder):
            q = layer(q, memory, q_pos, pos)
            if self.training or i == len(self.decoder) - 1:
                inter.append(self.dec_norm(q))
        return inter

    def heads(self, feat):
        return {"logits": self.class_head(feat),
                "boxes": torch.sigmoid(self.bbox_head(feat))}

    def forward(self, images):
        outputs = [self.heads(f) for f in self.decode(*self.encode(images))]
        if self.training:
            return outputs if self.aux_loss else outputs[-1:]
        return outputs[-1]

    def loss_fn(self, outputs, targets):
        raise NotImplementedError(
            "DETR training (the Hungarian matcher, ops/hungarian.py, and "
            "DetrLoss) is not ported yet: ROADMAP queue 1, item 5 (training "
            "path); on the card it also needs queue 2 item 2 (a backward "
            "for flash attention)")

    def predict_boxes(self, output, image_hw):
        """Top-scoring class per query: (labels, scores, xyxy pixels)."""
        probs = torch.softmax(output["logits"], -1)[..., :-1]
        scores, labels = probs.max(-1)
        h, w = image_hw
        scale = torch.tensor([w, h, w, h], dtype=torch.float32,
                             device=probs.device)
        return labels, scores, xywh2xyxy(output["boxes"]) * scale


def detr_resnet50(num_classes=91, **kw):
    return Detr(num_classes=num_classes, **kw)
