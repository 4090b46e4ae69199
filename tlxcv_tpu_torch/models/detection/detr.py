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

Training: ``DetrLoss``, the reference's Hungarian-matched CE + L1 + GIoU,
summed over the decoder layers with ``aux_loss``.  The match runs on the
host through scipy (``ops.hungarian.hungarian_callback``, ``matcher=
"callback"``, which ``"auto"`` resolves to here: the reference's relay
fallback has no counterpart) or on the device (``"auction"``).  On the card
the attention's backward is the flash backward kernel
(``csrc/flash_attention_bwd.cu``), 18 calls a training step.
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
from ...ops.boxes import aligned_iou, xywh2xyxy
from ...ops.hungarian import auction_assign, hungarian_callback
from ..classification.resnet import ResNet

__all__ = ["Detr", "DetrLoss", "FrozenBatchNorm", "detr_resnet50",
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
    reference's semantics and assumes trained backbone weights.
    ``matcher`` is ``DetrLoss``'s."""

    def __init__(self, num_classes=91, num_queries=100, dim=256, heads=8,
                 enc_layers=6, dec_layers=6, ffn=2048, dropout=0.1,
                 aux_loss=True, matcher="auto", backbone_depth=50,
                 freeze_bn=True, device=None, generator=None):
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
        self.loss = DetrLoss(num_classes, matcher=matcher)

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
        """``DetrLoss`` of the last decoder layer's outputs, summed over
        every layer's with ``aux_loss``."""
        if isinstance(outputs, dict):
            outputs = [outputs]
        total = 0.0
        for out in outputs if self.aux_loss else outputs[-1:]:
            total = total + self.loss(out["logits"], out["boxes"], targets)
        return total

    def predict_boxes(self, output, image_hw):
        """Top-scoring class per query: (labels, scores, xyxy pixels)."""
        probs = torch.softmax(output["logits"], -1)[..., :-1]
        scores, labels = probs.max(-1)
        h, w = image_hw
        scale = torch.tensor([w, h, w, h], dtype=torch.float32,
                             device=probs.device)
        return labels, scores, xywh2xyxy(output["boxes"]) * scale


class DetrLoss:
    """Hungarian-matched cross-entropy + L1 + GIoU (the reference's
    ``DetrLoss``).  Targets: ``boxes`` [B, M, 4] normalized cxcywh,
    ``class_labels`` [B, M] and ``mask`` [B, M] (1 = real; without it a
    box of zero width is padding).  Padded GT rows carry a constant cost
    and are left out of every term."""

    def __init__(self, num_classes, eos_coef=0.1, cost_class=1.0,
                 cost_bbox=5.0, cost_giou=2.0, w_class=1.0, w_bbox=5.0,
                 w_giou=2.0, matcher="auto"):
        if matcher not in ("auto", "callback", "auction"):
            raise ValueError(f"unknown matcher {matcher!r}")
        self.num_classes = num_classes
        self.eos_coef = eos_coef
        self.costs = (cost_class, cost_bbox, cost_giou)
        self.weights = (w_class, w_bbox, w_giou)
        self.matcher = matcher

    def _match(self, cost):
        """[B, M, Q] cost -> [B, M] query per GT (int32, -1 unmatched):
        scipy's exact assignment on the host (``"callback"``, which
        ``"auto"`` is here) or the device auction (``"auction"``)."""
        if self.matcher == "auction":
            return auction_assign(cost, num_iters=200)
        return hungarian_callback(cost)

    def __call__(self, logits, pred_boxes, targets):
        gt_boxes = targets["boxes"]
        gt_labels = targets["class_labels"].long()
        mask = targets.get("mask")
        if mask is None:
            mask = (gt_boxes[..., 2] > 0).float()
        b, q = logits.shape[:2]
        m = gt_boxes.shape[1]
        cc, cb, cg = self.costs

        prob = torch.softmax(logits, -1)                      # [B, Q, C+1]
        cost_class = -torch.gather(prob, -1,
                                   gt_labels[:, None, :].expand(b, q, m))
        cost_bbox = (pred_boxes[:, :, None, :]
                     - gt_boxes[:, None, :, :]).abs().sum(-1)
        gxyxy = xywh2xyxy(gt_boxes)
        cost_giou = -aligned_iou(xywh2xyxy(pred_boxes)[:, :, None, :],
                                 gxyxy[:, None, :, :], mode="giou")
        cost = cc * cost_class + cb * cost_bbox + cg * cost_giou
        cost = torch.where(mask[:, None, :] > 0, cost, 1e6)
        assign = self._match(cost.transpose(1, 2).detach()).long()  # [B, M]

        # assigned queries take their GT's class, the rest no-object; a GT
        # the auction left unmatched (-1) takes no query.  The writes of
        # padded or unmatched GTs go to one extra column, sliced off.
        valid = (mask > 0) & (assign >= 0)
        safe = torch.where(valid, assign, q)
        tgt_class = torch.full((b, q + 1), self.num_classes,
                               dtype=torch.long, device=logits.device)
        tgt_class = tgt_class.scatter(1, safe, gt_labels)[:, :q]
        logp = torch.log_softmax(logits, -1)
        ce = -torch.gather(logp, -1, tgt_class[..., None])[..., 0]
        cls_w = torch.where(tgt_class == self.num_classes,
                            torch.full_like(ce, self.eos_coef),
                            torch.ones_like(ce))
        loss_ce = (ce * cls_w).sum() / cls_w.sum()

        # box losses on the matched pairs
        vmask = valid.to(gt_boxes.dtype)
        matched = torch.gather(pred_boxes, 1,
                               safe.clamp(0, q - 1)[..., None].expand(b, m, 4))
        num_boxes = mask.sum().clamp_min(1.0)
        l1 = ((matched - gt_boxes).abs().sum(-1) * vmask).sum() / num_boxes
        giou = ((1.0 - aligned_iou(xywh2xyxy(matched), gxyxy, mode="giou"))
                * vmask).sum() / num_boxes
        wc, wb, wg = self.weights
        return wc * loss_ce + wb * l1 + wg * giou


def detr_resnet50(num_classes=91, **kw):
    return Detr(num_classes=num_classes, **kw)
