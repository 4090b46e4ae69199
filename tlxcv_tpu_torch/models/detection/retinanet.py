"""RetinaNet (counterpart of ``tlxcv_tpu/models/detection/retinanet.py``),
NHWC, to PaddleDetection's ``retinanet_r50_fpn_1x_coco``: a ResNet-50, the
P3-P7 FPN with P6 taken from C5 (``FPNP3P7(extra_on_input=True)``), 9
anchors a cell (3 octave scales x 3 ratios, base side 4 strides), two
shared 4-conv towers, the classifier's bias at the focal prior.

Eval returns ``(dets [B, keep_top_k, 6], counts [B])``: deltas decoded
against the anchors (weights 10, 10, 5, 5), clipped, sigmoid scores, the
class-aware ``multiclass_nms``.  Training (``module.training``) returns the
head's outputs and the anchors for ``loss_fn``: ``retina_match`` per image
(IoU 0.5 positive, 0.4-0.5 ignored, each GT's best anchor forced
positive), sigmoid focal loss and smooth-L1 over the number of positives.

No kernel of ours runs here: the FPN merges by ``fcos._resize_nearest``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn as tnn

from ... import nn
from ...core import init as I
from ...device import resolve_device
from ...ops.boxes import bbox2delta, clip_boxes, delta2bbox, pairwise_iou
from ...ops.losses import sigmoid_focal_loss, smooth_l1_loss
from ...ops.nms import multiclass_nms
from ..classification.resnet import ResNet
from .fcos import FPNP3P7, _normal_001, ground_truth

__all__ = ["RetinaNet", "RetinaNetHead", "retina_match", "retinanet_r50"]

STRIDES = (8, 16, 32, 64, 128)
OCTAVES = (1.0, 2 ** (1 / 3), 2 ** (2 / 3))
RATIOS = (0.5, 1.0, 2.0)


def _retina_anchors(feat_hws, strides=STRIDES, octave_base_scale=4,
                    ratios=RATIOS, octaves=OCTAVES):
    """Anchors [A, 4] xyxy (numpy f32) over every level, row-major over
    each level's grid, 9 a cell (octaves outer, ratios inner)."""
    out = []
    for (h, w), s in zip(feat_hws, strides):
        base = octave_base_scale * s
        wh = np.asarray([(base * o * math.sqrt(r), base * o / math.sqrt(r))
                         for o in octaves for r in ratios], np.float32)
        cx = (np.arange(w, dtype=np.float32) + 0.5) * s
        cy = (np.arange(h, dtype=np.float32) + 0.5) * s
        cxg, cyg = np.meshgrid(cx, cy)
        centers = np.stack([cxg, cyg], -1).reshape(-1, 1, 2)
        boxes = np.concatenate([centers - wh[None] / 2,
                                centers + wh[None] / 2], -1)
        out.append(boxes.reshape(-1, 4))
    return np.concatenate(out)


class RetinaNetHead(tnn.Module):
    """Two towers of ``num_convs`` 3x3 convs with ReLU, shared over the
    levels; per cell ``num_anchors`` x C class logits and x 4 deltas, all
    convs at normal(0.01)."""

    def __init__(self, in_ch=256, num_classes=80, num_anchors=9,
                 num_convs=4, prior_prob=0.01, device=None, generator=None):
        super().__init__()
        kw = dict(w_init=_normal_001, device=device, generator=generator)
        self.cls_tower = tnn.ModuleList([
            nn.Conv2d(in_ch, in_ch, 3, padding=1, **kw)
            for _ in range(num_convs)])
        self.reg_tower = tnn.ModuleList([
            nn.Conv2d(in_ch, in_ch, 3, padding=1, **kw)
            for _ in range(num_convs)])
        bias = -math.log((1 - prior_prob) / prior_prob)
        self.cls_pred = nn.Conv2d(
            in_ch, num_anchors * num_classes, 3, padding=1,
            b_init=lambda s, **k: I.constant(s, bias, **k), **kw)
        self.reg_pred = nn.Conv2d(in_ch, num_anchors * 4, 3, padding=1, **kw)
        self.num_classes = num_classes
        self.num_anchors = num_anchors

    def forward(self, feats):
        """-> class logits [N, A, C], deltas [N, A, 4] over every level."""
        cls_l, reg_l = [], []
        for f in feats:
            c = r = f
            for conv in self.cls_tower:
                c = nn.relu(conv(c))
            for conv in self.reg_tower:
                r = nn.relu(conv(r))
            n = f.shape[0]
            cls_l.append(self.cls_pred(c).reshape(n, -1, self.num_classes))
            reg_l.append(self.reg_pred(r).reshape(n, -1, 4))
        return torch.cat(cls_l, 1), torch.cat(reg_l, 1)


def retina_match(anchors, gt_boxes, gt_labels, gt_valid, pos_iou=0.5,
                 neg_iou=0.4):
    """One image's anchor matching: anchors [A, 4], gt_boxes [M, 4],
    gt_valid [M].  Returns (matched GT [A], positive [A], ignored [A]): an
    anchor whose best IoU reaches ``pos_iou`` is positive, one in
    [``neg_iou``, ``pos_iou``) ignored; each valid GT's best anchor is
    forced positive and matched to that GT (``gt_labels`` is the
    reference's argument, unused)."""
    iou = torch.where(gt_valid[:, None] > 0, pairwise_iou(gt_boxes, anchors),
                      -1.0)                                  # [M, A]
    best_gt, best_iou = iou.argmax(0), iou.amax(0)
    pos = best_iou >= pos_iou
    ignore = (best_iou >= neg_iou) & ~pos
    a_n, m = anchors.shape[0], gt_boxes.shape[0]
    # each valid GT's best anchor; a padded GT names the sentinel a_n
    idx = torch.where(gt_valid > 0, iou.argmax(1), a_n)
    force = torch.zeros(a_n + 1, dtype=torch.bool, device=iou.device)
    force = force.index_fill(0, idx, True)[:a_n]
    best_gt = torch.cat([best_gt, best_gt.new_zeros(1)]).scatter(
        0, idx, torch.arange(m, device=iou.device))[:a_n]
    pos = pos | force
    return best_gt, pos, ignore & ~pos


class RetinaNet(tnn.Module):
    """The detector: backbone C3-C5, ``FPNP3P7`` with P6 on C5,
    ``RetinaNetHead``; eval keeps score 0.05, IoU 0.5, top 1000, keep
    100."""

    def __init__(self, num_classes=80, backbone=None, score_threshold=0.05,
                 nms_threshold=0.5, nms_top_k=1000, keep_top_k=100,
                 delta_weights=(10.0, 10.0, 5.0, 5.0), device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.backbone = backbone if backbone is not None else ResNet(
            depth=50, num_classes=0, with_pool=False, **kw)
        self.neck = FPNP3P7(self.backbone.feat_channels[1:], 256,
                            extra_on_input=True, **kw)
        self.head = RetinaNetHead(256, num_classes, **kw)
        self.num_classes = num_classes
        self.delta_weights = delta_weights
        self.nms_cfg = dict(score_threshold=score_threshold,
                            nms_threshold=nms_threshold,
                            nms_top_k=nms_top_k, keep_top_k=keep_top_k)
        self._anchor_cache = {}

    def anchors(self, feat_hws, device):
        """[A, 4] anchors on ``device``, made once per pyramid shape."""
        key = (tuple(feat_hws), device)
        if key not in self._anchor_cache:
            self._anchor_cache[key] = torch.from_numpy(
                _retina_anchors(key[0])).to(device)
        return self._anchor_cache[key]

    def head_outputs(self, images):
        """(class logits [N, A, C], deltas [N, A, 4], the levels' (H, W))."""
        feats = self.neck(self.backbone.features(images)[1:])
        cls, reg = self.head(feats)
        return cls, reg, tuple(tuple(f.shape[1:3]) for f in feats)

    def forward(self, images):
        cls, reg, feat_hws = self.head_outputs(images)
        anchors = self.anchors(feat_hws, images.device)
        image_hw = tuple(images.shape[1:3])
        if self.training:
            return {"cls_logits": cls, "deltas": reg, "anchors": anchors,
                    "image_hw": image_hw}
        return self.nms(*self.decode(cls, reg, anchors, image_hw))

    def decode(self, cls, reg, anchors, image_hw):
        """Boxes [N, A, 4] f32 clipped to the image, scores [N, A, C]."""
        boxes = delta2bbox(reg.float(), anchors, weights=self.delta_weights)
        return clip_boxes(boxes, image_hw), torch.sigmoid(cls.float())

    def nms(self, boxes, scores):
        return multiclass_nms(boxes, scores, **self.nms_cfg)

    def loss_fn(self, outputs, targets):
        """targets: ``boxes`` [B, M, 4] xyxy pixels, ``class_labels`` [B,
        M], optional ``mask`` [B, M] (default: boxes of positive width)."""
        gt_boxes, gt_labels, gt_valid = ground_truth(targets)
        anchors = outputs["anchors"]
        with torch.no_grad():
            best_gt, pos, ignore = (torch.stack(t) for t in zip(*(
                retina_match(anchors, bx, lb, vd)
                for bx, lb, vd in zip(gt_boxes, gt_labels, gt_valid))))
            t_label = torch.where(pos, gt_labels.gather(1, best_gt),
                                  self.num_classes)
            onehot = F.one_hot(t_label, self.num_classes + 1)[
                ..., :self.num_classes].float()
            matched = gt_boxes.gather(1, best_gt[..., None].expand(
                *best_gt.shape, 4))
            t_delta = bbox2delta(anchors.expand_as(matched), matched,
                                 weights=self.delta_weights)
        focal = sigmoid_focal_loss(outputs["cls_logits"].float(),
                                   onehot).sum(-1)
        num_pos = pos.sum().float().clamp_min(1.0)
        cls_loss = torch.where(ignore, 0.0, focal).sum() / num_pos
        reg = smooth_l1_loss(outputs["deltas"].float(), t_delta,
                             reduction="none").sum(-1)
        return cls_loss + torch.where(pos, reg, 0.0).sum() / num_pos


def retinanet_r50(num_classes=80, **kwargs):
    return RetinaNet(num_classes=num_classes, **kwargs)
