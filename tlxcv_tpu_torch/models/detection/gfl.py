"""GFL, the Generalized Focal Loss detector (counterpart of
``tlxcv_tpu/models/detection/gfl.py``), NHWC, to mmdet's ``gfl_r50_fpn_1x``:
a ResNet-50, the P3-P7 FPN, FCOS's two 4-conv GroupNorm towers, one square
anchor a cell (side 8 strides), a learned scale per level on the box
branch, which is a distribution: 4 x (``reg_max`` + 1) logits a cell whose
softmax expectation (``integral``) is each side's distance in strides.

Eval returns ``(dets [B, keep_top_k, 6], counts [B])``: the expected
distances times the stride from each cell's centre, clipped, sigmoid
scores, the class-aware ``multiclass_nms``.  Training returns the head's
outputs for ``loss_fn``: ATSS (``ppyoloe.atss_assign``) with the IoU of the
prediction and its GT as the quality target, the quality focal loss, GIoU
and the distribution focal loss, each over the summed quality.

No kernel of ours runs here.
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
from ...ops.boxes import aligned_iou, bbox2distance, distance2bbox
from ...ops.nms import multiclass_nms
from ..classification.resnet import ResNet
from .fcos import FPNP3P7, _normal_001, _Scale, ground_truth
from .ppyoloe import atss_assign

__all__ = ["GFL", "GFLHead", "gfl_r50", "integral"]

STRIDES = (8, 16, 32, 64, 128)


def _cell_anchors(feat_hws, strides=STRIDES, scale=8):
    """One square anchor a cell, side ``scale`` strides: anchors [A, 4]
    xyxy (numpy f32) and each level's count."""
    out, counts = [], []
    for (h, w), s in zip(feat_hws, strides):
        cx = (np.arange(w, dtype=np.float32) + 0.5) * s
        cy = (np.arange(h, dtype=np.float32) + 0.5) * s
        cxg, cyg = np.meshgrid(cx, cy)
        centers = np.stack([cxg, cyg], -1).reshape(-1, 2)
        half = scale * s / 2.0
        out.append(np.concatenate([centers - half, centers + half], -1))
        counts.append(len(centers))
    return np.concatenate(out), counts


class GFLHead(tnn.Module):
    """FCOS's towers (3x3 conv, GroupNorm(32), ReLU; one list each), the
    classifier at the prior and the distribution logits, each 3x3 at
    normal(0.01), the latter times a learned scale per level."""

    def __init__(self, in_ch=256, num_classes=80, num_convs=4, reg_max=16,
                 num_levels=len(STRIDES), prior_prob=0.01, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)

        def tower():
            convs = []
            for _ in range(num_convs):
                convs.append(nn.Conv2d(in_ch, in_ch, 3, padding=1,
                                       w_init=_normal_001, **kw))
                convs.append(nn.GroupNorm(32, in_ch, device=device))
            return tnn.ModuleList(convs)

        self.cls_tower = tower()
        self.reg_tower = tower()
        bias = -math.log((1 - prior_prob) / prior_prob)
        self.cls_pred = nn.Conv2d(
            in_ch, num_classes, 3, padding=1, w_init=_normal_001,
            b_init=lambda s, **k: I.constant(s, bias, **k), **kw)
        self.reg_pred = nn.Conv2d(in_ch, 4 * (reg_max + 1), 3, padding=1,
                                  w_init=_normal_001, **kw)
        self.scales = tnn.ModuleList([_Scale(device=device)
                                      for _ in range(num_levels)])
        self.reg_max = reg_max
        self.num_classes = num_classes

    @staticmethod
    def _run(tower, x):
        for i in range(0, len(tower), 2):
            x = nn.relu(tower[i + 1](tower[i](x)))
        return x

    def forward(self, feats):
        """Per level: (class logits [N, H, W, C], distribution logits [N,
        H, W, 4 (reg_max + 1)])."""
        outs = []
        for scale, f in zip(self.scales, feats):
            c = self._run(self.cls_tower, f)
            r = self._run(self.reg_tower, f)
            outs.append((self.cls_pred(c), scale(self.reg_pred(r))))
        return outs


def integral(dist_logits, reg_max):
    """[..., 4 (reg_max + 1)] logits -> [..., 4] expected distances in bins:
    the softmax over each side's bins times 0..reg_max."""
    p = torch.softmax(dist_logits.reshape(*dist_logits.shape[:-1], 4,
                                          reg_max + 1), -1)
    return p @ torch.arange(reg_max + 1, dtype=p.dtype, device=p.device)


def _dfl(dist, t_dist, reg_max):
    """The distribution focal loss a cell, the mean over its 4 sides: the
    cross-entropy of the two bins around each target distance (in bins,
    within [0, reg_max - 0.1]), weighted by its nearness to each."""
    logp = torch.log_softmax(dist.reshape(*dist.shape[:-1], 4, reg_max + 1),
                             -1)
    lo = torch.floor(t_dist).long()
    hi = lo + 1
    wl = hi.float() - t_dist
    ce_lo = -logp.gather(-1, lo[..., None])[..., 0]
    ce_hi = -logp.gather(-1, hi.clamp(0, reg_max)[..., None])[..., 0]
    return (wl * ce_lo + (1.0 - wl) * ce_hi).mean(-1)


def _quality_bce(cls, t):
    """Sigmoid BCE of logits ``cls`` against soft targets ``t``, in the
    reference's stable form."""
    return (cls.clamp_min(0) - cls * t
            + torch.log1p(torch.exp(-cls.abs())))


class GFL(tnn.Module):
    """The detector: backbone C3-C5, ``FPNP3P7``, ``GFLHead``; eval keeps
    score 0.025, IoU 0.6, top 1000, keep 100."""

    def __init__(self, num_classes=80, backbone=None, reg_max=16,
                 score_threshold=0.025, nms_threshold=0.6, nms_top_k=1000,
                 keep_top_k=100, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.backbone = backbone if backbone is not None else ResNet(
            depth=50, num_classes=0, with_pool=False, **kw)
        self.neck = FPNP3P7(self.backbone.feat_channels[1:], 256, **kw)
        self.head = GFLHead(256, num_classes, reg_max=reg_max, **kw)
        self.num_classes = num_classes
        self.reg_max = reg_max
        self.nms_cfg = dict(score_threshold=score_threshold,
                            nms_threshold=nms_threshold,
                            nms_top_k=nms_top_k, keep_top_k=keep_top_k)
        self._anchor_cache = {}

    def _anchors(self, feat_hws, device):
        """(anchors [A, 4], level counts, centres [A, 2], strides [A]) on
        ``device``, made once per pyramid shape."""
        key = (tuple(feat_hws), device)
        if key not in self._anchor_cache:
            anchors, counts = _cell_anchors(key[0])
            strides = np.concatenate([np.full((c,), s, np.float32)
                                      for c, s in zip(counts, STRIDES)])
            anchors, strides = (torch.from_numpy(a).to(device)
                                for a in (anchors, strides))
            self._anchor_cache[key] = (
                anchors, counts, (anchors[:, :2] + anchors[:, 2:]) * 0.5,
                strides)
        return self._anchor_cache[key]

    def head_outputs(self, images):
        """(per-level head outputs, the levels' (H, W))."""
        feats = self.neck(self.backbone.features(images)[1:])
        return self.head(feats), tuple(tuple(f.shape[1:3]) for f in feats)

    def _flatten(self, outs):
        n = outs[0][0].shape[0]
        cls = torch.cat([o[0].reshape(n, -1, self.num_classes)
                         for o in outs], 1)
        dist = torch.cat([o[1].reshape(n, -1, 4 * (self.reg_max + 1))
                          for o in outs], 1)
        return cls.float(), dist.float()

    def forward(self, images):
        outs, feat_hws = self.head_outputs(images)
        image_hw = tuple(images.shape[1:3])
        if self.training:
            return {"outs": outs, "feat_hws": feat_hws, "image_hw": image_hw}
        return self.nms(*self.decode(outs, feat_hws, image_hw))

    def decode(self, outs, feat_hws, image_hw):
        """Boxes [N, A, 4] f32 clipped to the image, scores [N, A, C]."""
        cls, dist = self._flatten(outs)
        _, _, centers, strides = self._anchors(feat_hws, cls.device)
        d = integral(dist, self.reg_max) * strides[None, :, None]
        return (distance2bbox(centers[None], d, max_shape=image_hw),
                torch.sigmoid(cls))

    def nms(self, boxes, scores):
        return multiclass_nms(boxes, scores, **self.nms_cfg)

    def loss_fn(self, outputs, targets):
        """targets: ``boxes`` [B, M, 4] xyxy pixels, ``class_labels`` [B,
        M], optional ``mask`` [B, M] (default: boxes of positive width)."""
        gt_boxes, gt_labels, gt_valid = ground_truth(targets)
        cls, dist = self._flatten(outputs["outs"])
        anchors, counts, centers, strides = self._anchors(
            outputs["feat_hws"], cls.device)
        st = strides[None, :, None]
        pred_boxes = distance2bbox(centers[None],
                                   integral(dist, self.reg_max) * st)
        with torch.no_grad():
            pm = gt_valid[..., None].float().expand(*gt_valid.shape,
                                                    cls.shape[1])
            labels, t_boxes, scores = atss_assign(
                anchors, counts, gt_labels, gt_boxes, pm,
                bg_index=self.num_classes, num_classes=self.num_classes,
                pred_bboxes=pred_boxes)
            pos = labels < self.num_classes
            quality = scores.amax(-1)                # IoU with its GT
            norm = quality.sum().clamp_min(1.0)
            t = F.one_hot(labels, self.num_classes + 1)[
                ..., :self.num_classes].float() * quality[..., None]
            # bins: the stride divided out first, then clamped to the support
            t_dist = (bbox2distance(centers[None], t_boxes) / st).clamp(
                0.0, self.reg_max - 0.1)
            w = torch.where(pos, quality, 0.0)
        qfl = ((t - torch.sigmoid(cls)).abs() ** 2 * _quality_bce(cls, t))
        giou = 1.0 - aligned_iou(pred_boxes, t_boxes, mode="giou")
        return (qfl.sum() / norm + 2.0 * (giou * w).sum() / norm
                + 0.25 * (_dfl(dist, t_dist, self.reg_max) * w).sum() / norm)


def gfl_r50(num_classes=80, **kwargs):
    return GFL(num_classes=num_classes, **kwargs)
