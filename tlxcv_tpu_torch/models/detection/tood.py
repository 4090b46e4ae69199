"""TOOD, task-aligned one-stage detection (counterpart of
``tlxcv_tpu/models/detection/tood.py``), NHWC, to mmdet's ``tood_r50``: a
ResNet-50, the P3-P7 FPN, a shared stack of 6 3x3 conv + GroupNorm layers
whose concatenated outputs feed a ``TaskDecomposition`` per task (layer
attention, then a 1x1 reduction).  The class logits are fused with a
per-pixel probability map (the geometric mean of the two sigmoids, back to
logits); the distances, in strides, are resampled per side at learned
offsets by ``_bilinear_sample``, which ``deform.DeformConv2d`` also uses.

Eval returns ``(dets [B, keep_top_k, 6], counts [B])``: distances times
the stride from each cell's centre, clipped, sigmoid scores, the
class-aware ``multiclass_nms``.  Training returns the head's outputs for
``loss_fn``: task-aligned assignment (``ppyoloe.task_aligned_assign``)
with its normalised alignment as soft targets, a quality-focal class loss
and GIoU weighted by the targets.

No kernel of ours runs here: the sampler is plain torch (four gathers).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn as tnn

from ... import nn
from ...core import init as I
from ...device import resolve_device
from ...ops.boxes import aligned_iou, clip_boxes, distance2bbox
from ...ops.nms import multiclass_nms
from ..classification.resnet import ResNet
from .fcos import FPNP3P7, _normal_001, _Scale, ground_truth
from .gfl import _quality_bce
from .ppyoloe import task_aligned_assign

__all__ = ["TOOD", "TOODHead", "TaskDecomposition", "tood_r50"]

STRIDES = (8, 16, 32, 64, 128)


class TaskDecomposition(tnn.Module):
    """Layer attention over the interactive stack (two 1x1 convs on the
    stack's spatial mean, a sigmoid weight per layer), then a 1x1
    reduction, GroupNorm(32) and ReLU."""

    def __init__(self, ch=256, stacked=6, down_rate=8, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.la_conv1 = nn.Conv2d(stacked * ch, stacked * ch // down_rate, 1,
                                  **kw)
        self.la_conv2 = nn.Conv2d(stacked * ch // down_rate, stacked, 1, **kw)
        self.reduction = nn.Conv2d(stacked * ch, ch, 1, bias=False, **kw)
        self.norm = nn.GroupNorm(32, ch, device=device)
        self.stacked = stacked
        self.ch = ch

    def forward(self, stack_cat, avg_feat):
        """stack_cat [N, H, W, stacked·ch]; avg_feat [N, 1, 1, stacked·ch]."""
        w = torch.sigmoid(self.la_conv2(nn.relu(self.la_conv1(avg_feat))))
        w = w.repeat_interleave(self.ch, dim=-1)  # one weight a layer's block
        return nn.relu(self.norm(self.reduction(stack_cat * w)))


def _bilinear_sample(feat, xs, ys):
    """Sample ``feat`` [N, H, W, C] at fractional pixel coordinates ``xs``,
    ``ys`` [N, h, w] (any h, w) -> [N, h, w, C], clamped to the border
    (a sample outside the map takes the nearest edge's value, not zero):
    four corner gathers, blended along x, then along y."""
    n, h, w, c = feat.shape
    xs = xs.clamp(0.0, w - 1.0)
    ys = ys.clamp(0.0, h - 1.0)
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    x1 = torch.clamp_max(x0 + 1, w - 1.0)
    y1 = torch.clamp_max(y0 + 1, h - 1.0)
    wx = (xs - x0)[..., None]
    wy = (ys - y0)[..., None]
    flat = feat.reshape(n, h * w, c)
    rows = torch.arange(n, device=feat.device)[:, None]

    def g(yi, xi):
        idx = (yi * w + xi).to(torch.int64).reshape(n, -1)
        return flat[rows, idx].reshape(*xs.shape, c)

    top = g(y0, x0) * (1 - wx) + g(y0, x1) * wx
    bot = g(y1, x0) * (1 - wx) + g(y1, x1) * wx
    return top * (1 - wy) + bot * wy


class TOODHead(tnn.Module):
    """The interactive stack ([conv, norm] x ``stacked`` in one list, 3x3
    at normal(0.01)), a ``TaskDecomposition`` per task, the classifier (at
    the prior) and distances (relu of a per-level scale times the conv),
    and the alignment branches: a probability map (1x1 then 3x3, at the
    prior) and 4 x (dy, dx) sampling offsets (1x1 then 3x3, bias 0)."""

    def __init__(self, in_ch=256, num_classes=80, stacked=6,
                 num_levels=len(STRIDES), prior_prob=0.01, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.inter_convs = tnn.ModuleList()
        for _ in range(stacked):
            self.inter_convs.append(nn.Conv2d(in_ch, in_ch, 3, padding=1,
                                              w_init=_normal_001, **kw))
            self.inter_convs.append(nn.GroupNorm(32, in_ch, device=device))
        self.cls_decomp = TaskDecomposition(in_ch, stacked, **kw)
        self.reg_decomp = TaskDecomposition(in_ch, stacked, **kw)
        bias = -math.log((1 - prior_prob) / prior_prob)
        prior = lambda s, **k: I.constant(s, bias, **k)  # noqa: E731
        self.cls_pred = nn.Conv2d(in_ch, num_classes, 3, padding=1,
                                  w_init=_normal_001, b_init=prior, **kw)
        self.reg_pred = nn.Conv2d(in_ch, 4, 3, padding=1, w_init=_normal_001,
                                  **kw)
        self.cls_prob_conv1 = nn.Conv2d(stacked * in_ch, in_ch // 4, 1,
                                        w_init=_normal_001, **kw)
        self.cls_prob_conv2 = nn.Conv2d(in_ch // 4, 1, 3, padding=1,
                                        w_init=_normal_001, b_init=prior,
                                        **kw)
        self.reg_offset_conv1 = nn.Conv2d(stacked * in_ch, in_ch // 4, 1,
                                          w_init=_normal_001, **kw)
        self.reg_offset_conv2 = nn.Conv2d(in_ch // 4, 4 * 2, 3, padding=1,
                                          **kw)
        self.scales = tnn.ModuleList([_Scale(device=device)
                                      for _ in range(num_levels)])
        self.num_classes = num_classes
        self.stacked = stacked

    def forward(self, feats):
        """Per level: (aligned class logits [N, H, W, C] f32, distances
        [N, H, W, 4] f32 in strides, resampled at the learned offsets)."""
        outs = []
        for scale, f in zip(self.scales, feats):
            inter, x = [], f
            for i in range(0, len(self.inter_convs), 2):
                x = nn.relu(self.inter_convs[i + 1](self.inter_convs[i](x)))
                inter.append(x)
            stack_cat = torch.cat(inter, -1)
            avg = stack_cat.mean(dim=(1, 2), keepdim=True)
            logits = self.cls_pred(self.cls_decomp(stack_cat, avg))
            prob = self.cls_prob_conv2(nn.relu(
                self.cls_prob_conv1(stack_cat)))
            # the geometric mean of the two probabilities, back to logits
            p = torch.sqrt((torch.sigmoid(logits.float())
                            * torch.sigmoid(prob.float())).clamp(
                                1e-6, 1 - 1e-6))
            cls_out = torch.log(p) - torch.log1p(-p)
            dist = nn.relu(scale(self.reg_pred(self.reg_decomp(stack_cat,
                                                               avg))))
            off = self.reg_offset_conv2(nn.relu(
                self.reg_offset_conv1(stack_cat))).float()
            n, h, w, _ = dist.shape
            gy, gx = torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=f.device),
                torch.arange(w, dtype=torch.float32, device=f.device),
                indexing="ij")
            aligned = [_bilinear_sample(
                dist[..., side:side + 1].float(),
                gx + off[..., 2 * side + 1], gy + off[..., 2 * side])[..., 0]
                for side in range(4)]
            outs.append((cls_out, torch.stack(aligned, -1)))
        return outs


def _points(feat_hws, strides=STRIDES):
    """Cell centres [P, 2] in pixels and their strides [P] (numpy f32)."""
    pts, sts = [], []
    for (h, w), s in zip(feat_hws, strides):
        xs = (np.arange(w, dtype=np.float32) + 0.5) * s
        ys = (np.arange(h, dtype=np.float32) + 0.5) * s
        gx, gy = np.meshgrid(xs, ys)
        pts.append(np.stack([gx.reshape(-1), gy.reshape(-1)], -1))
        sts.append(np.full((h * w,), s, np.float32))
    return np.concatenate(pts), np.concatenate(sts)


class TOOD(tnn.Module):
    """The detector: backbone C3-C5, ``FPNP3P7``, ``TOODHead``; eval keeps
    score 0.05, IoU 0.6, top 1000, keep 100."""

    def __init__(self, num_classes=80, backbone=None, score_threshold=0.05,
                 nms_threshold=0.6, nms_top_k=1000, keep_top_k=100,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.backbone = backbone if backbone is not None else ResNet(
            depth=50, num_classes=0, with_pool=False, **kw)
        self.neck = FPNP3P7(self.backbone.feat_channels[1:], 256, **kw)
        self.head = TOODHead(256, num_classes, **kw)
        self.num_classes = num_classes
        self.nms_cfg = dict(score_threshold=score_threshold,
                            nms_threshold=nms_threshold,
                            nms_top_k=nms_top_k, keep_top_k=keep_top_k)

    def head_outputs(self, images):
        """(per-level head outputs, the levels' (H, W))."""
        feats = self.neck(self.backbone.features(images)[1:])
        return self.head(feats), tuple(tuple(f.shape[1:3]) for f in feats)

    def _flatten(self, outs, feat_hws):
        """Class logits [N, P, C], boxes [N, P, 4] (unclipped), centres
        [P, 2] and strides [P], all f32."""
        n, dev = outs[0][0].shape[0], outs[0][0].device
        cls = torch.cat([o[0].reshape(n, -1, self.num_classes)
                         for o in outs], 1)
        points, strides = (torch.from_numpy(a).to(dev)
                           for a in _points(feat_hws))
        dist = torch.cat([o[1].reshape(n, -1, 4) for o in outs], 1).float()
        boxes = distance2bbox(points[None], dist * strides[None, :, None])
        return cls.float(), boxes, points, strides

    def forward(self, images):
        outs, feat_hws = self.head_outputs(images)
        image_hw = tuple(images.shape[1:3])
        if self.training:
            return {"outs": outs, "feat_hws": feat_hws, "image_hw": image_hw}
        return self.nms(*self.decode(outs, feat_hws, image_hw))

    def decode(self, outs, feat_hws, image_hw):
        """Boxes [N, P, 4] f32 clipped to the image, scores [N, P, C]."""
        cls, boxes, _, _ = self._flatten(outs, feat_hws)
        return clip_boxes(boxes, image_hw), torch.sigmoid(cls)

    def nms(self, boxes, scores):
        return multiclass_nms(boxes, scores, **self.nms_cfg)

    def loss_fn(self, outputs, targets):
        """targets: ``boxes`` [B, M, 4] xyxy pixels, ``class_labels`` [B,
        M], optional ``mask`` [B, M] (default: boxes of positive width)."""
        gt_boxes, gt_labels, gt_valid = ground_truth(targets)
        cls, boxes, points, _ = self._flatten(outputs["outs"],
                                              outputs["feat_hws"])
        with torch.no_grad():
            pm = gt_valid[..., None].float().expand(*gt_valid.shape,
                                                    cls.shape[1])
            labels, t_boxes, t = task_aligned_assign(
                torch.sigmoid(cls), boxes, points, gt_labels, gt_boxes, pm,
                bg_index=self.num_classes, num_classes=self.num_classes)
            w = torch.where(labels < self.num_classes, t.amax(-1), 0.0)
        qfl = (t - torch.sigmoid(cls)).abs() ** 2 * _quality_bce(cls, t)
        giou = 1.0 - aligned_iou(boxes, t_boxes, mode="giou")
        return (qfl.sum() / t.sum().clamp_min(1.0)
                + 2.0 * (giou * w).sum() / w.sum().clamp_min(1e-6))


def tood_r50(num_classes=80, **kwargs):
    return TOOD(num_classes=num_classes, **kwargs)
