"""PicoDet, the mobile detector (counterpart of
``tlxcv_tpu/models/detection/picodet.py``), NHWC, to PaddleDetection's
``picodet_s_lcnet``: PP-LCNet tapped at strides 8, 16 and 32
(``_LCFeatures``), a depthwise PAN at one width (5x5 depthwise + 1x1
pointwise convs with hardswish) with an extra stride-64 level, and per
level one conv stack whose prediction holds the C class logits and GFL's
4 x (``reg_max`` + 1) distribution logits (``gfl.integral`` decodes them).

Eval returns ``(dets [B, keep_top_k, 6], counts [B])``: the expected
distances times the stride from each cell's centre, clipped, sigmoid
scores, the class-aware ``multiclass_nms``.  Training returns the head's
outputs for ``loss_fn``: task-aligned assignment
(``ppyoloe.task_aligned_assign``), the varifocal loss on the soft targets,
GIoU and the distribution focal loss.

No kernel of ours runs here: the PAN's 2x resizes are the reference's
nearest (``fcos._resize_nearest``), followed by a concatenation.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn as tnn

from ... import nn
from ...core import init as I
from ...device import resolve_device
from ...ops.boxes import aligned_iou, bbox2distance, clip_boxes, \
    distance2bbox
from ...ops.nms import multiclass_nms
from ..classification.pp_lcnet import PPLCNet
from ..classification.utils import make_divisible
from .fcos import _normal_001, _resize_nearest, ground_truth
from .gfl import _dfl, _quality_bce, integral
from .ppyoloe import task_aligned_assign
from .tood import _points

__all__ = ["PicoDet", "picodet_lcnet"]

STRIDES = (8, 16, 32, 64)


class _LCFeatures(tnn.Module):
    """PP-LCNet's stem and blocks, tapped after blocks 4, 10 and 12
    (strides 8, 16, 32)."""

    def __init__(self, scale=1.0, device=None, generator=None):
        super().__init__()
        net = PPLCNet(scale=scale, num_classes=10, device=device,
                      generator=generator)
        self.stem = net.stem
        self.blocks = net.blocks
        self.out_channels = tuple(make_divisible(c * scale, 8)
                                  for c in (128, 256, 512))

    def forward(self, x):
        x = self.stem(x)
        outs = []
        for i, b in enumerate(self.blocks):
            x = b(x)
            if i in (4, 10, 12):
                outs.append(x)
        return outs


class _DWConv(tnn.Module):
    """k x k depthwise conv, BatchNorm, hardswish; 1x1 pointwise conv,
    BatchNorm, hardswish."""

    def __init__(self, c_in, c_out, k=5, s=1, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.dw = nn.Conv2d(c_in, c_in, k, stride=s, padding=k // 2,
                            groups=c_in, bias=False, **kw)
        self.dw_bn = nn.BatchNorm(c_in, device=device)
        self.pw = nn.Conv2d(c_in, c_out, 1, bias=False, **kw)
        self.pw_bn = nn.BatchNorm(c_out, device=device)

    def forward(self, x):
        x = F.hardswish(self.dw_bn(self.dw(x)))
        return F.hardswish(self.pw_bn(self.pw(x)))


class _LCPAN(tnn.Module):
    """1x1 reductions to ``ch``, a top-down pass (nearest 2x, concatenate,
    ``_DWConv``), a bottom-up pass (stride-2 ``_DWConv``, concatenate,
    ``_DWConv``) and a stride-2 ``_DWConv`` for the stride-64 level."""

    def __init__(self, in_channels, ch=96, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        n = len(in_channels)
        self.reduce = tnn.ModuleList([nn.Conv2d(c, ch, 1, bias=False, **kw)
                                      for c in in_channels])
        self.reduce_bn = tnn.ModuleList([nn.BatchNorm(ch, device=device)
                                         for _ in in_channels])
        self.td = tnn.ModuleList([_DWConv(2 * ch, ch, **kw)
                                  for _ in range(n - 1)])
        self.bu_down = tnn.ModuleList([_DWConv(ch, ch, s=2, **kw)
                                       for _ in range(n - 1)])
        self.bu = tnn.ModuleList([_DWConv(2 * ch, ch, **kw)
                                  for _ in range(n - 1)])
        self.extra = _DWConv(ch, ch, s=2, **kw)
        self.out_channels = (ch,) * (n + 1)

    def forward(self, feats):
        lat = [F.hardswish(bn(r(f))) for r, bn, f in
               zip(self.reduce, self.reduce_bn, feats)]
        for i in range(len(lat) - 1, 0, -1):
            up = _resize_nearest(lat[i], lat[i - 1].shape[1:3])
            lat[i - 1] = self.td[i - 1](torch.cat([lat[i - 1], up], -1))
        outs = [lat[0]]
        for i in range(len(lat) - 1):
            outs.append(self.bu[i](torch.cat(
                [self.bu_down[i](outs[-1]), lat[i + 1]], -1)))
        outs.append(self.extra(outs[-1]))
        return outs


class _PicoHead(tnn.Module):
    """Per level two ``_DWConv``s and one 1x1 prediction of C +
    4 (reg_max + 1) channels at normal(0.01), bias at the prior 0.01 on
    every channel, as the reference's."""

    def __init__(self, ch, num_classes, reg_max=7, num_levels=4,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        bias = -math.log((1 - 0.01) / 0.01)
        self.convs = tnn.ModuleList([
            tnn.ModuleList([_DWConv(ch, ch, **kw), _DWConv(ch, ch, **kw)])
            for _ in range(num_levels)])
        self.preds = tnn.ModuleList([
            nn.Conv2d(ch, num_classes + 4 * (reg_max + 1), 1,
                      w_init=_normal_001,
                      b_init=lambda s, **k: I.constant(s, bias, **k), **kw)
            for _ in range(num_levels)])
        self.num_classes = num_classes
        self.reg_max = reg_max

    def forward(self, feats):
        """Per level: (class logits [N, H, W, C], distribution logits
        [N, H, W, 4 (reg_max + 1)])."""
        outs = []
        for convs, pred, f in zip(self.convs, self.preds, feats):
            for c in convs:
                f = c(f)
            p = pred(f)
            outs.append((p[..., :self.num_classes],
                         p[..., self.num_classes:]))
        return outs


class PicoDet(tnn.Module):
    """The detector: ``_LCFeatures`` at ``scale``, ``_LCPAN`` at
    ``neck_ch``, ``_PicoHead``; eval keeps score 0.025, IoU 0.6, top 1000,
    keep 100."""

    def __init__(self, num_classes=80, scale=0.75, neck_ch=96, reg_max=7,
                 score_threshold=0.025, nms_threshold=0.6, nms_top_k=1000,
                 keep_top_k=100, backbone=None, device=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.backbone = backbone if backbone is not None else _LCFeatures(
            scale, **kw)
        self.neck = _LCPAN(self.backbone.out_channels, neck_ch, **kw)
        self.head = _PicoHead(neck_ch, num_classes, reg_max, **kw)
        self.num_classes = num_classes
        self.reg_max = reg_max
        self.nms_cfg = dict(score_threshold=score_threshold,
                            nms_threshold=nms_threshold,
                            nms_top_k=nms_top_k, keep_top_k=keep_top_k)

    def head_outputs(self, images):
        """(per-level head outputs, the levels' (H, W))."""
        outs = self.head(self.neck(self.backbone(images)))
        return outs, tuple(tuple(o[0].shape[1:3]) for o in outs)

    def _flatten(self, outs, feat_hws):
        """Class logits [N, P, C], distribution logits, boxes [N, P, 4]
        (unclipped), centres [P, 2] and strides [P], all f32."""
        n, dev = outs[0][0].shape[0], outs[0][0].device
        cls = torch.cat([o[0].reshape(n, -1, self.num_classes)
                         for o in outs], 1).float()
        dist = torch.cat([o[1].reshape(n, -1, 4 * (self.reg_max + 1))
                          for o in outs], 1).float()
        points, strides = (torch.from_numpy(a).to(dev)
                           for a in _points(feat_hws, STRIDES))
        d = integral(dist, self.reg_max) * strides[None, :, None]
        return cls, dist, distance2bbox(points[None], d), points, strides

    def forward(self, images):
        outs, feat_hws = self.head_outputs(images)
        image_hw = tuple(images.shape[1:3])
        if self.training:
            return {"outs": outs, "feat_hws": feat_hws, "image_hw": image_hw}
        return self.nms(*self.decode(outs, feat_hws, image_hw))

    def decode(self, outs, feat_hws, image_hw):
        """Boxes [N, P, 4] f32 clipped to the image, scores [N, P, C]."""
        cls, _, boxes, _, _ = self._flatten(outs, feat_hws)
        return clip_boxes(boxes, image_hw), torch.sigmoid(cls)

    def nms(self, boxes, scores):
        return multiclass_nms(boxes, scores, **self.nms_cfg)

    def loss_fn(self, outputs, targets):
        """targets: ``boxes`` [B, M, 4] xyxy pixels, ``class_labels`` [B,
        M], optional ``mask`` [B, M] (default: boxes of positive width)."""
        gt_boxes, gt_labels, gt_valid = ground_truth(targets)
        cls, dist, boxes, points, strides = self._flatten(
            outputs["outs"], outputs["feat_hws"])
        with torch.no_grad():
            pm = gt_valid[..., None].float().expand(*gt_valid.shape,
                                                    cls.shape[1])
            labels, t_boxes, t = task_aligned_assign(
                torch.sigmoid(cls), boxes, points, gt_labels, gt_boxes, pm,
                bg_index=self.num_classes, num_classes=self.num_classes)
            w = torch.where(labels < self.num_classes, t.amax(-1), 0.0)
            # bins: the stride divided out first, then clamped to the support
            t_dist = (bbox2distance(points[None], t_boxes)
                      / strides[None, :, None]).clamp(0.0, self.reg_max - 0.1)
        # varifocal: positives weighted by their target, negatives 0.75 p²
        weight = torch.where(t > 0, t, 0.75 * torch.sigmoid(cls) ** 2)
        vfl = (weight * _quality_bce(cls, t)).sum() / t.sum().clamp_min(1.0)
        wsum = w.sum().clamp_min(1e-6)
        giou = 1.0 - aligned_iou(boxes, t_boxes, mode="giou")
        return (vfl + 2.0 * (giou * w).sum() / wsum
                + 0.25 * (_dfl(dist, t_dist, self.reg_max) * w).sum() / wsum)


def picodet_lcnet(num_classes=80, scale=0.75, **kwargs):
    return PicoDet(num_classes=num_classes, scale=scale, **kwargs)
