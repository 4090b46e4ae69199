"""FCOS, the anchor-free one-stage detector (counterpart of
``tlxcv_tpu/models/detection/fcos.py``), NHWC, to PaddleDetection's
``fcos_r50_fpn_1x_coco``: a ResNet-50, the P3-P7 FPN (strides 8 to 128),
two shared 4-conv GroupNorm towers with a learned scale per level, the
centerness on the regression tower, distances in units of the stride.
``fcos_dcn_r50`` makes each tower's last conv a modulated deformable conv
(``deform.DeformConv2d``).

Eval returns ``(dets [B, keep_top_k, 6], counts [B])``, rows [label,
score, x1, y1, x2, y2], score = sigmoid(cls) · sigmoid(ctr) taken in the
head's dtype, then f32; the distances are cast to f32 before they are
scaled by the stride.  Training (``module.training``) returns the head's
outputs for ``loss_fn``: ``fcos_targets`` per image (center sampling at
1.5 strides, the level's range on the largest distance, the smallest
box's area on ties), sigmoid focal loss, centerness-weighted GIoU and the
centerness BCE, as the reference normalises them.

No kernel of ours runs here: the FPN merges by a half-pixel nearest resize
(``jax.image.resize``'s rule, ``_resize_nearest``) and an add, not by
``upsample_add``, as the reference does; the NMS is ``ops.nms``'s.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn as tnn

from ... import nn
from ...core import init as I
from ...device import resolve_device
from ...ops.boxes import aligned_iou, distance2bbox
from ...ops.losses import sigmoid_focal_loss
from ...ops.nms import multiclass_nms
from ..classification.resnet import ResNet

__all__ = ["FCOS", "FCOSHead", "FPNP3P7", "fcos_r50", "fcos_targets",
           "ground_truth"]

STRIDES = (8, 16, 32, 64, 128)
# the largest regression distance each level takes (FCOS's
# object_sizes_of_interest)
LEVEL_RANGES = ((-1, 64), (64, 128), (128, 256), (256, 512), (512, 1e8))


def _normal_001(shape, **kw):
    return I.normal(shape, std=0.01, **kw)


def _resize_nearest(x, hw):
    """``jax.image.resize(x, (n, *hw, c), "nearest")``: output row i reads
    input row floor((i + 0.5) · in / out), computed in f32 as JAX does
    (torch's ``nearest-exact``); an axis of unchanged size is left as it
    is.  At an integer ratio this is ``ops.image.interpolate``'s nearest;
    elsewhere (800x1333's odd levels) the two differ."""
    for axis, out in ((1, hw[0]), (2, hw[1])):
        size = x.shape[axis]
        if size != out:
            src = (torch.arange(out, dtype=torch.float32, device=x.device)
                   + 0.5) * size / out
            x = x.index_select(axis, torch.floor(src).long())
    return x


class FPNP3P7(tnn.Module):
    """C3-C5 laterals to P3-P5 by a top-down nearest resize and add and a
    3x3 conv each, then P6 by a stride-2 3x3 conv on P5 (on C5 with
    ``extra_on_input``, RetinaNet's choice) and P7 by one on relu(P6)."""

    def __init__(self, in_channels, out_ch=256, extra_on_input=False,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.lateral = tnn.ModuleList([nn.Conv2d(c, out_ch, 1, **kw)
                                       for c in in_channels])
        self.output = tnn.ModuleList([
            nn.Conv2d(out_ch, out_ch, 3, padding=1, **kw)
            for _ in in_channels])
        self.extra_on_input = extra_on_input
        p6_in = in_channels[-1] if extra_on_input else out_ch
        self.p6 = nn.Conv2d(p6_in, out_ch, 3, stride=2, padding=1, **kw)
        self.p7 = nn.Conv2d(out_ch, out_ch, 3, stride=2, padding=1, **kw)

    def forward(self, feats):
        lat = [conv(f) for conv, f in zip(self.lateral, feats)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + _resize_nearest(lat[i],
                                                      lat[i - 1].shape[1:3])
        outs = [conv(x) for conv, x in zip(self.output, lat)]
        p6 = self.p6(feats[-1] if self.extra_on_input else outs[-1])
        return outs + [p6, self.p7(nn.relu(p6))]


class _Scale(tnn.Module):
    """A learned scalar (a 0-d f32 parameter), cast to x's dtype."""

    def __init__(self, value=1.0, device=None):
        super().__init__()
        self.scale = tnn.Parameter(torch.tensor(float(value),
                                                dtype=torch.float32,
                                                device=device))

    def forward(self, x):
        return x * self.scale.to(x.dtype)


class FCOSHead(tnn.Module):
    """Two towers shared over the levels, each ``num_convs`` x (3x3 conv,
    GroupNorm(32), ReLU) kept as one list [conv, norm, conv, norm, ...]
    (the last conv deformable with ``dcn_last``); the classifier (bias at
    the prior ``prior_prob``), the distances (relu of a per-level scale
    times the conv) and the centerness, all 3x3 convs at normal(0.01)."""

    def __init__(self, in_ch=256, num_classes=80, num_convs=4,
                 num_levels=len(STRIDES), prior_prob=0.01, dcn_last=False,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)

        def tower():
            convs = []
            for i in range(num_convs):
                if dcn_last and i == num_convs - 1:
                    # here, not at the top: deform imports tood, which
                    # imports this module
                    from .deform import DeformConv2d

                    convs.append(DeformConv2d(in_ch, in_ch, **kw))
                else:
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
        self.reg_pred = nn.Conv2d(in_ch, 4, 3, padding=1, w_init=_normal_001,
                                  **kw)
        self.ctr_pred = nn.Conv2d(in_ch, 1, 3, padding=1, w_init=_normal_001,
                                  **kw)
        self.scales = tnn.ModuleList([_Scale(device=device)
                                      for _ in range(num_levels)])
        self.num_classes = num_classes

    @staticmethod
    def _run_tower(tower, x):
        for i in range(0, len(tower), 2):
            x = nn.relu(tower[i + 1](tower[i](x)))
        return x

    def forward(self, feats):
        """Per level: (cls logits [N, H, W, C], distances [N, H, W, 4] in
        strides, centerness logits [N, H, W, 1])."""
        outs = []
        for scale, f in zip(self.scales, feats):
            c = self._run_tower(self.cls_tower, f)
            r = self._run_tower(self.reg_tower, f)
            outs.append((self.cls_pred(c), nn.relu(scale(self.reg_pred(r))),
                         self.ctr_pred(r)))
        return outs


def ground_truth(targets):
    """A detector's targets: ``boxes`` [B, M, 4] f32 xyxy pixels,
    ``class_labels`` [B, M] int64 and the validity [B, M] f32 (``mask``;
    by default, the boxes of positive width)."""
    boxes = targets["boxes"].float()
    valid = targets.get("mask")
    if valid is None:
        valid = boxes[..., 2] > boxes[..., 0]
    return boxes, targets["class_labels"].long(), valid.float()


def _level_points(feat_hws, strides=STRIDES, device=None):
    """Per level [H·W, 2] (x, y) cell centres in input pixels, f32."""
    pts = []
    for (h, w), s in zip(feat_hws, strides):
        ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) * s
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * s
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    return pts


def fcos_targets(points, point_strides, point_ranges, gt_boxes, gt_labels,
                 gt_valid, num_classes, center_radius=1.5):
    """FCOS's assignment for one image.

    points [P, 2], point_strides [P], point_ranges [P, 2]; gt_boxes
    [M, 4] xyxy pixels, gt_labels [M], gt_valid [M].  A point is a
    candidate for a box it lies inside, within ``center_radius`` strides
    of its centre, whose largest distance falls in the point's range; it
    takes the candidate of least area (the first on ties).  Returns
    (cls_tgt [P] int32, ``num_classes`` for background; ltrb [P, 4]
    pixel distances; ctr_tgt [P], 0 off the positives; pos_mask [P])."""
    px, py = points[:, 0:1], points[:, 1:2]
    ltrb = torch.stack([px - gt_boxes[None, :, 0], py - gt_boxes[None, :, 1],
                        gt_boxes[None, :, 2] - px,
                        gt_boxes[None, :, 3] - py], -1)       # [P, M, 4]
    inside = ltrb.amin(-1) > 0
    cx = (gt_boxes[None, :, 0] + gt_boxes[None, :, 2]) * 0.5
    cy = (gt_boxes[None, :, 1] + gt_boxes[None, :, 3]) * 0.5
    rad = center_radius * point_strides[:, None]
    near = ((px - cx).abs() <= rad) & ((py - cy).abs() <= rad)
    max_d = ltrb.amax(-1)
    in_range = (max_d >= point_ranges[:, 0:1]) & (max_d <= point_ranges[:, 1:2])
    cand = inside & near & in_range & (gt_valid[None, :] > 0)
    area = ((gt_boxes[:, 2] - gt_boxes[:, 0])
            * (gt_boxes[:, 3] - gt_boxes[:, 1]))
    area_c = torch.where(cand, area[None, :], math.inf)
    best = area_c.argmin(-1)
    pos = torch.isfinite(area_c.amin(-1))
    ltrb_t = ltrb[torch.arange(ltrb.shape[0], device=ltrb.device), best]
    cls_t = torch.where(pos, gt_labels[best], num_classes).to(torch.int32)
    lr, tb = ltrb_t[:, 0::2], ltrb_t[:, 1::2]
    ctr = torch.sqrt(torch.clamp(
        (lr.amin(-1) / lr.amax(-1).clamp_min(1e-6))
        * (tb.amin(-1) / tb.amax(-1).clamp_min(1e-6)), 0.0, 1.0))
    return cls_t, ltrb_t, torch.where(pos, ctr, 0.0), pos


class FCOS(tnn.Module):
    """The detector: backbone C3-C5, ``FPNP3P7``, ``FCOSHead``; eval
    decodes every level and runs the class-aware ``multiclass_nms``
    (score 0.025, IoU 0.6, top 1000, keep 100)."""

    def __init__(self, num_classes=80, backbone=None, score_threshold=0.025,
                 nms_threshold=0.6, nms_top_k=1000, keep_top_k=100,
                 dcn_last=False, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.backbone = backbone if backbone is not None else ResNet(
            depth=50, num_classes=0, with_pool=False, **kw)
        self.neck = FPNP3P7(self.backbone.feat_channels[1:], 256, **kw)
        self.head = FCOSHead(256, num_classes, dcn_last=dcn_last, **kw)
        self.num_classes = num_classes
        self.nms_cfg = dict(score_threshold=score_threshold,
                            nms_threshold=nms_threshold,
                            nms_top_k=nms_top_k, keep_top_k=keep_top_k)

    def head_outputs(self, images):
        """(per-level head outputs, the levels' (H, W))."""
        feats = self.neck(self.backbone.features(images)[1:])
        return self.head(feats), tuple(tuple(f.shape[1:3]) for f in feats)

    def forward(self, images):
        outs, feat_hws = self.head_outputs(images)
        if self.training:
            return {"outs": outs, "feat_hws": feat_hws,
                    "image_hw": tuple(images.shape[1:3])}
        return self.post_process(outs, feat_hws, tuple(images.shape[1:3]))

    def decode(self, outs, feat_hws, image_hw):
        """Boxes [N, A, 4] f32 clipped to the image, scores [N, A, C]
        f32, over every level's cells."""
        boxes_l, scores_l = [], []
        pts = _level_points(feat_hws, device=outs[0][0].device)
        for (cls, reg, ctr), p, s in zip(outs, pts, STRIDES):
            n, c = cls.shape[0], cls.shape[-1]
            reg = reg.reshape(n, -1, 4).float() * s
            boxes_l.append(distance2bbox(p[None], reg, max_shape=image_hw))
            scores_l.append(torch.sigmoid(cls.reshape(n, -1, c))
                            * torch.sigmoid(ctr.reshape(n, -1, 1)))
        return torch.cat(boxes_l, 1), torch.cat(scores_l, 1).float()

    def nms(self, boxes, scores):
        return multiclass_nms(boxes, scores, **self.nms_cfg)

    def post_process(self, outs, feat_hws, image_hw):
        return self.nms(*self.decode(outs, feat_hws, image_hw))

    def loss_fn(self, outputs, targets):
        """targets: ``boxes`` [B, M, 4] xyxy pixels, ``class_labels`` [B,
        M], optional ``mask`` [B, M] (default: boxes of positive width)."""
        gt_boxes, gt_labels, gt_valid = ground_truth(targets)
        outs = outputs["outs"]
        dev = outs[0][0].device
        pts = _level_points(outputs["feat_hws"], device=dev)
        strides = torch.cat([torch.full((p.shape[0],), float(s), device=dev)
                             for p, s in zip(pts, STRIDES)])
        ranges = torch.cat([torch.tensor(rg, dtype=torch.float32,
                                         device=dev).expand(p.shape[0], 2)
                            for p, rg in zip(pts, LEVEL_RANGES)])
        points = torch.cat(pts, 0)
        cls_t, ltrb_t, ctr_t, pos = (torch.stack(t) for t in zip(*(
            fcos_targets(points, strides, ranges, bx, lb, vd,
                         self.num_classes)
            for bx, lb, vd in zip(gt_boxes, gt_labels, gt_valid))))

        n, c = outs[0][0].shape[0], self.num_classes
        cls_all = torch.cat([o[0].reshape(n, -1, c) for o in outs], 1)
        reg_all = torch.cat([o[1].reshape(n, -1, 4).float() * s
                             for o, s in zip(outs, STRIDES)], 1)
        ctr_all = torch.cat([o[2].reshape(n, -1) for o in outs], 1).float()

        num_pos = pos.sum().float().clamp_min(1.0)
        onehot = F.one_hot(cls_t.long(), c + 1)[..., :c].float()
        cls_loss = sigmoid_focal_loss(cls_all.float(), onehot).sum() / num_pos
        giou = 1.0 - aligned_iou(distance2bbox(points[None], reg_all),
                                 distance2bbox(points[None], ltrb_t),
                                 mode="giou")
        w = torch.where(pos, ctr_t, 0.0)
        box_loss = (giou * w).sum() / w.sum().clamp_min(1e-6)
        ctr_bce = (ctr_all.clamp_min(0) - ctr_all * ctr_t
                   + torch.log1p(torch.exp(-ctr_all.abs())))
        ctr_loss = torch.where(pos, ctr_bce, 0.0).sum() / num_pos
        return cls_loss + box_loss + ctr_loss


def fcos_r50(num_classes=80, **kwargs):
    return FCOS(num_classes=num_classes, **kwargs)


def fcos_dcn_r50(num_classes=80, **kwargs):
    """FCOS with a modulated deformable conv as each head tower's last
    conv."""
    return FCOS(num_classes=num_classes, dcn_last=True, **kwargs)
