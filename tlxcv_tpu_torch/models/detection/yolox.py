"""YOLOX (counterpart of ``tlxcv_tpu/models/detection/yolox.py``), NHWC, to
Megvii's YOLOX: a CSPDarknet backbone whose Focus stem is a space-to-depth
reshape (``_focus``), SiLU throughout, an SPP bottleneck; the PAFPN neck; a
decoupled head (class; box and objectness) on strides 8, 16 and 32.  The
sizes are depth and width multipliers (``SIZES``: nano .33/.25 to x
1.33/1.25).

Eval returns ``(dets [B, keep_top_k, 6], counts [B])``: each cell's centre
plus its offset times the stride, its size exp(pred) times the stride,
score sigmoid(cls) · sigmoid(obj), the class-aware ``multiclass_nms``.
Training returns the head's outputs for ``loss_fn``: SimOTA per image
(``simota_assign``: dynamic k from the top-10 IoUs, each GT's k cheapest
candidates, a point claimed twice going to its cheaper GT), then BCE on
the objectness over every point and on the classes and 1 - IoU² over the
foreground.

No kernel of ours runs here: the PAFPN's 2x resizes are the reference's
nearest (``fcos._resize_nearest``), followed by a concatenation.
"""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...device import resolve_device
from ...ops.boxes import aligned_iou, pairwise_iou
from ...ops.nms import multiclass_nms, top_k
from ...ops.space_to_depth import block_space_to_depth
from .fcos import _normal_001, _resize_nearest, ground_truth
from .mask_rcnn import _take
from .tood import _points

__all__ = ["YOLOX", "YOLOXHead", "CSPDarknetX", "YOLOXPAFPN",
           "simota_assign", "yolox"]

STRIDES = (8, 16, 32)
SIZES = {"yolox_nano": (0.33, 0.25), "yolox_tiny": (0.33, 0.375),
         "yolox_s": (0.33, 0.50), "yolox_m": (0.67, 0.75),
         "yolox_l": (1.0, 1.0), "yolox_x": (1.33, 1.25)}


class ConvBN(tnn.Module):
    """Conv (no bias, 'same' padding), BatchNorm, SiLU."""

    def __init__(self, c_in, c_out, k=1, s=1, device=None, generator=None):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, k, stride=s, padding=k // 2,
                              bias=False, device=device, generator=generator)
        self.bn = nn.BatchNorm(c_out, device=device)

    def forward(self, x):
        return torch.nn.functional.silu(self.bn(self.conv(x)))


class Bottleneck(tnn.Module):
    def __init__(self, c, shortcut=True, expansion=0.5, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        h = int(c * expansion)
        self.cv1 = ConvBN(c, h, 1, **kw)
        self.cv2 = ConvBN(h, c, 3, **kw)
        self.shortcut = shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class CSPLayer(tnn.Module):
    """Two 1x1 branches, ``n`` bottlenecks on the first, concatenated
    (the bottlenecks' branch first) and fused by a 1x1."""

    def __init__(self, c_in, c_out, n=1, shortcut=True, expansion=0.5,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        h = int(c_out * expansion)
        self.cv1 = ConvBN(c_in, h, 1, **kw)
        self.cv2 = ConvBN(c_in, h, 1, **kw)
        self.cv3 = ConvBN(2 * h, c_out, 1, **kw)
        self.blocks = tnn.ModuleList([Bottleneck(h, shortcut, 1.0, **kw)
                                      for _ in range(n)])

    def forward(self, x):
        a = self.cv1(x)
        for b in self.blocks:
            a = b(a)
        return self.cv3(torch.cat([a, self.cv2(x)], -1))


class SPPBottleneck(tnn.Module):
    def __init__(self, c_in, c_out, ks=(5, 9, 13), device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        h = c_in // 2
        self.cv1 = ConvBN(c_in, h, 1, **kw)
        self.cv2 = ConvBN(h * (len(ks) + 1), c_out, 1, **kw)
        self.pools = tnn.ModuleList([nn.MaxPool2d(k, 1, k // 2) for k in ks])

    def forward(self, x):
        x = self.cv1(x)
        return self.cv2(torch.cat([x] + [p(x) for p in self.pools], -1))


def _focus(x):
    """Space-to-depth 2x: [N, H, W, C] -> [N, H/2, W/2, 4C], channels in
    (row parity, column parity, C) order: the Focus stem as one reshape,
    ``ops.space_to_depth``'s blocked layout at 2 x 2."""
    return block_space_to_depth(x, 2, 2)


class CSPDarknetX(tnn.Module):
    """The stem on the focused image, then four stages (a stride-2
    ConvBN and a CSPLayer; the last with the SPP bottleneck between);
    returns C3, C4, C5."""

    def __init__(self, depth_mul=1.0, width_mul=1.0, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)

        def w(c):
            return max(int(c * width_mul), 8)

        def d(n):
            return max(round(n * depth_mul), 1)

        self.stem = ConvBN(12, w(64), 3, **kw)
        self.dark2 = tnn.ModuleList([ConvBN(w(64), w(128), 3, 2, **kw),
                                     CSPLayer(w(128), w(128), d(3), **kw)])
        self.dark3 = tnn.ModuleList([ConvBN(w(128), w(256), 3, 2, **kw),
                                     CSPLayer(w(256), w(256), d(9), **kw)])
        self.dark4 = tnn.ModuleList([ConvBN(w(256), w(512), 3, 2, **kw),
                                     CSPLayer(w(512), w(512), d(9), **kw)])
        self.dark5 = tnn.ModuleList([
            ConvBN(w(512), w(1024), 3, 2, **kw),
            SPPBottleneck(w(1024), w(1024), **kw),
            CSPLayer(w(1024), w(1024), d(3), shortcut=False, **kw)])
        self.out_channels = (w(256), w(512), w(1024))

    def forward(self, x):
        x = self.stem(_focus(x))
        outs = []
        for stage in (self.dark2, self.dark3, self.dark4, self.dark5):
            for blk in stage:
                x = blk(x)
            outs.append(x)
        return tuple(outs[1:])


class YOLOXPAFPN(tnn.Module):
    """Top-down (1x1 reduce, nearest 2x, concatenate, CSPLayer) then
    bottom-up (stride-2 ConvBN, concatenate, CSPLayer) over C3-C5."""

    def __init__(self, in_channels, depth_mul=1.0, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        c3, c4, c5 = in_channels
        n = max(round(3 * depth_mul), 1)
        self.reduce0 = ConvBN(c5, c4, 1, **kw)
        self.csp_td0 = CSPLayer(2 * c4, c4, n, shortcut=False, **kw)
        self.reduce1 = ConvBN(c4, c3, 1, **kw)
        self.csp_td1 = CSPLayer(2 * c3, c3, n, shortcut=False, **kw)
        self.down0 = ConvBN(c3, c3, 3, 2, **kw)
        self.csp_bu0 = CSPLayer(2 * c3, c4, n, shortcut=False, **kw)
        self.down1 = ConvBN(c4, c4, 3, 2, **kw)
        self.csp_bu1 = CSPLayer(2 * c4, c5, n, shortcut=False, **kw)
        self.out_channels = (c3, c4, c5)

    def forward(self, feats):
        c3, c4, c5 = feats
        p5 = self.reduce0(c5)
        p4 = self.csp_td0(torch.cat([_resize_nearest(p5, c4.shape[1:3]), c4],
                                    -1))
        p4r = self.reduce1(p4)
        p3 = self.csp_td1(torch.cat([_resize_nearest(p4r, c3.shape[1:3]),
                                     c3], -1))
        n4 = self.csp_bu0(torch.cat([self.down0(p3), p4r], -1))
        n5 = self.csp_bu1(torch.cat([self.down1(n4), p5], -1))
        return p3, n4, n5


class YOLOXHead(tnn.Module):
    """Per level: a 1x1 stem, two 3x3 ConvBNs for the classes and two for
    the box, then 1x1 predictions of the classes, the box (dx, dy, log w,
    log h in strides) and the objectness, at normal(0.01)."""

    def __init__(self, in_channels, num_classes=80, feat_ch=256, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)

        def pair():
            return tnn.ModuleList([ConvBN(feat_ch, feat_ch, 3, **kw),
                                   ConvBN(feat_ch, feat_ch, 3, **kw)])

        def pred(c):
            return tnn.ModuleList([
                nn.Conv2d(feat_ch, c, 1, w_init=_normal_001, **kw)
                for _ in in_channels])

        self.stems = tnn.ModuleList([ConvBN(c, feat_ch, 1, **kw)
                                     for c in in_channels])
        self.cls_convs = tnn.ModuleList([pair() for _ in in_channels])
        self.reg_convs = tnn.ModuleList([pair() for _ in in_channels])
        self.cls_preds = pred(num_classes)
        self.reg_preds = pred(4)
        self.obj_preds = pred(1)
        self.num_classes = num_classes

    def forward(self, feats):
        """Per level: (class logits [N, H, W, C], box [N, H, W, 4],
        objectness logits [N, H, W, 1])."""
        outs = []
        for li, f in enumerate(feats):
            c = r = self.stems[li](f)
            for conv in self.cls_convs[li]:
                c = conv(c)
            for conv in self.reg_convs[li]:
                r = conv(r)
            outs.append((self.cls_preds[li](c), self.reg_preds[li](r),
                         self.obj_preds[li](r)))
        return outs


def _one_hot(labels, num_classes):
    """``jax.nn.one_hot``: an out-of-range label is a row of zeros."""
    return (labels[..., None] == torch.arange(
        num_classes, device=labels.device)).float()


def simota_assign(boxes, cls_prob, obj_prob, points, strides, gt_boxes,
                  gt_labels, gt_valid, num_classes, center_radius=2.5,
                  topk=10):
    """One image's SimOTA at static shapes: boxes [P, 4] decoded xyxy,
    cls_prob [P, C], obj_prob [P], points [P, 2], strides [P]; GTs padded
    to [M, ...].

    A point is a candidate of a valid GT it lies inside or within 2.5
    strides of its centre.  The cost is the class BCE plus 3 (-log IoU),
    1e5 more off the candidates; each GT takes its ``dyn_k`` cheapest
    candidates (``dyn_k``: the sum of its top-10 candidate IoUs, truncated
    to [1, 10]), found by ranking a fixed top-10 list, so a GT with no
    candidate takes nothing; a point two GTs take goes to the cheaper.
    Returns (matched GT [P], foreground [P])."""
    px, py = points[:, 0:1], points[:, 1:2]
    in_box = ((px > gt_boxes[None, :, 0]) & (px < gt_boxes[None, :, 2])
              & (py > gt_boxes[None, :, 1]) & (py < gt_boxes[None, :, 3]))
    cx = (gt_boxes[None, :, 0] + gt_boxes[None, :, 2]) * 0.5
    cy = (gt_boxes[None, :, 1] + gt_boxes[None, :, 3]) * 0.5
    rad = center_radius * strides[:, None]
    in_center = ((px - cx).abs() < rad) & ((py - cy).abs() < rad)
    valid = gt_valid > 0
    cand = ((in_box | in_center) & valid[None, :]).T          # [M, P]

    iou = pairwise_iou(gt_boxes, boxes)                       # [M, P]
    p = (cls_prob * obj_prob[:, None]).clamp(1e-8, 1 - 1e-8)  # [P, C]
    onehot = _one_hot(gt_labels, num_classes)                 # [M, C]
    bce = -(onehot @ torch.log(p).T + (1 - onehot) @ torch.log1p(-p).T)
    cost = bce + 3.0 * -torch.log(iou + 1e-8) + 1e5 * (~cand)

    topk = min(topk, boxes.shape[0])
    topk_iou = top_k(torch.where(cand, iou, 0.0), topk)[0]
    dyn_k = topk_iou.sum(-1).int().clamp(1, topk)             # [M]
    neg_cost, cand_idx = top_k(-cost, topk)                   # [M, topk]
    ranks = torch.arange(topk, device=boxes.device)[None, :]
    chosen = (ranks < dyn_k[:, None]) & valid[:, None] & (-neg_cost < 1e4)
    sel = torch.zeros(cost.shape, dtype=torch.bool,
                      device=boxes.device).scatter(1, cand_idx, chosen)
    best_gt = torch.where(sel, cost, torch.inf).argmin(0)
    return best_gt, sel.any(0)


class YOLOX(tnn.Module):
    """The detector: ``CSPDarknetX``, ``YOLOXPAFPN``, ``YOLOXHead``; eval
    keeps score 0.01, IoU 0.65, top 1000, keep 100."""

    def __init__(self, num_classes=80, depth_mul=1.0, width_mul=1.0,
                 score_threshold=0.01, nms_threshold=0.65, nms_top_k=1000,
                 keep_top_k=100, device=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.backbone = CSPDarknetX(depth_mul, width_mul, **kw)
        self.neck = YOLOXPAFPN(self.backbone.out_channels, depth_mul, **kw)
        self.head = YOLOXHead(self.neck.out_channels, num_classes, **kw)
        self.num_classes = num_classes
        self.nms_cfg = dict(score_threshold=score_threshold,
                            nms_threshold=nms_threshold,
                            nms_top_k=nms_top_k, keep_top_k=keep_top_k)

    def head_outputs(self, images):
        """(per-level head outputs, the levels' (H, W))."""
        outs = self.head(self.neck(self.backbone(images)))
        return outs, tuple(tuple(o[0].shape[1:3]) for o in outs)

    def _decode(self, outs, feat_hws):
        """Boxes [N, P, 4] xyxy pixels, class logits [N, P, C], objectness
        logits [N, P] (f32), the centres [P, 2] and strides [P]."""
        n, dev = outs[0][0].shape[0], outs[0][0].device
        points, strides = (torch.from_numpy(a).to(dev)
                           for a in _points(feat_hws, STRIDES))
        cls = torch.cat([o[0].reshape(n, -1, self.num_classes)
                         for o in outs], 1).float()
        reg = torch.cat([o[1].reshape(n, -1, 4) for o in outs], 1).float()
        obj = torch.cat([o[2].reshape(n, -1) for o in outs], 1).float()
        st = strides[None, :, None]
        xy = points[None] + reg[..., :2] * st
        wh = torch.exp(reg[..., 2:].clamp(-10.0, 10.0)) * st
        boxes = torch.cat([xy - wh * 0.5, xy + wh * 0.5], -1)
        return boxes, cls, obj, points, strides

    def forward(self, images):
        outs, feat_hws = self.head_outputs(images)
        if self.training:
            return {"outs": outs, "feat_hws": feat_hws,
                    "image_hw": tuple(images.shape[1:3])}
        return self.nms(*self.decode(outs, feat_hws))

    def decode(self, outs, feat_hws):
        """Boxes [N, P, 4] f32 (unclipped), scores [N, P, C]."""
        boxes, cls, obj, _, _ = self._decode(outs, feat_hws)
        return boxes, torch.sigmoid(cls) * torch.sigmoid(obj)[..., None]

    def nms(self, boxes, scores):
        return multiclass_nms(boxes, scores, **self.nms_cfg)

    def loss_fn(self, outputs, targets):
        """targets: ``boxes`` [B, M, 4] xyxy pixels, ``class_labels`` [B,
        M], optional ``mask`` [B, M] (default: boxes of positive width)."""
        gt_boxes, gt_labels, gt_valid = ground_truth(targets)
        boxes, cls, obj, points, strides = self._decode(
            outputs["outs"], outputs["feat_hws"])
        with torch.no_grad():
            best_gt, fg = (torch.stack(t) for t in zip(*(
                simota_assign(bx, torch.sigmoid(cl), torch.sigmoid(ob),
                              points, strides, gbx, glb, gvd,
                              self.num_classes)
                for bx, cl, ob, gbx, glb, gvd in zip(
                    boxes, cls, obj, gt_boxes, gt_labels, gt_valid))))
            onehot = _one_hot(gt_labels.gather(1, best_gt), self.num_classes)
            t_boxes = _take(gt_boxes, best_gt)
        num_fg = fg.sum().float().clamp_min(1.0)
        fgf = fg.float()
        obj_loss = (obj.clamp_min(0) - obj * fgf
                    + torch.log1p(torch.exp(-obj.abs()))).sum() / num_fg
        cls_bce = (cls.clamp_min(0) - cls * onehot
                   + torch.log1p(torch.exp(-cls.abs()))).sum(-1)
        cls_loss = torch.where(fg, cls_bce, 0.0).sum() / num_fg
        iou = aligned_iou(boxes, t_boxes)
        iou_loss = torch.where(fg, 1.0 - iou ** 2, 0.0).sum() / num_fg
        return obj_loss + cls_loss + 5.0 * iou_loss


def yolox(arch="yolox_s", num_classes=80, **kwargs):
    d, w = SIZES[arch]
    return YOLOX(num_classes=num_classes, depth_mul=d, width_mul=w, **kwargs)
