"""Box geometry (counterpart of ``tlxcv_tpu/ops/boxes.py``): xyxy boxes as
``[..., 4]`` tensors, every function broadcast over the leading dims.  The
arithmetic keeps the reference's operation order, so f32 results agree
with it to the last bit wherever the two frameworks' elementwise ops do.
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "xywh2xyxy", "xyxy2xywh", "box_area", "pairwise_iou", "aligned_iou",
    "bbox_iou", "bbox2delta", "delta2bbox", "distance2bbox", "bbox2distance",
    "batch_distance2bbox", "clip_boxes",
]

EPS = 1e-9


def xywh2xyxy(b):
    """[cx, cy, w, h] -> [x1, y1, x2, y2]."""
    cx, cy, w, h = b.split(1, dim=-1)
    return torch.cat([cx - w * 0.5, cy - h * 0.5, cx + w * 0.5,
                      cy + h * 0.5], -1)


def xyxy2xywh(b):
    x1, y1, x2, y2 = b.split(1, dim=-1)
    return torch.cat([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1], -1)


def box_area(b):
    return (torch.clamp_min(b[..., 2] - b[..., 0], 0)
            * torch.clamp_min(b[..., 3] - b[..., 1], 0))


def pairwise_iou(a, b):
    """IoU matrix between a [..., M, 4] and b [..., N, 4] -> [..., M, N]."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return inter / (union + EPS)


def aligned_iou(a, b, mode: str = "iou", eps: float = 1e-9):
    """Element-aligned IoU / GIoU / DIoU / CIoU of same-shape boxes."""
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])
    inter = torch.clamp_min(x2 - x1, 0) * torch.clamp_min(y2 - y1, 0)
    union = box_area(a) + box_area(b) - inter + eps
    iou = inter / union
    if mode == "iou":
        return iou
    cx1 = torch.minimum(a[..., 0], b[..., 0])
    cy1 = torch.minimum(a[..., 1], b[..., 1])
    cx2 = torch.maximum(a[..., 2], b[..., 2])
    cy2 = torch.maximum(a[..., 3], b[..., 3])
    if mode == "giou":
        c_area = (cx2 - cx1) * (cy2 - cy1) + eps
        return iou - (c_area - union) / c_area
    c2 = (cx2 - cx1) ** 2 + (cy2 - cy1) ** 2 + eps
    rho2 = (((a[..., 0] + a[..., 2]) - (b[..., 0] + b[..., 2])) ** 2 +
            ((a[..., 1] + a[..., 3]) - (b[..., 1] + b[..., 3])) ** 2) / 4.0
    if mode == "diou":
        return iou - rho2 / c2
    if mode == "ciou":
        wa = a[..., 2] - a[..., 0]
        ha = a[..., 3] - a[..., 1]
        wb = b[..., 2] - b[..., 0]
        hb = b[..., 3] - b[..., 1]
        v = (4 / math.pi ** 2) * (torch.atan(wb / (hb + eps))
                                  - torch.atan(wa / (ha + eps))) ** 2
        # a constant trade-off coefficient, as the reference's stop_gradient
        alpha = (v / (v - iou + 1 + eps)).detach()
        return iou - (rho2 / c2 + alpha * v)
    raise ValueError(f"unknown iou mode {mode!r}")


bbox_iou = aligned_iou


def bbox2delta(src, tgt, weights=(1.0, 1.0, 1.0, 1.0)):
    """Encode target boxes relative to anchors.  Widths and heights are
    clamped to 1e-4 before the log, so a padded all-zero target row encodes
    to a finite delta that a mask can zero."""
    eps = 1e-4
    sw = torch.clamp_min(src[..., 2] - src[..., 0], eps)
    sh = torch.clamp_min(src[..., 3] - src[..., 1], eps)
    scx = src[..., 0] + sw * 0.5
    scy = src[..., 1] + sh * 0.5
    tw = torch.clamp_min(tgt[..., 2] - tgt[..., 0], eps)
    th = torch.clamp_min(tgt[..., 3] - tgt[..., 1], eps)
    tcx = tgt[..., 0] + tw * 0.5
    tcy = tgt[..., 1] + th * 0.5
    wx, wy, ww, wh = weights
    return torch.stack([
        wx * (tcx - scx) / sw, wy * (tcy - scy) / sh,
        ww * torch.log(tw / sw), wh * torch.log(th / sh),
    ], dim=-1)


def delta2bbox(deltas, boxes, weights=(1.0, 1.0, 1.0, 1.0),
               max_ratio=16 / 1000.0):
    """Decode deltas against anchors.  A bf16 delta against f32 anchors
    gives f32 boxes, as the reference's type promotion does."""
    clip = abs(math.log(max_ratio))
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + w * 0.5
    cy = boxes[..., 1] + h * 0.5
    wx, wy, ww, wh = weights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, -clip, clip)
    dh = torch.clamp(deltas[..., 3] / wh, -clip, clip)
    pcx = cx + dx * w
    pcy = cy + dy * h
    pw = w * torch.exp(dw)
    ph = h * torch.exp(dh)
    return torch.stack([pcx - pw * 0.5, pcy - ph * 0.5,
                        pcx + pw * 0.5, pcy + ph * 0.5], dim=-1)


def distance2bbox(points, distance, max_shape=None):
    """(l, t, r, b) distances from points -> xyxy."""
    x1 = points[..., 0] - distance[..., 0]
    y1 = points[..., 1] - distance[..., 1]
    x2 = points[..., 0] + distance[..., 2]
    y2 = points[..., 1] + distance[..., 3]
    if max_shape is not None:
        h, w = max_shape
        x1, x2 = x1.clamp(0, w), x2.clamp(0, w)
        y1, y2 = y1.clamp(0, h), y2.clamp(0, h)
    return torch.stack([x1, y1, x2, y2], -1)


def bbox2distance(points, bbox, max_dis=None, eps=0.1):
    """xyxy -> (l, t, r, b) distances."""
    out = torch.stack([points[..., 0] - bbox[..., 0],
                       points[..., 1] - bbox[..., 1],
                       bbox[..., 2] - points[..., 0],
                       bbox[..., 3] - points[..., 1]], -1)
    if max_dis is not None:
        out = out.clamp(0, max_dis - eps)
    return out


def batch_distance2bbox(points, distance, max_shapes=None):
    """Batched distance decode; ``max_shapes`` [B, 2] (h, w) per image."""
    out = torch.cat([points - distance[..., :2], points + distance[..., 2:]],
                    -1)
    if max_shapes is not None:
        hw = max_shapes[..., None, :]  # [B, 1, 2] (h, w)
        maxes = torch.cat([hw[..., 1:2], hw[..., 0:1]] * 2, -1).to(out.dtype)
        out = torch.clamp(out, torch.zeros_like(maxes), maxes)
    return out


def clip_boxes(boxes, im_shape):
    """Clip xyxy boxes to (h, w)."""
    h, w = im_shape
    return torch.stack([
        boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
        boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h),
    ], dim=-1)
