"""YOLO box decode, NHWC (counterpart of ``tlxcv_tpu/ops/yolo.py``):
paddle's ``yolo_box`` semantics for one head level."""
from __future__ import annotations

import torch

__all__ = ["yolo_box"]


def yolo_box(x, img_size, anchors, class_num: int, conf_thresh: float = 0.005,
             downsample_ratio: int = 32, clip_bbox: bool = True,
             scale_x_y: float = 1.0):
    """Decode one YOLO head level, in ``x``'s dtype.

    x: [N, H, W, na*(5+nc)] raw head output; img_size: [N, 2] image (h, w);
    anchors: flat [w0, h0, w1, h1, ...] in network-input pixels.  Returns
    boxes [N, H*W*na, 4] xyxy in image pixels (clipped to the image with
    ``clip_bbox``) and scores [N, H*W*na, class_num] = sigmoid(obj) *
    sigmoid(cls); both are zero where sigmoid(obj) < ``conf_thresh``."""
    n, h, w, _ = x.shape
    na = len(anchors) // 2
    dt, dev = x.dtype, x.device
    an = torch.tensor(anchors, dtype=dt, device=dev).reshape(na, 2)  # (w, h)

    x = x.reshape(n, h, w, na, 5 + class_num)
    tx, ty, tw, th = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    obj = torch.sigmoid(x[..., 4:5])
    cls = torch.sigmoid(x[..., 5:])

    gx = torch.arange(w, dtype=dt, device=dev).reshape(1, 1, w, 1)
    gy = torch.arange(h, dtype=dt, device=dev).reshape(1, h, 1, 1)
    bias = 0.5 * (scale_x_y - 1.0)
    cx = (gx + scale_x_y * torch.sigmoid(tx) - bias) / w
    cy = (gy + scale_x_y * torch.sigmoid(ty) - bias) / h
    # anchors are in network-input pixels; the clamp keeps exp finite on
    # untrained heads
    bw = torch.exp(tw.clamp(-10.0, 10.0)) * an[:, 0] / (w * downsample_ratio)
    bh = torch.exp(th.clamp(-10.0, 10.0)) * an[:, 1] / (h * downsample_ratio)

    img_h = img_size[:, 0].to(dt).reshape(n, 1, 1, 1)
    img_w = img_size[:, 1].to(dt).reshape(n, 1, 1, 1)
    x1 = (cx - bw * 0.5) * img_w
    y1 = (cy - bh * 0.5) * img_h
    x2 = (cx + bw * 0.5) * img_w
    y2 = (cy + bh * 0.5) * img_h
    if clip_bbox:  # jnp.clip: the lower bound first, then the upper
        x1 = torch.minimum(x1.clamp_min(0.0), img_w - 1.0)
        y1 = torch.minimum(y1.clamp_min(0.0), img_h - 1.0)
        x2 = torch.minimum(x2.clamp_min(0.0), img_w - 1.0)
        y2 = torch.minimum(y2.clamp_min(0.0), img_h - 1.0)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)

    keep = obj >= conf_thresh  # [n, h, w, na, 1]: broadcasts over the rest
    boxes = torch.where(keep, boxes, 0.0)
    scores = torch.where(keep, obj * cls, 0.0)
    return (boxes.reshape(n, h * w * na, 4),
            scores.reshape(n, h * w * na, class_num))
