"""Anchor and prior-box generation (a copy of ``tlxcv_tpu/ops/anchors.py``,
numpy only, so that the port stands alone).

Host-side numpy: anchors are static per model configuration and input
size; the models compute them once per size and device and keep them on
the device (``SSD.priors``, ``PPYOLOEHead._anchors``).
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["ssd_prior_box", "ssd_prior_boxes", "anchor_points",
           "grid_cell_anchors"]


def _expand_aspect_ratios(aspect_ratios, flip):
    out = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - o) < 1e-6 for o in out):
            out.append(float(ar))
            if flip:
                out.append(1.0 / float(ar))
    return out


def ssd_prior_box(feature_hw, image_hw, min_sizes, max_sizes=None,
                  aspect_ratios=(1.0,), steps=(0.0, 0.0), offset=0.5,
                  flip=False, clip=False, min_max_aspect_ratios_order=False,
                  variance=(0.1, 0.1, 0.2, 0.2)):
    """One feature level of SSD priors (paddle prior_box semantics).

    Returns (boxes [H, W, P, 4] normalized xyxy, variances [H, W, P, 4]).
    """
    fh, fw = feature_hw
    ih, iw = image_hw
    step_w = steps[0] or iw / fw
    step_h = steps[1] or ih / fh
    ars = _expand_aspect_ratios(aspect_ratios, flip)
    if not isinstance(min_sizes, (list, tuple)):
        min_sizes = [min_sizes]
    max_sizes = list(max_sizes) if max_sizes else []

    wh = []  # (box_w, box_h) per prior, paddle ordering
    for i, ms in enumerate(min_sizes):
        if not min_max_aspect_ratios_order:
            for ar in ars:
                wh.append((ms * math.sqrt(ar), ms / math.sqrt(ar)))
            if max_sizes:
                s = math.sqrt(ms * max_sizes[i])
                wh.append((s, s))
        else:
            wh.append((ms, ms))
            if max_sizes:
                s = math.sqrt(ms * max_sizes[i])
                wh.append((s, s))
            for ar in ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                wh.append((ms * math.sqrt(ar), ms / math.sqrt(ar)))
    wh = np.asarray(wh, np.float32)  # [P, 2]

    cx = (np.arange(fw, dtype=np.float32) + offset) * step_w
    cy = (np.arange(fh, dtype=np.float32) + offset) * step_h
    cxg, cyg = np.meshgrid(cx, cy)  # [H, W]
    cxg = cxg[..., None]
    cyg = cyg[..., None]
    bw = wh[None, None, :, 0] * 0.5
    bh = wh[None, None, :, 1] * 0.5
    boxes = np.stack([(cxg - bw) / iw, (cyg - bh) / ih,
                      (cxg + bw) / iw, (cyg + bh) / ih], axis=-1)
    if clip:
        boxes = np.clip(boxes, 0.0, 1.0)
    variances = np.broadcast_to(np.asarray(variance, np.float32),
                                boxes.shape).copy()
    return boxes.astype(np.float32), variances


def ssd_prior_boxes(feature_hws, image_hw,
                    steps=(8, 16, 32, 64, 100, 300),
                    aspect_ratios=((2.0,), (2.0, 3.0), (2.0, 3.0), (2.0, 3.0),
                                   (2.0,), (2.0,)),
                    min_sizes=(30.0, 60.0, 111.0, 162.0, 213.0, 264.0),
                    max_sizes=(60.0, 111.0, 162.0, 213.0, 264.0, 315.0),
                    offset=0.5, flip=True, clip=False,
                    min_max_aspect_ratios_order=False):
    """All SSD levels concatenated -> [A, 4] normalized xyxy
    (reference AnchorGeneratorSSD defaults, utils/layers.py:14-43)."""
    out = []
    for hw, ms, mx, ar, st in zip(feature_hws, min_sizes, max_sizes,
                                  aspect_ratios, steps):
        b, _ = ssd_prior_box(hw, image_hw, ms, [mx] if np.isscalar(mx) else mx,
                             ar, (st, st), offset, flip, clip,
                             min_max_aspect_ratios_order)
        out.append(b.reshape(-1, 4))
    return np.concatenate(out, axis=0)


def anchor_points(feature_hws, strides, offset=0.5):
    """Anchor-free center points for all levels.

    Returns (points [A, 2] in input pixels, stride_per_point [A, 1]).
    (reference ppyoloe.py:1801 generate_anchors_for_grid_cell companion)
    """
    pts, strs = [], []
    for (h, w), s in zip(feature_hws, strides):
        xs = (np.arange(w, dtype=np.float32) + offset) * s
        ys = (np.arange(h, dtype=np.float32) + offset) * s
        xg, yg = np.meshgrid(xs, ys)
        pts.append(np.stack([xg, yg], -1).reshape(-1, 2))
        strs.append(np.full((h * w, 1), s, np.float32))
    return np.concatenate(pts, 0), np.concatenate(strs, 0)


def grid_cell_anchors(feature_hws, strides, grid_cell_scale=5.0, offset=0.5):
    """Grid-cell anchors for ATSS assignment (PPYOLOE).

    Returns (anchors [A, 4] xyxy, centers [A, 2], stride_per_anchor [A, 1],
    num_anchors_per_level list).
    (reference ppyoloe.py:1801-1860 generate_anchors_for_grid_cell)
    """
    anchors, centers, strs, counts = [], [], [], []
    for (h, w), s in zip(feature_hws, strides):
        cell = grid_cell_scale * s
        xs = (np.arange(w, dtype=np.float32) + offset) * s
        ys = (np.arange(h, dtype=np.float32) + offset) * s
        xg, yg = np.meshgrid(xs, ys)
        c = np.stack([xg, yg], -1).reshape(-1, 2)
        half = cell * 0.5
        anchors.append(np.concatenate([c - half, c + half], -1))
        centers.append(c)
        strs.append(np.full((h * w, 1), s, np.float32))
        counts.append(h * w)
    return (np.concatenate(anchors, 0), np.concatenate(centers, 0),
            np.concatenate(strs, 0), counts)
