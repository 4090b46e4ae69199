"""Face-detection utilities for RetinaFace (counterpart of
``tlxcv_tpu/tasks/face_recognition.py``): the dense priors, the
ground-truth-to-prior ``Encoder`` that feeds the input pipeline and its
inverse ``Decoder``, a numpy NMS, and ``detect_faces`` for one image.

Everything but the model's forward is numpy on the host.  ``detect_faces``
resizes as ``cv2.resize``'s ``INTER_LINEAR`` does, without OpenCV
(``models.ocr.transform.resize_linear``).
"""
from __future__ import annotations

import math
from itertools import product

import numpy as np
import torch

from ..models.ocr.transform import resize_linear

__all__ = ["nms_np", "prior_box", "Encoder", "Decoder", "Decocder",
           "post_process", "detect_faces"]


def nms_np(boxes, scores, threshold=0.4):
    """Greedy NMS of pixel ``xyxy`` boxes (areas counted inclusively, +1),
    highest score first; the kept indices."""
    keep = []
    order = scores.argsort()[::-1]
    x1, y1, x2, y2 = boxes.T
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    while order.size > 0:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        ovr = w * h / (areas[i] + areas[order[1:]] - w * h)
        order = order[1:][ovr <= threshold]
    return np.asarray(keep)


def prior_box(image_size, min_sizes=((16, 32), (64, 128), (256, 512)),
              steps=(8, 16, 32), clip=False):
    """RetinaFace's dense anchors, normalised ``cxcywh`` [A, 4]: for each
    level, row, column and min size, in that order."""
    w, h = image_size
    feat = [[math.ceil(w / s), math.ceil(h / s)] for s in steps]
    anchors = []
    for k, (f0, f1) in enumerate(feat):
        for i, j in product(range(f0), range(f1)):
            for ms in min_sizes[k]:
                anchors += [(j + 0.5) * steps[k] / h, (i + 0.5) * steps[k] / w,
                            ms / h, ms / w]
    out = np.asarray(anchors, np.float32).reshape(-1, 4)
    return np.clip(out, 0, 1) if clip else out


def _point_form(priors):
    return np.concatenate([priors[:, :2] - priors[:, 2:] / 2,
                           priors[:, :2] + priors[:, 2:] / 2], 1)


def _jaccard(a, b):
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None] - inter + 1e-9)


class Encoder:
    """Matches ground truth to priors and encodes the box and landmark
    offsets, on the host, for the input pipeline.  Each prior takes its
    best-overlapping face; each face whose best prior overlaps it by more
    than ``match_thresh`` claims that prior.  A prior is positive past
    ``match_thresh``, ignored (-1) between ``ignore_thresh`` and it."""

    def __init__(self, priors, variances=(0.1, 0.2), ignore_thresh=0.3,
                 match_thresh=0.45):
        if ignore_thresh > match_thresh:
            raise ValueError("ignore_thresh must not exceed match_thresh")
        self.priors = priors.astype(np.float32)
        self.variances = variances
        self.match_thresh = match_thresh
        self.ignore_thresh = ignore_thresh

    def __call__(self, labels):
        """``labels`` [N, 15]: normalised ``xyxy``, 10 landmark
        coordinates, landmark valid.  Returns [A, 16]: loc 4, landmarks 10,
        landmark valid, class."""
        bbox = labels[:, :4]
        landm = labels[:, 4:-1]
        landm_valid = labels[:, -1]

        overlaps = _jaccard(bbox, _point_form(self.priors))
        best_prior_overlap = overlaps.max(1)
        best_prior_idx = overlaps.argmax(1)
        best_truth_overlap = overlaps.max(0)
        best_truth_idx = overlaps.argmax(0)
        for i in range(len(best_prior_idx)):
            if best_prior_overlap[i] > self.match_thresh:
                best_truth_idx[best_prior_idx[i]] = i
                best_truth_overlap[best_prior_idx[i]] = 2.0

        loc_t = self._encode_bbox(bbox[best_truth_idx])
        landm_t = self._encode_landm(landm[best_truth_idx])
        conf_t = (best_truth_overlap > self.match_thresh).astype(np.float32)
        ignore = ((best_truth_overlap < self.match_thresh)
                  & (best_truth_overlap > self.ignore_thresh))
        conf_t = np.where(ignore, -np.ones_like(conf_t), conf_t)
        valid = (landm_valid[best_truth_idx] > 0).astype(np.float32)
        return np.concatenate([loc_t, landm_t, valid[:, None],
                               conf_t[:, None]], axis=1).astype(np.float32)

    def _encode_bbox(self, matched):
        p, (v0, v1) = self.priors, self.variances
        g_cxcy = ((matched[:, :2] + matched[:, 2:4]) / 2 - p[:, :2]) \
            / (v0 * p[:, 2:])
        g_wh = np.log(np.maximum(matched[:, 2:4] - matched[:, :2], 1e-9)
                      / p[:, 2:]) / v1
        return np.concatenate([g_cxcy, g_wh], 1)

    def _encode_landm(self, matched):
        p, (v0, _) = self.priors, self.variances
        pts = matched.reshape(-1, 5, 2)
        pp = np.tile(p[:, None, :], (1, 5, 1))
        return ((pts - pp[..., :2]) / (v0 * pp[..., 2:])).reshape(-1, 10)


class Decoder:
    """The inverse of ``Encoder`` on [A, 16] rows (or its box and landmark
    parts alone)."""

    def __init__(self, variances=(0.1, 0.2)):
        self.variances = variances

    def __call__(self, labels, priors):
        bbox = self.decode_bbox(labels[:, :4], priors)
        landm = self.decode_landm(labels[:, 4:14], priors)
        return np.concatenate([bbox, landm, labels[:, 14:15],
                               labels[:, 15:16]], 1)

    def decode_bbox(self, pre, priors):
        v0, v1 = self.variances
        centers = priors[:, :2] + pre[:, :2] * v0 * priors[:, 2:]
        sides = priors[:, 2:] * np.exp(pre[:, 2:] * v1)
        return np.concatenate([centers - sides / 2, centers + sides / 2], 1)

    def decode_landm(self, pre, priors):
        pts = pre.reshape(-1, 5, 2)
        pp = np.tile(priors[:, None, :], (1, 5, 1))
        return (pp[..., :2] + pts * self.variances[0]
                * pp[..., 2:]).reshape(-1, 10)


Decocder = Decoder  # the reference's (misspelled) public name


def post_process(bbox, cls, priors, side, score_th=0.5, iou_th=0.4):
    """One image's head outputs (numpy: ``bbox`` [A, 4] offsets, ``cls``
    [A, 2] scores) on a ``side``-pixel square frame with ``priors``
    (``prior_box``): priors decoded, scores over ``score_th`` kept, NMS at
    ``iou_th``.  Returns the faces' ``xyxy`` boxes in the frame's pixels
    [K, 4] and their scores [K]."""
    boxes = Decoder().decode_bbox(bbox, priors)
    scores = cls[:, 1]
    m = scores > score_th
    boxes, scores = boxes[m], scores[m]
    if len(boxes) == 0:
        return np.zeros((0, 4), np.float32), np.zeros((0,), np.float32)
    keep = nms_np(boxes * side, scores, iou_th)
    return boxes[keep] * side, scores[keep]


def detect_faces(image, model, trainer=None, score_th=0.5, iou_th=0.4,
                 input_size=640):
    """RetinaFace on one HWC image: the image scaled so that its longer
    side is ``input_size``, zero-padded to a square, normalised; priors
    decoded, scores over ``score_th`` kept, NMS at ``iou_th``.  Returns
    the faces' ``xyxy`` boxes in the image's pixels [K, 4]."""
    h, w = image.shape[:2]
    img = np.asarray(image, np.float32)
    scale = input_size / max(h, w)
    resized = resize_linear(img, (int(h * scale), int(w * scale)))
    canvas = np.zeros((input_size, input_size, 3), np.float32)
    canvas[:resized.shape[0], :resized.shape[1]] = resized
    canvas = (canvas - 127.5) / 128.0

    if trainer is not None:
        bbox, landm, cls = trainer.predict(canvas[None])
    else:
        p = next(model.parameters())
        with torch.no_grad():
            bbox, landm, cls = model(torch.from_numpy(canvas[None]).to(
                p.device, p.dtype))
    bbox, cls = (t.detach().float().cpu().numpy() for t in (bbox, cls))
    boxes, _ = post_process(bbox[0], cls[0],
                            prior_box((input_size, input_size)), input_size,
                            score_th, iou_th)
    return boxes / scale
