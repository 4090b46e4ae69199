"""Fixed-capacity, padded non-maximum suppression (counterpart of
``tlxcv_tpu/ops/nms.py``).

Every output has a fixed size plus a validity mask or count, as in the
reference.  Where the reference ``vmap``s one image, these functions take
the whole batch at once: each of the K greedy steps is a handful of
batched tensor ops with no Python loop over images and no read back to the
host, so the steps queue on the card without a stall.

Ties resolve as in the reference: ``argmax`` and ``torch.max`` take the
first index, and ``lax.top_k`` / ``jnp.argsort`` order (descending, the
lower index first among equals) is a stable descending sort.
"""
from __future__ import annotations

import torch

from .boxes import pairwise_iou

__all__ = ["nms", "batched_class_nms", "multiclass_nms", "matrix_nms",
           "top_k", "take_per_image"]

NEG_INF = -1e9


def top_k(x, k):
    """``lax.top_k`` along the last dim: the k largest, descending, equal
    values in index order (``torch.topk`` promises no order for ties)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def take_per_image(t, idx):
    """Per-image rows: t [N, A, ...], idx [N, K] -> [N, K, ...]."""
    idx = idx.reshape(*idx.shape, *(1,) * (t.ndim - 2))
    return torch.gather(t, 1, idx.expand(*idx.shape[:2], *t.shape[2:]))


def nms(boxes, scores, iou_threshold: float = 0.5,
        max_outputs: int | None = None, score_threshold: float | None = None):
    """Greedy NMS over ``boxes [A, 4]`` / ``scores [A]``, or a batch
    ``[N, A, 4]`` / ``[N, A]`` with each image suppressed on its own.

    Returns ``(keep_idx [(N,) K], keep_mask [(N,) K])`` with K =
    max_outputs (or A); kept indices in score order.  K steps, not A: each
    takes every image's current best, emits it and suppresses its
    overlaps.  The IoU of every pair is computed once up front, as the
    reference's per-step row computes it (O(N·A²) memory; A is the
    pre-NMS candidate count, 512 at most in Mask R-CNN)."""
    single = boxes.ndim == 2
    if single:
        boxes, scores = boxes[None], scores[None]
    n, num = scores.shape
    k = num if max_outputs is None else min(max_outputs, num)
    work = scores.float()
    if score_threshold is not None:
        work = torch.where(scores >= score_threshold, work, NEG_INF)
    iou = pairwise_iou(boxes, boxes)                   # [N, A, A]
    rows = torch.arange(n, device=work.device)
    idxs, keeps = [], []
    for _ in range(k):
        best, idx = work.max(dim=1)                    # first index on ties
        keep = best > NEG_INF / 2
        suppress = (iou[rows, idx] > iou_threshold) & keep[:, None]
        work = work.masked_fill(suppress, NEG_INF)
        work[rows, idx] = NEG_INF
        idxs.append(idx)
        keeps.append(keep)
    idxs, keeps = torch.stack(idxs, 1), torch.stack(keeps, 1)
    return (idxs[0], keeps[0]) if single else (idxs, keeps)


def batched_class_nms(boxes, scores, class_ids, iou_threshold: float,
                      max_outputs: int, score_threshold: float | None = None):
    """Class-aware NMS by the coordinate-offset trick (torchvision's
    batched_nms).  The offset is each image's own ``boxes.max() + 1``, as
    the reference takes it under its per-image ``vmap``."""
    per_image = boxes.amax(dim=(-2, -1), keepdim=True)  # [(N,) 1, 1]
    offs = class_ids.to(boxes.dtype)[..., None] * (per_image + 1.0)
    return nms(boxes + offs, scores, iou_threshold, max_outputs,
               score_threshold)


def _dets(labels, scores, boxes, valid):
    """[N, K, 6] rows [label, score, x1, y1, x2, y2]; invalid rows are
    [-1, 0, 0, 0, 0, 0] (built on the device: no host constant to copy)."""
    label = torch.where(valid, labels.to(boxes.dtype), -1.0)
    rest = torch.where(valid[..., None],
                       torch.cat([scores.to(boxes.dtype)[..., None], boxes],
                                 -1), 0.0)
    return torch.cat([label[..., None], rest], -1)


def multiclass_nms(bboxes, scores, score_threshold: float = 0.7,
                   nms_threshold: float = 0.45, nms_top_k: int = 1000,
                   keep_top_k: int = 100, class_agnostic: bool = False):
    """Batched multiclass NMS with static output shapes.

    bboxes [N, A, 4] xyxy, scores [N, A, C].  Each box keeps its best
    class only; the best ``nms_top_k`` by that score go through
    class-aware NMS; ``keep_top_k`` survive.  Returns ``dets [N,
    keep_top_k, 6]`` (rows [label, score, x1, y1, x2, y2], invalid rows
    [-1, 0, 0, 0, 0, 0]) and ``count [N]``."""
    cls_conf, cls_id = scores.max(dim=-1)              # first index on ties
    conf = torch.where(cls_conf >= score_threshold, cls_conf.float(),
                       NEG_INF)
    top = min(nms_top_k, conf.shape[1])
    cand = top_k(conf, top)[1]
    cboxes, cconf, ccls = (take_per_image(t, cand)
                           for t in (bboxes, conf, cls_id))
    if class_agnostic:
        keep, mask = nms(cboxes, cconf, nms_threshold, keep_top_k)
    else:
        keep, mask = batched_class_nms(cboxes, cconf, ccls, nms_threshold,
                                       keep_top_k)
    det = _dets(*(take_per_image(t, keep) for t in (ccls, cconf, cboxes)),
                mask)
    return det, mask.sum(-1)


def matrix_nms(bboxes, scores, score_threshold: float = 0.05,
               keep_top_k: int = 100, use_gaussian: bool = False,
               gaussian_sigma: float = 2.0, pre_top_k: int = 512):
    """Matrix NMS (SOLOv2): parallel score decay, no loop.  bboxes [N, A,
    4], scores [N, A, C] -> the layout of :func:`multiclass_nms`.  Among
    equal scores the lower candidate index counts as higher, so duplicate
    boxes decay each other (SOLOv2's triu(diagonal=1))."""
    conf, cls_id = scores.max(dim=-1)
    conf = torch.where(conf >= score_threshold, conf.float(), 0.0)
    top = min(pre_top_k, conf.shape[1])
    conf, cand = top_k(conf, top)
    boxes = take_per_image(bboxes, cand)
    cls_id = take_per_image(cls_id, cand)
    iou = pairwise_iou(boxes, boxes)
    same = cls_id[..., :, None] == cls_id[..., None, :]
    rank = torch.arange(top, device=conf.device)
    higher = (conf[..., :, None] < conf[..., None, :]) | (
        (conf[..., :, None] == conf[..., None, :])
        & (rank[:, None] > rank[None, :]))
    max_decay = torch.where(same & higher, iou, 0.0).amax(dim=-1)
    if use_gaussian:
        decay = torch.exp(-(max_decay ** 2) / gaussian_sigma)
    else:
        decay = 1.0 - max_decay
    top_s, top_i = top_k(conf * decay, min(keep_top_k, top))
    valid = top_s > 0
    det = _dets(take_per_image(cls_id, top_i), top_s,
                take_per_image(boxes, top_i), valid)
    return det, valid.sum(-1)
