"""Detection transforms (counterpart of ``tlxcv_tpu/data/det_transforms.py``).

Host side: per-sample numpy and cv2 ops, as the reference's (cv2 for the
resizes and the polygon masks).  ``PadGTSingle``'s padded output is what
the on-device assigners consume: static shapes.

``detr_post_process`` and ``detr_post_process_segmentation`` take DETR's
outputs as tensors and compute on their device, returning tensors there.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

try:
    import cv2
except Exception:  # pragma: no cover - the resizes need it, as the reference
    cv2 = None

__all__ = ["LabelFormatConvert", "DetResize", "DetNormalize", "PadGTSingle",
           "DetCompose", "corners_to_center_format",
           "center_to_corners_format", "detr_post_process",
           "detr_post_process_segmentation"]


def corners_to_center_format(x):
    """xyxy -> cxcywh (numpy f32)."""
    x = np.asarray(x, np.float32)
    x0, y0, x1, y1 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    return np.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], -1)


def center_to_corners_format(x):
    """cxcywh -> xyxy, on numpy arrays or tensors."""
    xc, yc, w, h = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    stack = torch.stack if isinstance(x, torch.Tensor) else np.stack
    return stack([xc - 0.5 * w, yc - 0.5 * h, xc + 0.5 * w, yc + 0.5 * h], -1)


def _poly_to_mask(segmentations, height, width):
    """COCO polygon segmentations rasterised to binary masks by cv2's
    ``fillPoly``; without cv2 the masks stay empty, as the reference's."""
    masks = []
    for polygons in segmentations:
        m = np.zeros((height, width), np.uint8)
        if cv2 is not None and isinstance(polygons, (list, tuple)):
            pts = [np.asarray(p, np.float32).reshape(-1, 2).astype(np.int32)
                   for p in polygons if len(p) >= 6]
            if pts:
                cv2.fillPoly(m, pts, 1)
        masks.append(m.astype(bool))
    if masks:
        return np.stack(masks, 0)
    return np.zeros((0, height, width), bool)


class LabelFormatConvert:
    """COCO annotation list -> DETR-style target dict."""

    def __init__(self, return_segmentation_masks=True):
        self.return_masks = return_segmentation_masks

    def __call__(self, data):
        image, label = data[0], data[1]
        anno = label["annotations"] if isinstance(label, dict) else label
        h, w = image.shape[:2]
        anno = [o for o in anno if o.get("iscrowd", 0) == 0]

        boxes = np.asarray([o["bbox"] for o in anno],
                           np.float32).reshape(-1, 4)
        boxes[:, 2:] += boxes[:, :2]
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
        classes = np.asarray([o["category_id"] for o in anno], np.int64)

        keep = (boxes[:, 3] > boxes[:, 1]) & (boxes[:, 2] > boxes[:, 0])
        target = {"boxes": boxes[keep], "class_labels": classes[keep]}
        if self.return_masks:
            masks = _poly_to_mask([o.get("segmentation", []) for o in anno],
                                  h, w)
            target["masks"] = masks[keep]
        target["area"] = np.asarray([o.get("area", 0.0) for o in anno],
                                    np.float32)[keep]
        target["iscrowd"] = np.asarray([o.get("iscrowd", 0) for o in anno],
                                       np.int64)[keep]
        target["orig_size"] = np.asarray((w, h), np.int64)
        target["size"] = np.asarray((w, h), np.int64)
        return image, target


class DetResize:
    """Aspect-preserving resize with a max_size cap and optional
    size-divisibility rounding; rescales boxes, area and masks."""

    def __init__(self, size, max_size=None, auto_divide=None):
        self.size = size
        self.max_size = max_size
        self.auto_divide = auto_divide

    @staticmethod
    def _aspect_size(hw, shape, max_shape):
        h, w = hw
        if max_shape is not None:
            mn, mx = float(min(w, h)), float(max(w, h))
            if mx / mn * shape > max_shape:
                shape = int(round(max_shape * mn / mx))
        if (w <= h and w == shape) or (h <= w and h == shape):
            return (h, w)
        if w < h:
            return (int(shape * h / w), shape)
        return (shape, int(shape * w / h))

    def __call__(self, data):
        image, target = data
        if isinstance(self.size, (list, tuple)):
            size = tuple(self.size)
        else:
            size = self._aspect_size(image.shape[:2], self.size,
                                     self.max_size)
        if self.auto_divide:
            d = self.auto_divide
            size = tuple(x + (d - x % d) % d for x in size)
        oh, ow = size
        resized = cv2.resize(image, (ow, oh),
                             interpolation=cv2.INTER_LINEAR)
        rh = oh / image.shape[0]
        rw = ow / image.shape[1]

        target = dict(target) if target else {}
        if "orig_size" not in target:
            h, w = image.shape[:2]
            target["orig_size"] = np.asarray((w, h), np.int64)
        if "boxes" in target:
            target["boxes"] = target["boxes"] * np.asarray(
                [rw, rh, rw, rh], np.float32)
        if "area" in target:
            target["area"] = target["area"] * (rw * rh)
        target["size"] = np.asarray(size, np.int64)
        target["im_shape"] = np.asarray(image.shape[:2], np.int64)
        if "scale_factor" in target:
            target["scale_factor"] = target["scale_factor"] * (rw, rh)
        else:
            target["scale_factor"] = (target["size"]
                                      / np.maximum(target["orig_size"], 1))
        if "masks" in target and len(target["masks"]):
            m = np.transpose(target["masks"], (1, 2, 0)).astype(np.float32)
            m = cv2.resize(m, (ow, oh), interpolation=cv2.INTER_NEAREST)
            if m.ndim == 2:
                m = m[..., None]
            target["masks"] = np.transpose(m > 0.5, (2, 0, 1))
        elif "masks" in target:
            target["masks"] = np.zeros((0, oh, ow), bool)
        return resized, target


class DetNormalize:
    """Pixel normalize + boxes to normalized cxcywh."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, data):
        image, target = data
        image = (np.asarray(image, np.float32) / 255.0 - self.mean) / self.std
        if target is None:
            return image, None
        target = dict(target)
        h, w = image.shape[:2]
        if "boxes" in target:
            boxes = corners_to_center_format(target["boxes"])
            target["boxes"] = boxes / np.asarray([w, h, w, h], np.float32)
        return image, target


class PadGTSingle:
    """Pad GT to a static box budget + validity mask: the contract every
    on-device assigner consumes."""

    def __init__(self, num_max_boxes=200, return_gt_mask=True):
        self.num_max_boxes = num_max_boxes
        self.return_gt_mask = return_gt_mask

    def __call__(self, data):
        im, sample = data
        sample = dict(sample)
        n_max = self.num_max_boxes
        num_gt = min(len(sample["boxes"]), n_max)
        pad_cls = np.zeros((n_max,), np.int32)
        pad_box = np.zeros((n_max, 4), np.float32)
        if num_gt > 0:
            pad_cls[:num_gt] = np.asarray(sample["class_labels"])[:num_gt]
            pad_box[:num_gt] = sample["boxes"][:num_gt]
        out = {"boxes": pad_box, "class_labels": pad_cls}
        if self.return_gt_mask:
            mask = np.zeros((n_max,), np.float32)
            mask[:num_gt] = 1.0
            out["pad_gt_mask"] = mask
        if "gt_score" in sample:
            sc = np.zeros((n_max,), np.float32)
            sc[:num_gt] = np.asarray(sample["gt_score"])[:num_gt]
            out["scores"] = sc
        return im, out


class DetCompose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, *data):
        if len(data) == 2:
            data = (data[0], data[1])
        else:
            data = data[0]
        for t in self.transforms:
            data = t(data)
        return data


def _softmax(logits):
    """The reference's f32 softmax: exp(x - max) over its sum."""
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def detr_post_process(out_logits, out_bbox, target_sizes, top_k=None):
    """DETR raw outputs -> per-image ``{scores, labels, boxes}`` with boxes
    in pixels, tensors on the outputs' device.  out_logits [B, Q, C+1]
    (the last class is no-object), out_bbox [B, Q, 4] normalized cxcywh,
    target_sizes [B, 2] = (h, w).  Queries of label 0 are dropped; with
    ``top_k``, the highest scores are kept (ties in query order)."""
    logits = torch.as_tensor(out_logits).float()
    dev = logits.device
    boxes = torch.as_tensor(out_bbox, device=dev).float()
    sizes = torch.as_tensor(target_sizes, device=dev)
    prob = _softmax(logits)
    scores, labels = prob[..., :-1].max(-1)
    xyxy = center_to_corners_format(boxes)
    scale = torch.stack([sizes[:, 1], sizes[:, 0], sizes[:, 1], sizes[:, 0]],
                        1).float()
    xyxy = xyxy * scale[:, None, :]
    results = []
    for s, l, b in zip(scores, labels, xyxy):
        keep = l != 0
        s, l, b = s[keep], l[keep], b[keep]
        if top_k is not None and len(s) > top_k:
            idx = torch.argsort(-s, stable=True)[:top_k]
            s, l, b = s[idx], l[idx], b[idx]
        results.append({"scores": s, "labels": l, "boxes": b})
    return results


def detr_post_process_segmentation(pred_logits, pred_masks, target_sizes,
                                   threshold=0.9, mask_threshold=0.5):
    """DETR's segmentation outputs -> per-image ``{scores, labels, masks}``
    on their device: queries that are not no-object and score above
    ``threshold``; their mask logits [Q, h, w] resized bilinearly
    (half-pixel centres) to the target size, then sigmoid >
    ``mask_threshold`` as int32."""
    logits = torch.as_tensor(pred_logits).float()
    dev = logits.device
    masks = torch.as_tensor(pred_masks, device=dev).float()
    preds = []
    for lg, mk, size in zip(logits, masks, torch.as_tensor(target_sizes)):
        scores, labels = _softmax(lg).max(-1)
        keep = (labels != lg.shape[-1] - 1) & (scores > threshold)
        cur = mk[keep]
        hw = (int(size[0]), int(size[1]))
        if len(cur):
            cur = F.interpolate(cur[None], size=hw, mode="bilinear",
                                align_corners=False)[0]
        else:
            cur = torch.zeros((0, *hw), dtype=torch.float32, device=dev)
        cur = (torch.sigmoid(cur) > mask_threshold).to(torch.int32)
        preds.append({"scores": scores[keep], "labels": labels[keep],
                      "masks": cur})
    return preds
