"""Detection post-processing (counterpart of
``tlxcv_tpu/ops/post_process.py``): map padded detections from the network
input back to the original image, and unbatch them into per-image numpy
dicts.  The decode and the NMS happen inside each detector."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["rescale_dets", "cvt_results"]


def rescale_dets(dets, counts, scale_factor, orig_hw=None):
    """Padded dets [N, K, 6] (rows [label, score, x1, y1, x2, y2]) from
    network-input pixels to the original image: divide by each image's
    resize factor ``scale_factor`` [N, 2] (sy, sx), clip to ``orig_hw``
    [N, 2] (h, w) when given, and turn rows left without area into invalid
    rows [-1, 0, 0, 0, 0, 0].  Returns (dets, counts)."""
    sy = scale_factor[:, 0][:, None]
    sx = scale_factor[:, 1][:, None]
    boxes = dets[..., 2:6]
    boxes = torch.stack([boxes[..., 0] / sx, boxes[..., 1] / sy,
                         boxes[..., 2] / sx, boxes[..., 3] / sy], -1)
    if orig_hw is not None:
        h = orig_hw[:, 0].to(boxes.dtype)[:, None]
        w = orig_hw[:, 1].to(boxes.dtype)[:, None]
        zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
        boxes = torch.stack([
            torch.minimum(torch.maximum(boxes[..., i], zero), lim)
            for i, lim in enumerate((w, h, w, h))], -1)
    nonempty = ((boxes[..., 2] > boxes[..., 0])
                & (boxes[..., 3] > boxes[..., 1]) & (dets[..., 0] >= 0))
    dets = torch.cat([dets[..., :2], boxes], -1)
    invalid = torch.tensor([-1, 0, 0, 0, 0, 0], dtype=dets.dtype,
                           device=dets.device)
    return torch.where(nonempty[..., None], dets, invalid), nonempty.sum(-1)


def cvt_results(dets, counts):
    """Padded detections to a list of per-image dicts of numpy arrays
    (``labels`` int64, ``scores``, ``boxes``), on the host."""
    out = []
    dets = np.asarray(dets.detach().cpu() if torch.is_tensor(dets) else dets)
    counts = np.asarray(counts.cpu() if torch.is_tensor(counts) else counts)
    for det, n in zip(dets, counts):
        valid = det[det[:, 0] >= 0][:int(n)]
        out.append({"labels": valid[:, 0].astype(np.int64),
                    "scores": valid[:, 1],
                    "boxes": valid[:, 2:6]})
    return out
