"""Mask R-CNN, serving (counterpart of
``tlxcv_tpu/models/detection/mask_rcnn.py``): ResNet + FPN, RPN with a
static top-K proposal set, RoIAlign, box head, greedy class-aware NMS, mask
head.  NHWC images, the JAX model's attribute names (``fpn.lateral.0``,
``mask_head.convs.3``, ``mask_head.deconv``), so the bridge needs no name
table.

Static shapes throughout, as in the reference: ``num_proposals`` proposals
per image with a validity mask, ``detections_per_image`` detections padded
with label -1 plus a count.  The whole batch runs at once, with no read
back to the host on the way.  Two kernels of the port sit on this path: the
FPN's nearest upsample-add (``ops.image.upsample_add``, 3 launches per
forward) and RoIAlign's row gather (``ops.roi_align``, 2 launches: box and
mask branch).

Training (``loss_fn``) comes with the training slice; in training mode the
model returns the reference's dict of RPN outputs and proposals.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn as tnn

from ... import nn
from ...core import init as I
from ...device import resolve_device
from ...ops.boxes import clip_boxes, delta2bbox, pairwise_iou
from ...ops.image import upsample_add
from ...ops.nms import matrix_nms, multiclass_nms, nms, take_per_image, top_k
from ...ops.roi_align import multilevel_roi_align, paste_masks
from ..classification.resnet import ResNet

__all__ = ["MaskRCNN", "FPN", "RPNHead", "TwoFCHead", "MaskHead"]


def _normal(std):
    return lambda s, **kw: I.normal(s, std=std, **kw)


class FPN(tnn.Module):
    """Top-down FPN over C2..C5 -> P2..P5, plus P6 by a stride-2 pool."""

    def __init__(self, in_channels, out_ch=256, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.lateral = tnn.ModuleList(
            [nn.Conv2d(c, out_ch, 1, **kw) for c in in_channels])
        self.output = tnn.ModuleList(
            [nn.Conv2d(out_ch, out_ch, 3, padding=1, **kw)
             for _ in in_channels])
        self.out_ch = out_ch
        self.p6 = nn.MaxPool2d(1, 2)

    def forward(self, feats):
        lats = [lat(f) for lat, f in zip(self.lateral, feats)]
        outs = [lats[-1]]
        for i in range(len(lats) - 2, -1, -1):
            outs.insert(0, upsample_add(outs[0], lats[i], mode="nearest"))
        ps = [conv(o) for conv, o in zip(self.output, outs)]
        return ps + [self.p6(ps[-1])]  # P2, P3, P4, P5, P6


class RPNHead(tnn.Module):
    """torchvision's RPNHead: normal(0.01) on every conv."""

    def __init__(self, in_ch=256, num_anchors=3, device=None, generator=None):
        super().__init__()
        kw = dict(w_init=_normal(0.01), device=device, generator=generator)
        self.conv = nn.Conv2d(in_ch, in_ch, 3, padding=1, **kw)
        self.objectness = nn.Conv2d(in_ch, num_anchors, 1, **kw)
        self.deltas = nn.Conv2d(in_ch, num_anchors * 4, 1, **kw)

    def forward(self, feats):
        logits, deltas = [], []
        for f in feats:
            t = nn.relu(self.conv(f))
            b = f.shape[0]
            logits.append(self.objectness(t).reshape(b, -1))
            deltas.append(self.deltas(t).reshape(b, -1, 4))
        return torch.cat(logits, 1), torch.cat(deltas, 1)


def _rpn_anchors(feat_hws, strides=(4, 8, 16, 32, 64),
                 sizes=(32, 64, 128, 256, 512), ratios=(0.5, 1.0, 2.0)):
    """Anchors [A, 4] xyxy (numpy f32), level by level, row-major over each
    level's (h, w) grid, three ratios per position."""
    out = []
    for (h, w), s, size in zip(feat_hws, strides, sizes):
        ws = np.asarray([size * math.sqrt(r) for r in ratios], np.float32)
        hs = np.asarray([size / math.sqrt(r) for r in ratios], np.float32)
        cx = (np.arange(w, dtype=np.float32) + 0.5) * s
        cy = (np.arange(h, dtype=np.float32) + 0.5) * s
        cxg, cyg = np.meshgrid(cx, cy)
        centers = np.stack([cxg, cyg], -1).reshape(-1, 1, 2)
        wh = np.stack([ws, hs], -1)[None]
        boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1)
        out.append(boxes.reshape(-1, 4))
    return np.concatenate(out)


class TwoFCHead(tnn.Module):
    def __init__(self, in_dim, hidden=1024, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.fc1 = nn.Linear(in_dim, hidden, **kw)
        self.fc2 = nn.Linear(hidden, hidden, **kw)

    def forward(self, x):
        x = x.reshape(x.shape[0], x.shape[1], -1)
        return nn.relu(self.fc2(nn.relu(self.fc1(x))))


class MaskHead(tnn.Module):
    def __init__(self, in_ch=256, num_classes=80, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.convs = tnn.ModuleList(
            [nn.Conv2d(in_ch, in_ch, 3, padding=1, **kw) for _ in range(4)])
        self.deconv = nn.ConvTranspose2d(in_ch, in_ch, 2, stride=2, **kw)
        # few output channels: normal(0.001) keeps the sigmoids unsaturated
        self.pred = nn.Conv2d(in_ch, num_classes, 1, w_init=_normal(0.001),
                              **kw)

    def forward(self, x):
        """x [N, R, S, S, C] -> [N, R, 2S, 2S, num_classes]."""
        n, r = x.shape[:2]
        x = x.reshape(n * r, *x.shape[2:])
        for conv in self.convs:
            x = nn.relu(conv(x))
        x = nn.relu(self.deconv(x))
        x = self.pred(x)
        return x.reshape(n, r, *x.shape[1:])


class MaskRCNN(tnn.Module):
    def __init__(self, num_classes=80, num_proposals=256, pre_nms_top_k=512,
                 rpn_nms_thresh=0.7, box_score_thresh=0.05,
                 box_nms_thresh=0.5, detections_per_image=100,
                 mask_resolution=14, backbone=None, rpn_matrix_nms=False,
                 box_matrix_nms=False, with_mask=True,
                 mask_sampling_ratio=1, box_sampling_ratio=1, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.rpn_matrix_nms = rpn_matrix_nms
        self.box_matrix_nms = box_matrix_nms
        self.backbone = backbone if backbone is not None else ResNet(
            depth=50, num_classes=0, with_pool=False, **kw)
        self.fpn = FPN(self.backbone.feat_channels, 256, **kw)
        self.rpn_head = RPNHead(256, 3, **kw)
        self.box_roi_size = 7
        self.box_head = TwoFCHead(256 * 7 * 7, 1024, **kw)
        self.cls_score = nn.Linear(1024, num_classes + 1, **kw)
        self.bbox_pred = nn.Linear(1024, 4, **kw)  # class-agnostic
        self.with_mask = with_mask
        self.mask_head = MaskHead(256, num_classes, **kw) if with_mask \
            else None
        self.num_classes = num_classes
        self.num_proposals = num_proposals
        self.pre_nms_top_k = pre_nms_top_k
        self.rpn_nms_thresh = rpn_nms_thresh
        self.box_score_thresh = box_score_thresh
        self.box_nms_thresh = box_nms_thresh
        self.detections_per_image = detections_per_image
        self.mask_resolution = mask_resolution
        # one sample per bin in both branches, as the reference serves;
        # sampling_ratio=2 restores torchvision's default
        self.mask_sampling_ratio = mask_sampling_ratio
        self.box_sampling_ratio = box_sampling_ratio
        self._anchor_cache = {}

    # ------------------------------------------------------------------
    def _anchors(self, feat_hws, device):
        """[A, 4] anchors on ``device``, made once per pyramid shape."""
        key = (tuple(feat_hws), device)
        if key not in self._anchor_cache:
            self._anchor_cache[key] = torch.from_numpy(
                _rpn_anchors(feat_hws)).to(device)
        return self._anchor_cache[key]

    def _proposals(self, logits, deltas, anchors, image_hw):
        """Per image: the top ``pre_nms_top_k`` anchors by objectness,
        decoded and clipped, then NMS (greedy, or the parallel decay) down
        to ``num_proposals``; invalid slots are zero boxes."""
        k = min(self.pre_nms_top_k, logits.shape[1])
        score, idx = top_k(logits, k)                    # [N, k]
        boxes = delta2bbox(take_per_image(deltas, idx), anchors[idx])
        boxes = clip_boxes(boxes, image_hw)
        if self.rpn_matrix_nms:
            # suppress by the largest IoU with a higher-scored proposal
            iou = pairwise_iou(boxes, boxes)
            higher = score[..., :, None] < score[..., None, :]
            decay = torch.where(higher, iou, 0.0).amax(dim=-1)
            decayed = torch.where(decay > self.rpn_nms_thresh,
                                  float("-inf"), score)
            top_s, keep = top_k(decayed, self.num_proposals)
            mask = top_s > float("-inf")
        else:
            keep, mask = nms(boxes, score, self.rpn_nms_thresh,
                             self.num_proposals)
        props = torch.where(mask[..., None], take_per_image(boxes, keep), 0.0)
        return props, mask

    def forward_features(self, images):
        feats = self.fpn(self.backbone.features(images))
        logits, deltas = self.rpn_head(feats)
        anchors = self._anchors(tuple(tuple(f.shape[1:3]) for f in feats),
                                images.device)
        props, pmask = self._proposals(logits, deltas, anchors,
                                       images.shape[1:3])
        return feats, logits, deltas, anchors, props, pmask

    def box_logits(self, feats, props):
        """Class logits [N, R, C+1] and box deltas [N, R, 4] of proposals
        [N, R, 4] (f32: RoIAlign's output is f32)."""
        pooled = multilevel_roi_align(feats, props, self.box_roi_size,
                                      self.box_sampling_ratio)
        hidden = self.box_head(pooled)
        return self.cls_score(hidden), self.bbox_pred(hidden)

    def mask_logits(self, feats, boxes):
        """Per-class mask logits [N, K, 2S, 2S, C] of boxes [N, K, 4]."""
        return self.mask_head(multilevel_roi_align(
            feats, boxes, self.mask_resolution, self.mask_sampling_ratio))

    def forward(self, images):
        """images [N, H, W, 3].  Eval: ``(dets [N, D, 6], counts [N],
        masks [N, D, 2S, 2S])`` (no masks with ``with_mask=False``).
        Training: the reference's dict of RPN outputs and proposals."""
        feats, rpn_logits, rpn_deltas, anchors, props, pmask = \
            self.forward_features(images)
        if self.training:
            return {"feats": feats, "rpn_logits": rpn_logits,
                    "rpn_deltas": rpn_deltas, "anchors": anchors,
                    "proposals": props, "proposal_mask": pmask,
                    "image_hw": tuple(images.shape[1:3])}
        cls_logits, box_deltas = self.box_logits(feats, props)
        return self._postprocess(feats, props, pmask, cls_logits, box_deltas,
                                 images.shape[1:3])

    def _postprocess(self, feats, props, pmask, cls_logits, box_deltas,
                     image_hw):
        probs = torch.softmax(cls_logits, -1)[..., :-1]  # drop background
        boxes = clip_boxes(delta2bbox(box_deltas, props), image_hw)
        scores = torch.where(pmask[..., None], probs, 0.0)
        if self.box_matrix_nms:
            dets, counts = matrix_nms(
                boxes, scores, score_threshold=self.box_score_thresh,
                keep_top_k=self.detections_per_image,
                pre_top_k=self.num_proposals)
        else:
            dets, counts = multiclass_nms(
                boxes, scores, score_threshold=self.box_score_thresh,
                nms_threshold=self.box_nms_thresh,
                nms_top_k=self.num_proposals,
                keep_top_k=self.detections_per_image)
        if not self.with_mask:
            return dets, counts
        logits = self.mask_logits(feats, dets[..., 2:6])
        labels = dets[..., 0].long().clamp(0, self.num_classes - 1)
        # the reference's one-hot einsum picks exactly this channel
        sel = labels[:, :, None, None, None].expand(*logits.shape[:4], 1)
        masks = torch.sigmoid(logits.gather(-1, sel)[..., 0])
        return dets, counts, masks

    def paste(self, masks, dets, counts, image_hw):
        """Paste each detection's mask [N, D, M, M] into its box at image
        size -> [N, D, H, W]."""
        n, d = masks.shape[:2]
        pasted = paste_masks(masks.reshape(n * d, *masks.shape[2:]),
                             dets[..., 2:6].reshape(n * d, 4), image_hw)
        return pasted.reshape(n, d, *pasted.shape[1:])

    def loss_fn(self, outputs, targets):
        raise NotImplementedError(
            "Mask R-CNN's loss_fn is not ported yet: it comes with the "
            "training slice (ROADMAP queue 1, item 5)")
