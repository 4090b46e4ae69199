"""Faster R-CNN and Cascade R-CNN (counterpart of
``tlxcv_tpu/models/detection/cascade_rcnn.py``), NHWC, on the Mask R-CNN
trunk of ``mask_rcnn``: ResNet + FPN, the RPN with a static top-K proposal
set, multilevel RoIAlign.

- ``faster_rcnn`` is ``MaskRCNN(with_mask=False)``: one box head.
- ``CascadeRCNN`` runs three box heads (``TwoFCHead`` and two ``Linear``s
  each) matched at IoU 0.5, 0.6 and 0.7 with tightening delta weights, each
  refining the previous stage's boxes, detached between stages.  Eval
  scores are the stages' mean softmax; the boxes are the last stage's.

Two kernels of the port sit on this path: the FPN's nearest upsample-add
(``ops.image.upsample_add``, 3 launches a forward) and RoIAlign's row
gather (``ops.roi_align``): 1 launch a forward in Faster R-CNN, one a
stage (3) in Cascade R-CNN.
"""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...device import resolve_device
from ...ops.boxes import bbox2delta, clip_boxes, delta2bbox, pairwise_iou
from ...ops.losses import binary_cross_entropy, smooth_l1_loss
from ...ops.nms import multiclass_nms
from ...ops.roi_align import multilevel_roi_align
from .fcos import ground_truth
from .mask_rcnn import MaskRCNN, TwoFCHead, _mark, _take, _wmean

__all__ = ["CascadeRCNN", "cascade_rcnn_r50", "faster_rcnn"]

STAGE_IOUS = (0.5, 0.6, 0.7)
STAGE_WEIGHTS = ((10.0, 10.0, 5.0, 5.0),
                 (20.0, 20.0, 10.0, 10.0),
                 (30.0, 30.0, 15.0, 15.0))
STAGE_LOSS_W = (1.0, 0.5, 0.25)


def faster_rcnn(num_classes=80, **kwargs):
    """Faster R-CNN: the Mask R-CNN trunk without its mask branch."""
    return MaskRCNN(num_classes=num_classes, with_mask=False, **kwargs)


class CascadeRCNN(MaskRCNN):
    """Mask R-CNN's trunk with three cascade box stages in place of its
    box head (``stage_heads``, ``stage_cls``, ``stage_reg``, lists as the
    reference keeps them); RoIAlign at 2 samples a bin, the reference's
    default."""

    def __init__(self, num_classes=80, device=None, generator=None,
                 **kwargs):
        super().__init__(num_classes=num_classes, with_mask=False,
                         device=device, generator=generator, **kwargs)
        kw = dict(device=resolve_device(device), generator=generator)
        self.box_head = self.cls_score = self.bbox_pred = None
        self.stage_heads = tnn.ModuleList([TwoFCHead(256 * 7 * 7, 1024, **kw)
                                           for _ in STAGE_IOUS])
        self.stage_cls = tnn.ModuleList([nn.Linear(1024, num_classes + 1,
                                                   **kw)
                                         for _ in STAGE_IOUS])
        self.stage_reg = tnn.ModuleList([nn.Linear(1024, 4, **kw)
                                         for _ in STAGE_IOUS])

    def _run_cascade(self, feats, props, image_hw):
        """-> per stage (its input boxes, class logits [N, R, C+1], deltas
        [N, R, 4]) and the last stage's refined boxes."""
        boxes, stages = props, []
        for head, cls, reg, w in zip(self.stage_heads, self.stage_cls,
                                     self.stage_reg, STAGE_WEIGHTS):
            hidden = head(multilevel_roi_align(feats, boxes,
                                               self.box_roi_size))
            deltas = reg(hidden)
            stages.append((boxes, cls(hidden), deltas))
            boxes = clip_boxes(delta2bbox(deltas.float(), boxes, weights=w),
                               image_hw).detach()
        return stages, boxes

    def forward(self, images):
        """images [N, H, W, 3].  Eval: ``(dets [N, D, 6], counts [N])``.
        Training: the RPN's outputs, the proposals and every stage."""
        feats, rpn_logits, rpn_deltas, anchors, props, pmask = \
            self.forward_features(images)
        image_hw = tuple(images.shape[1:3])
        stages, final_boxes = self._run_cascade(feats, props, image_hw)
        if self.training:
            return {"feats": feats, "rpn_logits": rpn_logits,
                    "rpn_deltas": rpn_deltas, "anchors": anchors,
                    "proposals": props, "proposal_mask": pmask,
                    "stages": stages, "image_hw": image_hw}
        return self.postprocess(stages, final_boxes, pmask)

    def postprocess(self, stages, final_boxes, pmask):
        """The stages' mean softmax (background dropped) on the last
        stage's boxes, then the class-aware NMS."""
        probs = sum(torch.softmax(cls.float(), -1)
                    for _, cls, _ in stages) / len(stages)
        return multiclass_nms(
            final_boxes, torch.where(pmask[..., None], probs[..., :-1], 0.0),
            score_threshold=self.box_score_thresh,
            nms_threshold=self.box_nms_thresh,
            nms_top_k=self.num_proposals,
            keep_top_k=self.detections_per_image)

    def loss_fn(self, outputs, targets):
        """targets: ``boxes`` [B, M, 4] xyxy pixels, ``class_labels`` [B,
        M], optional ``mask`` [B, M].  The RPN's loss plus, per stage
        weighted 1, 0.5, 0.25, the cross-entropy over the live proposals
        and smooth-L1 over the foreground."""
        gt_boxes, gt_labels, gt_valid = ground_truth(targets)
        valid = gt_valid > 0
        total = self._rpn_loss(outputs, gt_boxes, valid)
        live = outputs["proposal_mask"]
        pmask = live.float()
        b, m = gt_boxes.shape[:2]
        for (boxes_in, cls_logits, deltas), thr, w, lw in zip(
                outputs["stages"], STAGE_IOUS, STAGE_WEIGHTS, STAGE_LOSS_W):
            r = boxes_in.shape[1]
            with torch.no_grad():
                piou = torch.where(valid[..., None],
                                   pairwise_iou(gt_boxes, boxes_in), -1.0)
                best_prop = torch.where(valid, piou.argmax(2), r)   # [B, M]
                fg = ((piou.amax(1) >= thr) | _mark(r, best_prop)) & live
                best_gt = torch.cat([piou.argmax(1),
                                     best_prop.new_zeros(b, 1)], 1)
                best_gt = best_gt.scatter(1, best_prop, torch.arange(
                    m, device=best_gt.device).expand(b, m))[:, :r]
                t_label = torch.where(fg, gt_labels.gather(1, best_gt),
                                      self.num_classes)
                safe = torch.where(
                    (boxes_in[..., 2:] > boxes_in[..., :2]).all(
                        -1, keepdim=True),
                    boxes_in, boxes_in + boxes_in.new_tensor([0, 0, 1, 1]))
                t_delta = bbox2delta(safe, _take(gt_boxes, best_gt),
                                     weights=w)
            ce = -torch.log_softmax(cls_logits, -1).gather(
                -1, t_label[..., None])[..., 0]
            reg = smooth_l1_loss(deltas.float(), t_delta,
                                 reduction="none").sum(-1)
            total = total + lw * (_wmean(ce, pmask) + _wmean(reg, fg.float()))
        return total

    def _rpn_loss(self, outputs, gt_boxes, valid):
        """The reference cascade's RPN loss: BCE over the sampled anchors
        (IoU > 0.7 or a GT's best: positive; < 0.3: negative), smooth-L1
        over the positives."""
        anchors = outputs["anchors"]
        rpn_logits, rpn_deltas = outputs["rpn_logits"], outputs["rpn_deltas"]
        b, a_n = rpn_logits.shape[0], anchors.shape[0]
        with torch.no_grad():
            all_anchors = anchors.expand(b, *anchors.shape)
            iou = torch.where(valid[..., None],
                              pairwise_iou(gt_boxes, all_anchors), -1.0)
            best_iou = iou.amax(1)
            pos = (best_iou > 0.7) | _mark(
                a_n, torch.where(valid, iou.argmax(2), a_n))
            sample = (pos | ((best_iou < 0.3) & ~pos)).float()
            t_delta = bbox2delta(all_anchors, _take(gt_boxes, iou.argmax(1)))
        posf = pos.float()
        rpn_cls = binary_cross_entropy(rpn_logits, posf, reduction="none")
        rpn_reg = smooth_l1_loss(rpn_deltas, t_delta,
                                 reduction="none").sum(-1)
        return _wmean(rpn_cls, sample) + _wmean(rpn_reg, posf)


def cascade_rcnn_r50(num_classes=80, **kwargs):
    return CascadeRCNN(num_classes=num_classes, **kwargs)
