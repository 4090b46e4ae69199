"""SSD-MobileNetV1, the serving half (counterpart of
``tlxcv_tpu/models/detection/ssd.py``): MobileNetV1's conv11 and conv13
features and four extra blocks, 1x1 box and score convs, the prior-box
decode, the softmax without the background class and the class-aware
``multiclass_nms``.  NHWC images, the JAX model's attribute names, static
output shapes: ``keep_top_k`` detection rows per image padded with label
-1, and a count.

No hand-written kernel sits on this path: the convolutions (depthwise ones
included) are cuDNN's.  The priors are built in numpy once per feature
size and device and kept on the device.  Training: ``SSDLoss``, the
reference's prior matching, smooth-L1 box loss and cross-entropy with
hard-negative mining (the negatives ranked by a stable sort, so equal
losses go in prior order on either device, as ``jnp.argsort``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn as tnn

from ... import nn
from ...core import init as I
from ...device import resolve_device
from ...ops.anchors import ssd_prior_box
from ...ops.boxes import bbox2delta, pairwise_iou
from ...ops.nms import multiclass_nms
from ..classification.mobilenetv1 import ConvBNReLU, MobileNetV1

__all__ = ["SSD", "SSDHead", "SSDLoss", "SSDMobileNetBackbone",
           "ExtraBlock", "build_ssd_priors", "ssd_decode"]


class ExtraBlock(tnn.Module):
    def __init__(self, cin, mid, cout, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv1 = ConvBNReLU(cin, mid, 1, **kw)
        self.conv2 = ConvBNReLU(mid, cout, 3, stride=2, padding=1, **kw)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class SSDMobileNetBackbone(tnn.Module):
    """MobileNetV1 features at conv11 (512 channels) and conv13 (1024) and
    four extra blocks (512, 256, 256, 128)."""

    def __init__(self, scale=1.0, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.net = MobileNetV1(num_classes=0, with_pool=False, scale=scale,
                               feature_idx=(10, 12), **kw)
        self.extras = tnn.ModuleList([
            ExtraBlock(1024, 256, 512, **kw), ExtraBlock(512, 128, 256, **kw),
            ExtraBlock(256, 128, 256, **kw), ExtraBlock(256, 64, 128, **kw)])
        self.out_channels = (512, 1024, 512, 256, 256, 128)

    def forward(self, x):
        feats = self.net.features(x)  # [conv11, conv13]
        x = feats[-1]
        for blk in self.extras:
            x = blk(x)
            feats.append(x)
        return feats


class SSDHead(tnn.Module):
    """One box and one score conv per level, normal(0.01) init; scores
    carry a background class last."""

    def __init__(self, num_classes=80,
                 in_channels=(512, 1024, 512, 256, 256, 128),
                 num_priors=(3, 6, 6, 6, 6, 6), kernel_size=1, padding=0,
                 device=None, generator=None):
        super().__init__()
        self.num_classes = num_classes + 1  # + background
        kw = dict(w_init=lambda s, **k: I.normal(s, std=0.01, **k),
                  padding=padding, device=device, generator=generator)
        self.box_convs = tnn.ModuleList([
            nn.Conv2d(c, p * 4, kernel_size, **kw)
            for c, p in zip(in_channels, num_priors)])
        self.score_convs = tnn.ModuleList([
            nn.Conv2d(c, p * self.num_classes, kernel_size, **kw)
            for c, p in zip(in_channels, num_priors)])

    def forward(self, feats):
        boxes, scores = [], []
        for f, bc, sc in zip(feats, self.box_convs, self.score_convs):
            b = f.shape[0]
            boxes.append(bc(f).reshape(b, -1, 4))
            scores.append(sc(f).reshape(b, -1, self.num_classes))
        return torch.cat(boxes, 1), torch.cat(scores, 1)


def build_ssd_priors(feature_hws, image_hw=(300, 300), min_sizes=None,
                     max_sizes=None):
    """The reference SSD-MobileNet prior configuration: [A, 4] normalized
    xyxy, numpy.  Without explicit sizes the 60..300 px ladder, written
    for a 300x300 input, is scaled by ``min(image_hw) / 300``."""
    if min_sizes is None:
        s = min(image_hw) / 300.0
        min_sizes = tuple(v * s for v in
                          (60.0, 105.0, 150.0, 195.0, 240.0, 285.0))
        max_sizes = tuple(v * s if v else None for v in
                          (0.0, 150.0, 195.0, 240.0, 285.0, 300.0))
    elif max_sizes is None:
        max_sizes = (None,) * len(min_sizes)
    aspect_ratios = ((2.0,), (2.0, 3.0), (2.0, 3.0), (2.0, 3.0), (2.0, 3.0),
                     (2.0, 3.0))
    out = []
    for hw, ms, mx, ar in zip(feature_hws, min_sizes, max_sizes,
                              aspect_ratios):
        b, _ = ssd_prior_box(hw, image_hw, [ms], [mx] if mx else None, ar,
                             flip=True, clip=False,
                             min_max_aspect_ratios_order=False)
        out.append(b.reshape(-1, 4))
    return np.concatenate(out, 0)


def ssd_decode(box_preds, priors, variances=(0.1, 0.1, 0.2, 0.2)):
    """Delta decode against the priors [A, 4]: normalized xyxy."""
    pw = priors[:, 2] - priors[:, 0]
    ph = priors[:, 3] - priors[:, 1]
    px = priors[:, 0] + pw * 0.5
    py = priors[:, 1] + ph * 0.5
    ox = px + box_preds[..., 0] * pw * variances[0]
    oy = py + box_preds[..., 1] * ph * variances[1]
    ow = torch.exp(box_preds[..., 2] * variances[2]) * pw
    oh = torch.exp(box_preds[..., 3] * variances[3]) * ph
    return torch.stack([ox - ow / 2, oy - oh / 2, ox + ow / 2, oy + oh / 2],
                       -1)


class SSDLoss:
    """Prior matching, smooth-L1 on the positives' deltas and cross-entropy
    on the positives and the hardest negatives (the reference's
    ``SSDLoss``), vectorized over the batch."""

    def __init__(self, overlap_threshold=0.5, neg_pos_ratio=3.0,
                 loc_loss_weight=1.0, conf_loss_weight=1.0,
                 prior_box_var=(0.1, 0.1, 0.2, 0.2)):
        self.overlap_threshold = overlap_threshold
        self.neg_pos_ratio = neg_pos_ratio
        self.loc_loss_weight = loc_loss_weight
        self.conf_loss_weight = conf_loss_weight
        self.var = prior_box_var

    def __call__(self, boxes, scores, gt_bbox, gt_label, gt_mask, priors):
        """boxes [B, A, 4] deltas; scores [B, A, C + 1] logits; gt_bbox
        [B, N, 4] normalized xyxy; gt_label [B, N]; gt_mask [B, N] (1 =
        real GT); priors [A, 4]."""
        b, a = scores.shape[:2]
        n = gt_bbox.shape[1]
        bg = scores.shape[-1] - 1
        gt_label = gt_label.long()
        ious = pairwise_iou(gt_bbox, priors.expand(b, *priors.shape))
        ious = torch.where(gt_mask[..., None] > 0, ious, -1.0)  # padding
        prior_max = ious.amax(1)                   # [B, A]
        prior_arg = ious.argmax(1)                 # best GT of each prior
        gt_arg = ious.argmax(2)                    # best prior of each GT
        t_bbox = torch.gather(gt_bbox, 1, prior_arg[..., None].expand(b, a, 4))
        t_label = torch.gather(gt_label, 1, prior_arg)
        t_label = torch.where(prior_max < self.overlap_threshold,
                              torch.full_like(t_label, bg), t_label)
        # each real GT's best prior is forced to it; of GTs sharing a best
        # prior the last wins (the reference's scatter on the CPU), and a
        # padded GT writes to one extra prior, sliced off
        safe = torch.where(gt_mask > 0, gt_arg, a)
        winner = torch.full((b, a + 1), -1, dtype=torch.long,
                            device=scores.device).scatter_reduce(
            1, safe, torch.arange(n, device=scores.device).expand(b, n),
            reduce="amax")[:, :a]
        forced = winner >= 0
        w = winner.clamp_min(0)
        t_bbox = torch.where(forced[..., None], torch.gather(
            gt_bbox, 1, w[..., None].expand(b, a, 4)), t_bbox)
        t_label = torch.where(forced, torch.gather(gt_label, 1, w), t_label)

        t_delta = bbox2delta(priors.expand(b, *priors.shape), t_bbox,
                             weights=[1 / v for v in self.var]).detach()
        pos = (t_label != bg).float()
        num_pos = pos.sum(1, keepdim=True)
        loc_loss = torch.where(pos[..., None] > 0,
                               _smooth_l1(boxes, t_delta), 0.0).sum()
        loc_loss = loc_loss * self.loc_loss_weight

        logp = torch.log_softmax(scores, -1)
        conf_loss = -torch.gather(logp, -1, t_label[..., None])[..., 0]
        # hard negatives: the top 3 x num_pos by loss, equal losses in
        # prior order
        neg_loss = torch.where(pos > 0, -float("inf"), conf_loss.detach())
        order = torch.argsort(-neg_loss, dim=1, stable=True)
        rank = torch.argsort(order, dim=1)
        num_neg = torch.clamp_max(num_pos * self.neg_pos_ratio, a)
        num_neg = torch.where(num_pos > 0, num_neg, a * 0.01)
        neg_mask = (rank < num_neg).float()
        conf_loss = (conf_loss * (pos + neg_mask)).sum()
        conf_loss = conf_loss * self.conf_loss_weight
        return (conf_loss + loc_loss) / num_pos.sum().clamp_min(1.0)


def _smooth_l1(pred, target):
    d = (pred - target).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


class SSD(tnn.Module):
    """The detector.  Eval: ``forward`` returns ``(dets [B, keep_top_k, 6],
    counts [B])``, rows [label, score, x1, y1, x2, y2] in input pixels,
    invalid rows [-1, 0, 0, 0, 0, 0].  Train mode returns the reference's
    ``{"boxes", "scores", "priors"}``."""

    def __init__(self, num_classes=80, image_size=(300, 300),
                 score_threshold=0.01, nms_threshold=0.45, nms_top_k=400,
                 keep_top_k=200, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.backbone = SSDMobileNetBackbone(**kw)
        self.ssd_head = SSDHead(num_classes,
                                in_channels=self.backbone.out_channels, **kw)
        self.image_size = tuple(image_size)
        self.nms_cfg = dict(score_threshold=score_threshold,
                            nms_threshold=nms_threshold, nms_top_k=nms_top_k,
                            keep_top_k=keep_top_k)
        self._priors = {}  # (feature sizes, device) -> [A, 4] f32
        self.loss = SSDLoss()

    def priors(self, feature_hws, device):
        """The priors [A, 4] of these feature sizes, on ``device``."""
        key = (tuple(tuple(hw) for hw in feature_hws), torch.device(device))
        if key not in self._priors:
            with torch.inference_mode(False):  # usable outside inference
                self._priors[key] = torch.from_numpy(build_ssd_priors(
                    key[0], self.image_size)).to(device)
        return self._priors[key]

    def head_outputs(self, images):
        """(box deltas [B, A, 4], class logits [B, A, C + 1], priors)."""
        feats = self.backbone(images)
        boxes, scores = self.ssd_head(feats)
        return boxes, scores, self.priors([f.shape[1:3] for f in feats],
                                          images.device)

    def decode(self, boxes, scores, priors, input_hw):
        """Boxes in input pixels [B, A, 4] and the class probabilities
        without the background [B, A, C], before NMS."""
        h, w = input_hw
        decoded = ssd_decode(boxes, priors)
        decoded = decoded * torch.tensor([w, h, w, h], dtype=decoded.dtype,
                                         device=decoded.device)
        return decoded, torch.softmax(scores, -1)[..., :-1]

    def nms(self, boxes, probs):
        return multiclass_nms(boxes, probs, **self.nms_cfg)

    def forward(self, images):
        boxes, scores, priors = self.head_outputs(images)
        if self.training:
            return {"boxes": boxes, "scores": scores, "priors": priors}
        return self.nms(*self.decode(boxes, scores, priors,
                                     images.shape[1:3]))

    def loss_fn(self, outputs, targets):
        """Targets: ``boxes`` [B, N, 4] normalized xyxy, ``class_labels``
        [B, N], ``mask`` [B, N] (without it a box of no width is
        padding)."""
        gt_bbox = targets["boxes"]
        gt_mask = targets.get("mask")
        if gt_mask is None:
            gt_mask = (gt_bbox[..., 2] > gt_bbox[..., 0]).float()
        return self.loss(outputs["boxes"], outputs["scores"], gt_bbox,
                         targets["class_labels"], gt_mask, outputs["priors"])
