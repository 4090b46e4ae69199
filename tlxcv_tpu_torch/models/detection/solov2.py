"""SOLOv2, box-free instance segmentation with dynamic mask kernels
(counterpart of ``tlxcv_tpu/models/detection/solov2.py``), NHWC, to
PaddleDetection's ``solov2_r50_fpn_1x``: a ResNet-50 and Mask R-CNN's
P2-P6 ``FPN``; per level a category branch and a kernel branch with
CoordConv, each 4 x (3x3 conv, GroupNorm(32), ReLU), on the level resized
to its grid (40, 36, 24, 16, 12 cells a side); a stride-4 mask feature
fused from P2-P5 (``MaskFeat``).  Every resize is ``jax.image.resize``'s
bilinear (``ops.image.resize_linear``), antialiased when it shrinks.

Eval (``post_process``) returns ``(labels [B, K], scores [B, K], masks [B,
K, H/4, W/4], counts [B])``: the top ``pre_top_k`` cells by class
confidence, their kernels applied to the mask feature as one product,
maskness rescoring, then the mask-IoU matrix NMS (a parallel decay by the
largest IoU with a higher-scored mask of the class).  Training returns the
heads for ``loss_fn``: a dense cell-to-GT map (centre regions of 0.2 the
box, sqrt-area ranges per level, the smallest GT on a contested cell), the
focal category loss, and the dice loss on ``max_pos`` positive cells an
image, picked by a stable top-k.

One kernel of ours sits on this path: the FPN's nearest upsample-add
(``ops.image.upsample_add``, 3 launches a forward).
"""
from __future__ import annotations

import math

import torch
from torch import nn as tnn

from ... import nn
from ...core import init as I
from ...device import resolve_device
from ...ops.image import resize_linear
from ...ops.nms import take_per_image, top_k
from ..classification.resnet import ResNet
from .fcos import _normal_001, ground_truth
from .mask_rcnn import FPN
from .yolox import _one_hot

__all__ = ["SOLOv2", "SOLOv2Head", "MaskFeat", "solov2_r50"]

GRID_NUMS = (40, 36, 24, 16, 12)
SCALE_RANGES = ((1, 96), (48, 192), (96, 384), (192, 768), (384, 2048))
STRIDES = (8, 8, 16, 32, 32)


def _gn_conv(c_in, c_out, device=None, generator=None):
    return (nn.Conv2d(c_in, c_out, 3, padding=1, bias=False, device=device,
                      generator=generator),
            nn.GroupNorm(32, c_out, device=device))


def _coord(x):
    """CoordConv: x with two channels of x and y in [-1, 1] appended."""
    n, h, w, _ = x.shape
    gx = torch.arange(w, dtype=x.dtype, device=x.device) / max(w - 1, 1) \
        * 2 - 1
    gy = torch.arange(h, dtype=x.dtype, device=x.device) / max(h - 1, 1) \
        * 2 - 1
    return torch.cat([x, gx[None, None, :, None].expand(n, h, w, 1),
                      gy[None, :, None, None].expand(n, h, w, 1)], -1)


def _run(tower, x):
    for i in range(0, len(tower), 2):
        x = nn.relu(tower[i + 1](tower[i](x)))
    return x


class SOLOv2Head(tnn.Module):
    """Per level, on the level resized to its grid: the category tower and
    its 3x3 classifier (at the prior), the kernel tower (CoordConv input)
    and its 3x3 kernel prediction, both at normal(0.01)."""

    def __init__(self, in_ch=256, feat_ch=256, num_classes=80, kernel_ch=128,
                 num_convs=4, prior_prob=0.01, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.cate_convs = tnn.ModuleList()
        self.kernel_convs = tnn.ModuleList()
        for i in range(num_convs):
            self.cate_convs.extend(_gn_conv(in_ch if i == 0 else feat_ch,
                                            feat_ch, **kw))
            self.kernel_convs.extend(_gn_conv(
                (in_ch + 2) if i == 0 else feat_ch, feat_ch, **kw))
        bias = -math.log((1 - prior_prob) / prior_prob)
        self.cate_pred = nn.Conv2d(
            feat_ch, num_classes, 3, padding=1, w_init=_normal_001,
            b_init=lambda s, **k: I.constant(s, bias, **k), **kw)
        self.kernel_pred = nn.Conv2d(feat_ch, kernel_ch, 3, padding=1,
                                     w_init=_normal_001, **kw)
        self.num_classes = num_classes
        self.kernel_ch = kernel_ch

    def forward(self, feats):
        """P2..P6 -> per level (category logits [N, S, S, C], kernels [N, S,
        S, E])."""
        outs = []
        for f, s in zip(feats, GRID_NUMS):
            g = resize_linear(f, (s, s))
            outs.append((self.cate_pred(_run(self.cate_convs, g)),
                         self.kernel_pred(_run(self.kernel_convs,
                                               _coord(g)))))
        return outs


class MaskFeat(tnn.Module):
    """P2-P5 each through a 3x3 conv, GroupNorm(32) and ReLU (P5 with
    CoordConv), resized to P2's size and summed, then a 1x1 conv,
    GroupNorm(32) and ReLU."""

    def __init__(self, in_ch=256, mid=128, out_ch=128, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.convs = tnn.ModuleList([
            nn.Conv2d(in_ch + 2 * (i == 3), mid, 3, padding=1, bias=False,
                      **kw) for i in range(4)])
        self.norms = tnn.ModuleList([nn.GroupNorm(32, mid, device=device)
                                     for _ in range(4)])
        self.out = nn.Conv2d(mid, out_ch, 1, bias=False, **kw)
        self.out_norm = nn.GroupNorm(32, out_ch, device=device)

    def forward(self, feats):
        hw = tuple(feats[0].shape[1:3])
        acc = 0.0
        for i, (conv, norm, f) in enumerate(zip(self.convs, self.norms,
                                                feats[:4])):
            x = nn.relu(norm(conv(_coord(f) if i == 3 else f)))
            acc = acc + resize_linear(x, hw)
        return nn.relu(self.out_norm(self.out(acc)))


class SOLOv2(tnn.Module):
    def __init__(self, num_classes=80, backbone=None, kernel_ch=128,
                 score_threshold=0.1, mask_threshold=0.5, pre_top_k=256,
                 keep_top_k=100, max_pos=64, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.backbone = backbone if backbone is not None else ResNet(
            depth=50, num_classes=0, with_pool=False, **kw)
        self.fpn = FPN(self.backbone.feat_channels, 256, **kw)
        self.head = SOLOv2Head(256, 256, num_classes, kernel_ch, **kw)
        self.mask_feat = MaskFeat(256, 128, kernel_ch, **kw)
        self.num_classes = num_classes
        self.kernel_ch = kernel_ch
        self.score_threshold = score_threshold
        self.mask_threshold = mask_threshold
        self.pre_top_k = pre_top_k
        self.keep_top_k = keep_top_k
        self.max_pos = max_pos

    def head_outputs(self, images):
        """(per-level head outputs, the mask feature [N, H/4, W/4, E])."""
        feats = self.fpn(self.backbone.features(images))
        return self.head(feats), self.mask_feat(feats)

    def forward(self, images):
        outs, mfeat = self.head_outputs(images)
        if self.training:
            return {"outs": outs, "mask_feat": mfeat,
                    "image_hw": tuple(images.shape[1:3])}
        return self.post_process(outs, mfeat)

    def _flatten(self, outs):
        """Category logits [N, Q, C] and kernels [N, Q, E] over every
        level's cells, f32."""
        n = outs[0][0].shape[0]
        return (torch.cat([o[0].reshape(n, -1, self.num_classes)
                           for o in outs], 1).float(),
                torch.cat([o[1].reshape(n, -1, self.kernel_ch)
                           for o in outs], 1).float())

    @staticmethod
    def _masks(feat, kers):
        """Dynamic conv as one product: feat [N, h, w, E], kernels [N, K,
        E] -> mask logits [N, K, h, w]."""
        n, h, w, e = feat.shape
        return (kers @ feat.reshape(n, -1, e).transpose(1, 2)).reshape(
            n, -1, h, w)

    def post_process(self, outs, mfeat):
        cate, kern = self._flatten(outs)
        conf, cls = torch.sigmoid(cate).max(-1)
        k = min(self.pre_top_k, conf.shape[1])
        top_c, idx = top_k(conf, k)
        masks = torch.sigmoid(self._masks(mfeat.float(),
                                          take_per_image(kern, idx)))
        binm = (masks > self.mask_threshold).float()
        area = binm.sum((2, 3))
        maskness = torch.where(area > 0, (masks * binm).sum((2, 3))
                               / area.clamp_min(1.0), 0.0)
        scores = top_c * maskness
        scores = torch.where(scores >= self.score_threshold, scores, 0.0)
        # mask-IoU matrix NMS: decay by the largest IoU with a higher-scored
        # mask of the same class
        flat = binm.reshape(*binm.shape[:2], -1)
        inter = flat @ flat.transpose(1, 2)
        iou = inter / (area[:, :, None] + area[:, None, :]
                       - inter).clamp_min(1.0)
        c = cls.gather(1, idx)
        same = c[:, :, None] == c[:, None, :]
        higher = scores[:, :, None] < scores[:, None, :]
        decay = 1.0 - torch.where(same & higher, iou, 0.0).amax(2)
        fs, fi = top_k(scores * decay, min(self.keep_top_k, k))
        valid = fs > 0
        return (torch.where(valid, c.gather(1, fi), -1), fs,
                torch.where(valid[..., None, None],
                            take_per_image(masks, fi), 0.0),
                valid.sum(-1))

    def _assign(self, gt_boxes, gt_labels, gt_valid, image_hw):
        """One image's dense cell-to-GT map: the assigned GT [Q] (-1 for
        none) and the category targets [Q, C], level by level."""
        wh = gt_boxes[:, 2:] - gt_boxes[:, :2]
        scale = torch.sqrt((wh[:, 0] * wh[:, 1]).clamp_min(1e-6))
        cx = (gt_boxes[:, 0] + gt_boxes[:, 2]) * 0.5
        cy = (gt_boxes[:, 1] + gt_boxes[:, 3]) * 0.5
        hw_half = wh * 0.5 * 0.2                       # the centre region
        h_img, w_img = image_hw
        assigned, cates = [], []
        for s, (lo, hi) in zip(GRID_NUMS, SCALE_RANGES):
            in_lvl = (scale >= lo) & (scale <= hi) & (gt_valid > 0)
            cells = torch.arange(s, dtype=torch.float32,
                                 device=gt_boxes.device) + 0.5
            inx = ((cells / s * w_img)[:, None] - cx[None]).abs() <= \
                hw_half[:, 0].clamp_min(w_img / s)[None]        # [S, M]
            iny = ((cells / s * h_img)[:, None] - cy[None]).abs() <= \
                hw_half[:, 1].clamp_min(h_img / s)[None]
            cell = iny[:, None, :] & inx[None, :, :] & in_lvl[None, None, :]
            key = torch.where(cell, scale, torch.inf)   # smallest GT wins
            best = key.argmin(-1)
            pos = torch.isfinite(key.amin(-1))
            assigned.append(torch.where(pos, best, -1).reshape(-1))
            cates.append(torch.where(pos[..., None], _one_hot(
                gt_labels[best], self.num_classes), 0.0).reshape(s * s, -1))
        return torch.cat(assigned), torch.cat(cates, 0)

    def loss_fn(self, outputs, targets):
        parts = self.loss_parts(outputs, targets)
        return parts["cate"] + 3.0 * parts["dice"]

    def loss_parts(self, outputs, targets):
        """targets: ``boxes`` [B, M, 4] xyxy pixels, ``class_labels`` [B,
        M], ``masks`` [B, M, H, W] binary, optional ``mask`` [B, M]."""
        gt_boxes, gt_labels, gt_valid = ground_truth(targets)
        mfeat = outputs["mask_feat"].float()
        h4, w4 = mfeat.shape[1:3]
        cate_pred, kern_pred = self._flatten(outputs["outs"])
        with torch.no_grad():
            assigned, cate_t = (torch.stack(t) for t in zip(*(
                self._assign(bx, lb, vd, outputs["image_hw"])
                for bx, lb, vd in zip(gt_boxes, gt_labels, gt_valid))))
        prob = torch.sigmoid(cate_pred)
        pos_t = cate_t > 0
        pt = torch.where(pos_t, prob, 1 - prob)
        alpha = torch.where(pos_t, 0.25, 0.75)
        focal = -alpha * (1 - pt) ** 2 * torch.log(pt.clamp(1e-6, 1.0))
        cate_loss = focal.sum() / (assigned >= 0).sum().clamp_min(1.0)

        # dice on a fixed budget of positive cells an image
        with torch.no_grad():
            small = resize_linear(targets["masks"].float(), (h4, w4),
                                  axes=(2, 3))
            slots = top_k((assigned >= 0).float(), self.max_pos)[1]
            sel_gt = assigned.gather(1, slots)
            sel_valid = sel_gt >= 0
            tgt = (take_per_image(small, sel_gt.clamp_min(0)) > 0.5).float()
        pred = torch.sigmoid(self._masks(mfeat,
                                         take_per_image(kern_pred, slots)))
        inter = (pred * tgt).sum((2, 3))
        dice = 1.0 - (2 * inter + 1.0) / (
            (pred ** 2).sum((2, 3)) + (tgt ** 2).sum((2, 3)) + 1.0)
        dice_loss = torch.where(sel_valid, dice, 0.0).sum() \
            / sel_valid.sum().float().clamp_min(1.0)
        return {"cate": cate_loss, "dice": dice_loss}


def solov2_r50(num_classes=80, **kwargs):
    return SOLOv2(num_classes=num_classes, **kwargs)
