"""PP-YOLOE, the serving half (counterpart of
``tlxcv_tpu/models/detection/ppyoloe.py``): the CSPResNet backbone, the
CustomCSPPAN neck (SPP max pools 5/9/13, a nearest 2x route concatenated
on channels), the ESE-attention head with its distribution (DFL) box
decode, and the class-aware ``multiclass_nms``.  NHWC images, the JAX
model's attribute names, static output shapes: ``keep_top_k`` detection
rows per image padded with label -1, and a count.

No hand-written kernel sits on this path: the convolutions are cuDNN's.
The anchor points are built in numpy once per feature size and device and
kept on the device.  Training: ``PPYOLOEHead.get_loss``, the varifocal,
GIoU and DFL losses on the targets of the ATSS assigner before
``static_assigner_epoch`` and of the task-aligned assigner from it on
(``atss_assign``, ``task_aligned_assign``), whose inputs are detached.
Their top-k takes equal metrics in index order, as ``jax.lax.top_k``:
a stable descending sort, whose order ``torch.topk`` does not promise.

The prediction convs are zero-initialised with constant biases, as in the
reference: a freshly built model scores every anchor at sigmoid(-4.595) =
0.01 and predicts one box.  A check of random weights draws them anew.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn as tnn

from ... import nn
from ...core import init as I
from ...device import resolve_device
from ...ops.boxes import aligned_iou, batch_distance2bbox, pairwise_iou
from ...ops.image import interpolate
from ...ops.nms import multiclass_nms

__all__ = ["PPYOLOE", "ppyoloe", "CSPResNet", "CustomCSPPAN", "PPYOLOEHead",
           "atss_assign", "check_points_inside", "task_aligned_assign"]


# ------------------------------------------------------------------ blocks
class ConvBNLayer(tnn.Module):
    def __init__(self, ch_in, ch_out, k=3, stride=1, groups=1, padding=0,
                 act="swish", device=None, generator=None):
        super().__init__()
        self.conv = nn.Conv2d(ch_in, ch_out, k, stride=stride, padding=padding,
                              groups=groups, bias=False, device=device,
                              generator=generator)
        self.bn = nn.BatchNorm(ch_out, device=device)
        self.act = nn.get_activation(act)

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class RepVggBlock(tnn.Module):
    def __init__(self, ch_in, ch_out, act="relu", device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv1 = ConvBNLayer(ch_in, ch_out, 3, padding=1, act=None, **kw)
        self.conv2 = ConvBNLayer(ch_in, ch_out, 1, padding=0, act=None, **kw)
        self.act = nn.get_activation(act)

    def forward(self, x):
        return self.act(self.conv1(x) + self.conv2(x))


class BasicBlock(tnn.Module):
    def __init__(self, ch_in, ch_out, act="relu", shortcut=True, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv1 = ConvBNLayer(ch_in, ch_out, 3, padding=1, act=act, **kw)
        self.conv2 = RepVggBlock(ch_out, ch_out, act=act, **kw)
        self.shortcut = shortcut

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return x + y if self.shortcut else y


class EffectiveSELayer(tnn.Module):
    def __init__(self, channels, device=None, generator=None):
        super().__init__()
        self.fc = nn.Conv2d(channels, channels, 1, device=device,
                            generator=generator)

    def forward(self, x):
        se = x.mean((1, 2), keepdim=True)
        return x * F.hardsigmoid(self.fc(se))


class CSPResStage(tnn.Module):
    def __init__(self, ch_in, ch_out, n, stride, act="relu", attn=True,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        ch_mid = (ch_in + ch_out) // 2
        self.conv_down = (ConvBNLayer(ch_in, ch_mid, 3, 2, padding=1, act=act,
                                      **kw)
                          if stride == 2 else None)
        self.conv1 = ConvBNLayer(ch_mid, ch_mid // 2, 1, act=act, **kw)
        self.conv2 = ConvBNLayer(ch_mid, ch_mid // 2, 1, act=act, **kw)
        self.blocks = nn.Sequential(*[
            BasicBlock(ch_mid // 2, ch_mid // 2, act=act, **kw)
            for _ in range(n)])
        self.attn = EffectiveSELayer(ch_mid, **kw) if attn else None
        self.conv3 = ConvBNLayer(ch_mid, ch_out, 1, act=act, **kw)

    def forward(self, x):
        if self.conv_down is not None:
            x = self.conv_down(x)
        y = torch.cat([self.conv1(x), self.blocks(self.conv2(x))], -1)
        if self.attn is not None:
            y = self.attn(y)
        return self.conv3(y)


class CSPResNet(tnn.Module):
    def __init__(self, layers=(3, 6, 6, 3),
                 channels=(64, 128, 256, 512, 1024), act="swish",
                 return_idx=(1, 2, 3), use_large_stem=True, width_mult=1.0,
                 depth_mult=1.0, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        channels = [max(round(c * width_mult), 1) for c in channels]
        layers = [max(round(n * depth_mult), 1) for n in layers]
        c0 = channels[0]
        stem = [ConvBNLayer(3, c0 // 2, 3, 2, padding=1, act=act, **kw)]
        if use_large_stem:
            stem.append(ConvBNLayer(c0 // 2, c0 // 2, 3, 1, padding=1,
                                    act=act, **kw))
        stem.append(ConvBNLayer(c0 // 2, c0, 3, 1, padding=1, act=act, **kw))
        self.stem = nn.Sequential(*stem)
        self.stages = tnn.ModuleList([
            CSPResStage(channels[i], channels[i + 1], layers[i], 2, act=act,
                        **kw)
            for i in range(len(channels) - 1)])
        self.return_idx = tuple(return_idx)
        self.out_channels = [channels[i + 1] for i in self.return_idx]

    def forward(self, x):
        x = self.stem(x)
        outs = []
        for i, st in enumerate(self.stages):
            x = st(x)
            if i in self.return_idx:
                outs.append(x)
        return outs


class SPP(tnn.Module):
    def __init__(self, ch_in, ch_out, k, pool_sizes=(5, 9, 13), act="swish",
                 device=None, generator=None):
        super().__init__()
        self.pools = tnn.ModuleList([nn.MaxPool2d(ps, 1, ps // 2)
                                     for ps in pool_sizes])
        self.conv = ConvBNLayer(ch_in, ch_out, k, padding=k // 2, act=act,
                                device=device, generator=generator)

    def forward(self, x):
        outs = [x] + [p(x) for p in self.pools]
        return self.conv(torch.cat(outs, -1))


class CSPStage(tnn.Module):
    def __init__(self, ch_in, ch_out, n, act="swish", spp=False, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        ch_mid = int(ch_out // 2)
        self.conv1 = ConvBNLayer(ch_in, ch_mid, 1, act=act, **kw)
        self.conv2 = ConvBNLayer(ch_in, ch_mid, 1, act=act, **kw)
        convs = []
        next_ch = ch_mid
        for i in range(n):
            convs.append(BasicBlock(next_ch, ch_mid, act=act, shortcut=False,
                                    **kw))
            if i == (n - 1) // 2 and spp:
                convs.append(SPP(ch_mid * 4, ch_mid, 1, act=act, **kw))
            next_ch = ch_mid
        self.convs = tnn.ModuleList(convs)
        self.conv3 = ConvBNLayer(ch_mid * 2, ch_out, 1, act=act, **kw)

    def forward(self, x):
        y1 = self.conv1(x)
        y2 = self.conv2(x)
        for c in self.convs:
            y2 = c(y2)
        return self.conv3(torch.cat([y1, y2], -1))


class CustomCSPPAN(tnn.Module):
    """PAN neck, deepest-first outputs.  The top-down route is upsampled 2x
    nearest (``jax.image.resize`` "nearest": output pixel i reads input
    i // 2) and put before the lateral feature on the channel axis."""

    def __init__(self, in_channels=(256, 512, 1024),
                 out_channels=(768, 384, 192), act="swish", stage_num=1,
                 block_num=3, spp=True, width_mult=1.0, depth_mult=1.0,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        out_channels = [max(round(c * width_mult), 1) for c in out_channels]
        block_num = max(round(block_num * depth_mult), 1)
        in_channels = list(in_channels[::-1])  # deepest first
        self.fpn_stages = tnn.ModuleList()
        self.fpn_routes = tnn.ModuleList()
        ch_pre = 0
        fpn_out = []
        for i, ch_in in enumerate(in_channels):
            if i > 0:
                ch_in += ch_pre // 2
            self.fpn_stages.append(nn.Sequential(
                CSPStage(ch_in, out_channels[i], block_num, act=act,
                         spp=(spp and i == 0), **kw)))
            if i < len(in_channels) - 1:
                self.fpn_routes.append(ConvBNLayer(
                    out_channels[i], out_channels[i] // 2, 1, act=act, **kw))
            ch_pre = out_channels[i]
            fpn_out.append(out_channels[i])

        pan_out = [fpn_out[-1]]
        self.pan_stages = tnn.ModuleList()
        self.pan_routes = tnn.ModuleList()
        for i in reversed(range(len(in_channels) - 1)):
            self.pan_routes.append(ConvBNLayer(
                pan_out[-1], pan_out[-1], 3, 2, padding=1, act=act, **kw))
            ch_in = pan_out[-1] + fpn_out[i]
            self.pan_stages.append(CSPStage(ch_in, fpn_out[i], block_num,
                                            act=act, **kw))
            pan_out.append(fpn_out[i])
        self.out_channels = pan_out[::-1]  # deepest first

    def forward(self, feats):
        feats = feats[::-1]
        fpn_feats = []
        route = None
        for i, feat in enumerate(feats):
            if i > 0:
                feat = torch.cat([route, feat], -1)
            feat = self.fpn_stages[i](feat)
            fpn_feats.append(feat)
            if i < len(feats) - 1:
                route = self.fpn_routes[i](feat)
                h, w = route.shape[1:3]
                route = interpolate(route, size=(2 * h, 2 * w),
                                    mode="nearest")
        pan_feats = [fpn_feats[-1]]
        route = fpn_feats[-1]
        for i in reversed(range(len(feats) - 1)):
            j = len(feats) - 2 - i
            down = self.pan_routes[j](route)
            route = self.pan_stages[j](torch.cat([down, fpn_feats[i]], -1))
            pan_feats.append(route)
        return pan_feats[::-1]


# ------------------------------------------------------------- assignment
def check_points_inside(points, bboxes, eps=1e-9):
    """points [A, 2], bboxes [B, M, 4] -> [B, M, A] f32, 1 where the point
    lies strictly inside the box."""
    x, y = points[:, 0], points[:, 1]
    l = x[None, None, :] - bboxes[..., 0:1]
    t = y[None, None, :] - bboxes[..., 1:2]
    r = bboxes[..., 2:3] - x[None, None, :]
    b = bboxes[..., 3:4] - y[None, None, :]
    return (torch.minimum(torch.minimum(l, t), torch.minimum(r, b)) > eps
            ).float()


def _resolve_conflicts(mask_positive, ious):
    """An anchor matched to more than one GT keeps only the GT of the
    largest IoU: the conflicted column is replaced outright by the IoU
    argmax's one-hot, as in the reference."""
    matched = mask_positive.sum(-2, keepdim=True)  # [B, 1, A]
    max_iou_gt = F.one_hot(ious.argmax(-2), ious.shape[-2]).transpose(
        -1, -2).to(ious.dtype)
    return torch.where(matched > 1, max_iou_gt, mask_positive)


def _gather_assignments(mask_positive, gt_labels, gt_bboxes, bg_index):
    """Label [B, A] (``bg_index`` where no GT), box [B, A, 4] and the
    positive mask [B, A] of each anchor's GT."""
    b, m, a = mask_positive.shape
    assigned_gt = mask_positive.argmax(-2)                 # [B, A]
    has_pos = mask_positive.sum(-2) > 0
    labels = torch.gather(gt_labels, 1, assigned_gt)
    labels = torch.where(has_pos, labels, torch.full_like(labels, bg_index))
    bboxes = torch.gather(gt_bboxes, 1,
                          assigned_gt[..., None].expand(b, a, 4))
    return labels, bboxes, has_pos


def atss_assign(anchors, num_anchors_list, gt_labels, gt_bboxes, pad_gt_mask,
                bg_index, num_classes, pred_bboxes=None, topk=9, eps=1e-9):
    """ATSS (the reference's ``ATSSAssigner``): per level the top-k
    anchors by centre distance (every anchor as close as the k-th), the
    IoU threshold mean + std of the candidates.  anchors [A, 4] xyxy;
    gt_labels [B, M]; gt_bboxes [B, M, 4]; pad_gt_mask [B, M, A].
    Returns labels [B, A], boxes [B, A, 4], scores [B, A, C]."""
    b, m = gt_labels.shape[:2]
    a = anchors.shape[0]
    centers = (anchors[:, :2] + anchors[:, 2:]) * 0.5
    ious = pairwise_iou(gt_bboxes, anchors.expand(b, a, 4))
    gt_centers = (gt_bboxes[..., :2] + gt_bboxes[..., 2:]) * 0.5
    dist = ((gt_centers[:, :, None, :] - centers[None, None]) ** 2
            ).sum(-1).sqrt()                                # [B, M, A]
    is_topk = torch.zeros_like(dist)
    start = 0
    for na in num_anchors_list:
        d = dist[..., start:start + na]
        k = min(topk, na)
        thresh = d.sort(-1).values[..., k - 1:k]  # the k-th smallest
        is_topk[..., start:start + na] = (d <= thresh).float()
        start += na
    candidate_ious = torch.where(is_topk > 0, ious, 0.0)
    n_cand = is_topk.sum(-1, keepdim=True).clamp_min(1)
    iou_mean = candidate_ious.sum(-1, keepdim=True) / n_cand
    iou_var = (torch.where(is_topk > 0, (candidate_ious - iou_mean) ** 2,
                           0.0).sum(-1, keepdim=True) / n_cand)
    iou_thresh = iou_mean + torch.sqrt(iou_var + eps)
    inside = check_points_inside(centers, gt_bboxes)
    mask_positive = ((ious >= iou_thresh).float() * is_topk * inside
                     * pad_gt_mask)
    mask_positive = _resolve_conflicts(mask_positive, ious)
    labels, bboxes, _ = _gather_assignments(mask_positive, gt_labels,
                                            gt_bboxes, bg_index)
    scores = F.one_hot(labels, num_classes + 1)[..., :num_classes].float()
    if pred_bboxes is not None:
        pred_iou = pairwise_iou(gt_bboxes, pred_bboxes)    # [B, M, A]
        scores = scores * (pred_iou * mask_positive).amax(-2)[..., None]
    return labels, bboxes, scores


def task_aligned_assign(pred_scores, pred_bboxes, anchor_points, gt_labels,
                        gt_bboxes, pad_gt_mask, bg_index, num_classes,
                        topk=13, alpha=1.0, beta=6.0, eps=1e-9):
    """Task-aligned assignment (the reference's ``TaskAlignedAssigner``):
    the metric score^alpha * IoU^beta of the anchors inside each GT, its
    top-k anchors (every real GT keeps k, whatever their metric; equal
    metrics in index order), scores normalised per GT."""
    b, m = gt_labels.shape[:2]
    a = pred_scores.shape[1]
    ious = pairwise_iou(gt_bboxes, pred_bboxes)            # [B, M, A]
    cls_scores = torch.gather(pred_scores.transpose(1, 2), 1,
                              gt_labels[..., None].expand(b, m, a))
    alignment = cls_scores ** alpha * ious ** beta
    inside = check_points_inside(anchor_points, gt_bboxes)
    metric = alignment * inside
    k = min(topk, a)
    top = metric.sort(dim=-1, descending=True,
                      stable=True).indices[..., :k]
    is_topk = torch.zeros_like(metric).scatter_(-1, top, 1.0)
    mask_positive = is_topk * inside * pad_gt_mask
    mask_positive = _resolve_conflicts(mask_positive, ious)
    labels, bboxes, _ = _gather_assignments(mask_positive, gt_labels,
                                            gt_bboxes, bg_index)
    alignment = alignment * mask_positive
    max_align = alignment.amax(-1, keepdim=True)
    max_iou = (ious * mask_positive).amax(-1, keepdim=True)
    norm_align = (alignment / (max_align + eps) * max_iou).amax(-2)
    scores = F.one_hot(labels, num_classes + 1)[..., :num_classes].float()
    return labels, bboxes, scores * norm_align[..., None]


# ------------------------------------------------------------------- head
class ESEAttn(tnn.Module):
    def __init__(self, feat_channels, act="swish", device=None,
                 generator=None):
        super().__init__()
        self.fc = nn.Conv2d(feat_channels, feat_channels, 1,
                            w_init=lambda s, **k: I.normal(s, std=0.001, **k),
                            device=device, generator=generator)
        self.conv = ConvBNLayer(feat_channels, feat_channels, 1, act=act,
                                device=device, generator=generator)

    def forward(self, feat, avg_feat):
        return self.conv(feat * torch.sigmoid(self.fc(avg_feat)))


class PPYOLOEHead(tnn.Module):
    """Per level: the class branch ``sigmoid(pred_cls(stem_cls(f) + f))``
    and the box branch ``pred_reg(stem_reg(f))``, 4 x (reg_max + 1) bins
    of distances to the box sides, in units of the level's stride.
    Training: ``get_loss`` with the ATSS assigner before
    ``static_assigner_epoch`` and the task-aligned one from it on."""

    def __init__(self, in_channels=(1024, 512, 256), num_classes=80,
                 act="swish", fpn_strides=(32, 16, 8), grid_cell_scale=5.0,
                 grid_cell_offset=0.5, reg_max=16, static_assigner_epoch=4,
                 use_varifocal_loss=True, loss_weight=None, nms_cfg=None,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.num_classes = num_classes
        self.fpn_strides = tuple(fpn_strides)
        self.grid_cell_scale = grid_cell_scale
        self.grid_cell_offset = grid_cell_offset
        self.reg_max = reg_max
        self.static_assigner_epoch = static_assigner_epoch
        self.use_varifocal_loss = use_varifocal_loss
        self.loss_weight = dict(loss_weight or
                                {"class": 1.0, "iou": 2.5, "dfl": 0.5})
        self.nms_cfg = nms_cfg or dict(score_threshold=0.01,
                                       nms_threshold=0.6, nms_top_k=1000,
                                       keep_top_k=100)
        bias_cls = float(-math.log((1 - 0.01) / 0.01))
        self.stem_cls = tnn.ModuleList([ESEAttn(c, act=act, **kw)
                                        for c in in_channels])
        self.stem_reg = tnn.ModuleList([ESEAttn(c, act=act, **kw)
                                        for c in in_channels])
        self.pred_cls = tnn.ModuleList([
            nn.Conv2d(c, num_classes, 3, padding=1, w_init=I.zeros,
                      b_init=lambda s, **k: I.constant(s, bias_cls, **k),
                      **kw)
            for c in in_channels])
        self.pred_reg = tnn.ModuleList([
            nn.Conv2d(c, 4 * (reg_max + 1), 3, padding=1, w_init=I.zeros,
                      b_init=I.ones, **kw)
            for c in in_channels])
        self._anchor_cache = {}

    def _anchors(self, feat_hws, device):
        """Grid-cell anchors [A, 4] xyxy, anchor points [A, 2] and strides
        [A, 1] in input pixels, and the anchors per level; built in numpy
        once per feature sizes and device."""
        key = (tuple(feat_hws), device)
        if key in self._anchor_cache:
            return self._anchor_cache[key]
        pts, strs, anchors, counts = [], [], [], []
        for (h, w), s in zip(feat_hws, self.fpn_strides):
            xs = (np.arange(w, dtype=np.float32) + self.grid_cell_offset) * s
            ys = (np.arange(h, dtype=np.float32) + self.grid_cell_offset) * s
            xg, yg = np.meshgrid(xs, ys)
            c = np.stack([xg, yg], -1).reshape(-1, 2).astype(np.float32)
            pts.append(c)
            strs.append(np.full((h * w, 1), s, np.float32))
            half = self.grid_cell_scale * s * 0.5
            anchors.append(np.concatenate([c - half, c + half], -1))
            counts.append(h * w)
        with torch.inference_mode(False):  # usable outside inference too
            out = tuple(torch.from_numpy(np.concatenate(t)).to(device)
                        for t in (anchors, pts, strs)) + (counts,)
        self._anchor_cache[key] = out
        return out

    def forward(self, feats):
        """(class scores [B, A, C] after the sigmoid, distance logits [B, A,
        4 (reg_max + 1)], the levels' (h, w)); levels deepest first."""
        cls_list, reg_list = [], []
        for i, feat in enumerate(feats):
            b = feat.shape[0]
            avg = feat.mean((1, 2), keepdim=True)
            cls_logit = self.pred_cls[i](self.stem_cls[i](feat, avg) + feat)
            reg_dist = self.pred_reg[i](self.stem_reg[i](feat, avg))
            cls_list.append(torch.sigmoid(cls_logit).reshape(
                b, -1, self.num_classes))
            reg_list.append(reg_dist.reshape(b, -1, 4 * (self.reg_max + 1)))
        feat_hws = tuple(tuple(f.shape[1:3]) for f in feats)
        return torch.cat(cls_list, 1), torch.cat(reg_list, 1), feat_hws

    def _bbox_decode(self, anchor_points, pred_dist):
        """The expected distance of each side under the softmax over its
        bins (f32), from the anchor points: xyxy in stride units."""
        b, n, _ = pred_dist.shape
        d = torch.softmax(pred_dist.reshape(b, n, 4, self.reg_max + 1), -1)
        proj = torch.arange(self.reg_max + 1, dtype=torch.float32,
                            device=pred_dist.device)
        return batch_distance2bbox(anchor_points, d.float() @ proj)

    def _df_loss(self, pred_dist, target):
        """Distribution focal loss: cross-entropy of the two bins around
        each target distance, weighted by nearness; the mean over sides."""
        tl = target.floor().long()
        tr = tl + 1
        wl = tr.float() - target
        wr = 1.0 - wl
        logp = torch.log_softmax(pred_dist, -1)
        ll = -torch.gather(logp, -1, tl[..., None])[..., 0] * wl
        lr = -torch.gather(logp, -1, tr[..., None])[..., 0] * wr
        return (ll + lr).mean(-1)

    def get_loss(self, head_outs, targets, epoch_id=0):
        """Targets: ``class_labels`` [B, M], ``boxes`` [B, M, 4] xyxy in
        input pixels, ``pad_gt_mask`` [B, M] (or [B, M, 1]; without it a
        box of no width is padding)."""
        pred_scores, pred_distri, feat_hws = head_outs
        anchors, points, strides, counts = self._anchors(
            feat_hws, pred_distri.device)
        points_s = points / strides
        pred_bboxes = self._bbox_decode(points_s, pred_distri)

        gt_labels = targets["class_labels"].long()
        gt_bboxes = targets["boxes"]
        pad_mask = targets.get("pad_gt_mask")
        if pad_mask is None:
            pad_mask = (gt_bboxes[..., 2] > gt_bboxes[..., 0]).float()
        if pad_mask.ndim == 3:
            pad_mask = pad_mask[..., 0]
        bsz, m = pad_mask.shape
        pm = pad_mask[..., None].expand(bsz, m, pred_scores.shape[1])

        # the assigners' inputs are detached (the reference's graph break):
        # else the varifocal loss shrinks its own targets
        det_scores = pred_scores.detach()
        det_bboxes = pred_bboxes.detach()
        if epoch_id < self.static_assigner_epoch:
            labels, bboxes, scores = atss_assign(
                anchors, counts, gt_labels, gt_bboxes, pm,
                bg_index=self.num_classes, num_classes=self.num_classes,
                pred_bboxes=det_bboxes * strides)
        else:
            labels, bboxes, scores = task_aligned_assign(
                det_scores, det_bboxes * strides, points, gt_labels,
                gt_bboxes, pm, bg_index=self.num_classes,
                num_classes=self.num_classes)
        bboxes = bboxes / strides

        one_hot = F.one_hot(labels, self.num_classes + 1)[..., :-1].float()
        eps = 1e-6  # a clip, not an added eps: log(1 - p) at saturation
        pred_scores = pred_scores.clamp(eps, 1.0 - eps)
        if self.use_varifocal_loss:
            weight = (0.75 * pred_scores ** 2.0 * (1 - one_hot)
                      + scores * one_hot)
        else:
            weight = (pred_scores - scores) ** 2.0
        ce = -(scores * torch.log(pred_scores)
               + (1 - scores) * torch.log(1 - pred_scores))
        scores_sum = scores.sum().clamp_min(1.0)
        loss_cls = (ce * weight).sum() / scores_sum

        pos = (labels != self.num_classes).float()         # [B, A]
        bbox_w = scores.sum(-1) * pos
        giou = 1.0 - aligned_iou(pred_bboxes, bboxes, mode="giou")
        loss_iou = (giou * bbox_w).sum() / scores_sum

        ltrb = torch.cat([points_s - bboxes[..., :2],
                          bboxes[..., 2:] - points_s], -1).clamp(
            0, self.reg_max - 0.01)
        b, a = pos.shape
        pd = pred_distri.reshape(b, a, 4, self.reg_max + 1)
        loss_dfl = (self._df_loss(pd, ltrb) * bbox_w).sum() / scores_sum

        w = self.loss_weight
        return (w["class"] * loss_cls + w["iou"] * loss_iou
                + w["dfl"] * loss_dfl)

    def decode(self, head_outs):
        """Boxes [B, A, 4] in input pixels and the scores [B, A, C]."""
        pred_scores, pred_distri, feat_hws = head_outs
        _, points, strides, _ = self._anchors(feat_hws, pred_distri.device)
        boxes = self._bbox_decode(points / strides, pred_distri) * strides
        return boxes, pred_scores

    def nms(self, boxes, scores):
        return multiclass_nms(boxes, scores, **self.nms_cfg)

    def post_process(self, head_outs, input_hw=None):
        return self.nms(*self.decode(head_outs))


class PPYOLOE(tnn.Module):
    """The detector.  Eval: ``forward`` returns ``(dets [B, keep_top_k, 6],
    counts [B])`` in input pixels; train mode returns the reference's
    ``{"head_outs", "epoch_id"}``."""

    def __init__(self, backbone, neck, head):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.yolo_head = head

    def head_outputs(self, images):
        return self.yolo_head(self.neck(self.backbone(images)))

    def forward(self, images, epoch_id=0):
        outs = self.head_outputs(images)
        if self.training:
            return {"head_outs": outs, "epoch_id": epoch_id}
        return self.yolo_head.post_process(outs)

    def loss_fn(self, outputs, targets):
        return self.yolo_head.get_loss(outputs["head_outs"], targets,
                                       outputs.get("epoch_id", 0))


_MULTS = {"ppyoloe_s": (0.33, 0.50), "ppyoloe_m": (0.67, 0.75),
          "ppyoloe_l": (1.0, 1.0), "ppyoloe_x": (1.33, 1.25)}


def ppyoloe(arch="ppyoloe_l", num_classes=80, device=None, generator=None,
            **kwargs):
    """PP-YOLOE at one of the four published scales (depth, width
    multipliers): ``ppyoloe_s``, ``_m``, ``_l``, ``_x``."""
    if arch not in _MULTS:
        raise ValueError(f"unsupported arch {arch}")
    depth_mult, width_mult = _MULTS[arch]
    kw = dict(device=resolve_device(device), generator=generator)
    backbone = CSPResNet(width_mult=width_mult, depth_mult=depth_mult, **kw)
    neck = CustomCSPPAN(in_channels=backbone.out_channels,
                        width_mult=width_mult, depth_mult=depth_mult, **kw)
    head = PPYOLOEHead(in_channels=neck.out_channels,
                       num_classes=num_classes, **kwargs, **kw)
    return PPYOLOE(backbone, neck, head)
