"""YOLOv3, the serving half (counterpart of
``tlxcv_tpu/models/detection/yolov3.py``): DarkNet-53, the top-down FPN
(2x nearest upsample, concatenation on channels), the 1x1 prediction head
with its optional IoU-aware channels, ``yolo_box`` decode and the NMS.
NHWC images, the JAX model's attribute names, static output shapes:
``keep_top_k`` detection rows per image padded with label -1, and a count.

No hand-written kernel sits on the float path: the convolutions are
cuDNN's.  In full int8 (``ops.quant.quantize_weights`` then
``calibrate_activations(model, batches, forward=model.head_outputs)``, as
the JAX package's bench builds it) every Conv2d runs im2col and the int8
GEMM, ``ops.cuda.matmul.int8_matmul_requant``: 75 launches per forward.

Training: ``loss_fn`` builds the per-level targets on the device
(``gt2yolo_targets``) and takes ``YOLOv3Loss``; no kernel of ours is on
that path either.
"""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...core import init as I
from ...device import resolve_device
from ...ops.boxes import pairwise_iou
from ...ops.image import interpolate
from ...ops.nms import matrix_nms, multiclass_nms
from ...ops.yolo import yolo_box
from .backbones.darknet import ConvBNLayer, DarkNet

__all__ = ["YOLOv3", "YOLOv3FPN", "YOLOv3Head", "YOLOv3Loss", "YoloDetBlock",
           "gt2yolo_targets", "DEFAULT_ANCHORS", "DEFAULT_MASKS",
           "DOWNSAMPLES"]

DEFAULT_ANCHORS = ((10, 13), (16, 30), (33, 23), (30, 61), (62, 45),
                   (59, 119), (116, 90), (156, 198), (373, 326))
DEFAULT_MASKS = ((6, 7, 8), (3, 4, 5), (0, 1, 2))
DOWNSAMPLES = (32, 16, 8)


class YoloDetBlock(tnn.Module):
    def __init__(self, ch_in, channel, device=None, generator=None):
        super().__init__()
        if channel % 2:
            raise ValueError(f"YoloDetBlock channel {channel} must be even")
        kw = dict(device=device, generator=generator)
        defs = [(ch_in, channel, 1), (channel, channel * 2, 3),
                (channel * 2, channel, 1), (channel, channel * 2, 3),
                (channel * 2, channel, 1)]
        self.conv_module = nn.Sequential(*[
            ConvBNLayer(ci, co, k, padding=(k - 1) // 2, **kw)
            for ci, co, k in defs])
        self.tip = ConvBNLayer(channel, channel * 2, 3, padding=1, **kw)

    def forward(self, x):
        route = self.conv_module(x)
        return route, self.tip(route)


class YOLOv3FPN(tnn.Module):
    """Top-down FPN over C3..C5, deepest first; the route is upsampled 2x
    nearest (``jax.image.resize`` "nearest": output pixel i reads input
    i // 2) and put before the lateral feature on the channel axis."""

    def __init__(self, in_channels=(256, 512, 1024), device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.num_blocks = len(in_channels)
        self.yolo_blocks = tnn.ModuleList()
        self.routes = tnn.ModuleList()
        self.out_channels = []
        for i, ch in enumerate(reversed(in_channels)):
            if i > 0:
                ch += 512 // (2 ** i)
            channel = 512 // (2 ** i)
            self.yolo_blocks.append(YoloDetBlock(ch, channel, **kw))
            self.out_channels.append(channel * 2)
            if i < self.num_blocks - 1:
                self.routes.append(ConvBNLayer(channel, channel // 2, 1,
                                               **kw))

    def forward(self, feats):
        outs = []
        route = None
        for i, x in enumerate(feats[::-1]):
            if i > 0:
                x = torch.cat([route, x], dim=-1)
            route, tip = self.yolo_blocks[i](x)
            outs.append(tip)
            if i < self.num_blocks - 1:
                route = self.routes[i](route)
                h, w = route.shape[1:3]
                route = interpolate(route, size=(2 * h, 2 * w),
                                    mode="nearest")
        return outs


class YOLOv3Head(tnn.Module):
    """One 1x1 prediction conv per level, normal(0.01) init.  With
    ``iou_aware`` each level has one IoU channel per anchor first; at eval
    the objectness becomes obj^(1-f) * iou^f, de-sigmoided."""

    def __init__(self, in_channels=(1024, 512, 256), anchors=DEFAULT_ANCHORS,
                 anchor_masks=DEFAULT_MASKS, num_classes=80,
                 iou_aware=False, iou_aware_factor=0.4, device=None,
                 generator=None):
        super().__init__()
        self.num_classes = num_classes
        self.iou_aware = iou_aware
        self.iou_aware_factor = iou_aware_factor
        self.anchors = [[tuple(anchors[i]) for i in mask]
                        for mask in anchor_masks]
        self.mask_anchors = [sum(([*anchors[i]] for i in mask), [])
                             for mask in anchor_masks]
        self.yolo_outputs = tnn.ModuleList([
            nn.Conv2d(ch, len(m) * (num_classes + 5)
                      + (len(m) if iou_aware else 0), 1,
                      w_init=lambda s, **kw: I.normal(s, std=0.01, **kw),
                      device=device, generator=generator)
            for ch, m in zip(in_channels, anchor_masks)])

    def split_ioup(self, out, level):
        """[B, H, W, na + na*(5+nc)] -> (ioup [B, H, W, na], the rest)."""
        na = len(self.anchors[level])
        return out[..., :na], out[..., na:]

    def recombine_iou_aware(self, out, level):
        if not self.iou_aware:
            return out
        na = len(self.anchors[level])
        ioup, x = self.split_ioup(out, level)
        b, h, w, _ = x.shape
        x = x.reshape(b, h, w, na, -1)
        obj = torch.sigmoid(x[..., 4])
        iou_p = torch.sigmoid(ioup)
        f = self.iou_aware_factor
        obj_t = torch.clamp(obj ** (1 - f) * iou_p ** f, 1e-7, 1 - 1e-7)
        obj_logit = torch.log(obj_t) - torch.log1p(-obj_t)  # de-sigmoid
        x = torch.cat([x[..., :4], obj_logit[..., None], x[..., 5:]], -1)
        return x.reshape(b, h, w, -1)

    def forward(self, feats):
        return [conv(f) for conv, f in zip(self.yolo_outputs, feats)]


def _stamp(flat, dims, b, gj, gi, n, vals, mask):
    """``tgt[b, gj, gi, n] = vals`` where ``mask``, for one GT slot of each
    image, in place on the flattened targets [B * gh * gw * na, C]: the
    reference's ``.at[...].set(mode="drop")``, a negative index counting
    from the end and one out of range dropped.  Each image writes one row,
    so the indices are distinct and the write is deterministic; a row
    masked out writes back what it read."""
    gh, gw, na = dims
    gj = torch.where(gj < 0, gj + gh, gj)
    gi = torch.where(gi < 0, gi + gw, gi)
    m = mask & (gj >= 0) & (gj < gh) & (gi >= 0) & (gi < gw)
    zero = torch.zeros_like(gj)
    idx = ((b * gh + torch.where(m, gj, zero)) * gw
           + torch.where(m, gi, zero)) * na + torch.where(m, n, zero)
    flat.index_put_((idx,), torch.where(m[:, None], vals.to(flat.dtype),
                                        flat[idx]))


def _log(x):
    """f32 log taken in f64 and rounded once: the card's and the CPU's f32
    logs may differ in the last bit, their f64 logs rounded to f32 do not
    (short of a tie within 2^-29 of an f32 rounding boundary), so the
    targets are bitwise one on both devices."""
    return torch.log(x.double()).float()


@torch.no_grad()
def gt2yolo_targets(gt_boxes, gt_class, gt_score, anchors, anchor_masks,
                    downsamples, input_hw, num_classes, iou_thresh=1.0):
    """Assign each GT to its best wh-IoU anchor and stamp per-level
    targets, on the GTs' device.

    gt_boxes [B, M, 4] normalised (cx, cy, w, h), zero area = padding;
    gt_class [B, M] integers; gt_score [B, M] (0 = invalid).  ``iou_thresh``
    < 1 also stamps every other anchor of the level whose wh-IoU with the
    GT exceeds it, where the slot is still empty.  Returns per level
    [B, gh, gw, na, 6 + nc] targets (tx, ty, tw, th, tscale, tobj, one-hot
    class).

    The GTs are stamped in order along the padded GT axis, as the
    reference's ``lax.scan``: a later GT overwrites an earlier one in a
    shared slot, and each extra-anchor stamp reads the slot's occupancy
    after that GT's best stamp.  (One scatter with duplicate indices is
    undefined on CUDA.)  As in the reference, tx and ty are clamped to
    [0, 1]: the cell is binned with round(gx * (gw - 1)) but tx = gx * gw -
    gi, which lies outside [0, 1] for about a quarter of the centres."""
    h, w = input_hw
    dev = gt_boxes.device
    anchors = torch.tensor(anchors, dtype=torch.float32, device=dev)
    an_hw = anchors / torch.tensor([w, h], dtype=torch.float32, device=dev)

    gx, gy = gt_boxes[..., 0], gt_boxes[..., 1]
    gw, gh = gt_boxes[..., 2], gt_boxes[..., 3]
    valid = (gw > 0) & (gh > 0) & (gt_score > 0)            # [B, M]
    inter = (torch.minimum(gw[..., None], an_hw[:, 0])
             * torch.minimum(gh[..., None], an_hw[:, 1]))
    union = (gw * gh)[..., None] + an_hw[:, 0] * an_hw[:, 1] - inter
    wh_iou = inter / (union + 1e-9)                         # [B, M, A]
    best_idx = torch.argmax(wh_iou, dim=-1)                 # first of ties

    b, m = gt_boxes.shape[:2]
    bidx = torch.arange(b, device=dev)
    onehot = (gt_class[..., None].long() == torch.arange(
        num_classes, device=dev)).float()                   # jax.nn.one_hot
    tscale = 2.0 - gw * gh

    targets = []
    for mask, ds in zip(anchor_masks, downsamples):
        grid_h, grid_w = round(h / ds), round(w / ds)
        mask_arr = torch.tensor(mask, device=dev)
        na = len(mask)
        in_level = best_idx[..., None] == mask_arr          # [B, M, na]
        best_n = torch.argmax(in_level.to(torch.uint8), dim=-1)
        assigned = in_level.any(-1) & valid

        gi = torch.round(gx * (grid_w - 1)).to(torch.int64)
        gj = torch.round(gy * (grid_h - 1)).to(torch.int64)
        tx = torch.clamp(gx * grid_w - gi, 0.0, 1.0)
        ty = torch.clamp(gy * grid_h - gj, 0.0, 1.0)
        aw_n, ah_n = anchors[mask_arr, 0], anchors[mask_arr, 1]
        tw_n = _log(torch.clamp_min(gw * w, 1e-9)[..., None] / aw_n)
        th_n = _log(torch.clamp_min(gh * h, 1e-9)[..., None] / ah_n)
        base = torch.stack([tx, ty], -1)                    # [B, M, 2]
        vals_n = torch.cat([
            base[:, :, None, :].expand(b, m, na, 2),
            tw_n[..., None], th_n[..., None],
            tscale[:, :, None, None].expand(b, m, na, 1),
            gt_score[:, :, None, None].float().expand(b, m, na, 1),
            onehot[:, :, None, :].expand(b, m, na, num_classes),
        ], -1)                                              # [B, M, na, C]
        level_iou = wh_iou[..., mask_arr]
        extra_ok = (valid[..., None] & (level_iou > iou_thresh)
                    & (mask_arr != best_idx[..., None]))
        gic = gi.clamp(0, grid_w - 1)
        gjc = gj.clamp(0, grid_h - 1)

        tgt = torch.zeros((b, grid_h, grid_w, na, 6 + num_classes),
                          dtype=torch.float32, device=dev)
        flat = tgt.view(-1, 6 + num_classes)
        dims = (grid_h, grid_w, na)
        for g in range(m):
            bn = best_n[:, g]
            _stamp(flat, dims, bidx, gj[:, g], gi[:, g], bn,
                   vals_n[bidx, g, bn], assigned[:, g])
            if iou_thresh < 1.0:
                for n in range(na):
                    occupied = tgt[bidx, gjc[:, g], gic[:, g], n, 5] > 0
                    _stamp(flat, dims, bidx, gj[:, g], gi[:, g],
                           torch.full_like(bn, n), vals_n[:, g, n],
                           extra_ok[:, g, n] & ~occupied)
        targets.append(tgt)
    return targets


def _decode_level(txy_twh, anchors, ds, grid_hw):
    """Raw (x, y, w, h) logits [..., gh, gw, na, 4] to normalised cxcywh
    boxes.  tw and th are clamped to [-10, 10]: exp of an unbounded logit
    overflows f32 after a few optimizer steps and poisons the objectness
    IoU with inf/NaN."""
    gh, gw = grid_hw
    dev = txy_twh.device
    x, y, tw, th = txy_twh.unbind(-1)
    gx = torch.arange(gw, dtype=torch.float32, device=dev)[None, :]
    gy = torch.arange(gh, dtype=torch.float32, device=dev)[:, None]
    cx = (torch.sigmoid(x) + gx[None, :, :, None]) / gw
    cy = (torch.sigmoid(y) + gy[None, :, :, None]) / gh
    an = torch.tensor(anchors, dtype=torch.float32, device=dev)
    bw = torch.exp(torch.clamp(tw, -10.0, 10.0)) * an[:, 0] / (ds * gw)
    bh = torch.exp(torch.clamp(th, -10.0, 10.0)) * an[:, 1] / (ds * gh)
    return torch.stack([cx, cy, bw, bh], -1)


def _bce(logit, label):
    """Binary cross-entropy in logit space, stable at any logit (the
    probability form's eps guard folds away under reassociation).  The
    maximum splits its gradient at 0 as ``jnp.maximum`` does."""
    return (torch.maximum(logit, torch.zeros_like(logit)) - logit * label
            + torch.log1p(torch.exp(-torch.abs(logit))))


def _xyxy(box):
    return torch.cat([box[..., :2] - box[..., 2:] * 0.5,
                      box[..., :2] + box[..., 2:] * 0.5], -1)


def _logit(t):
    t = torch.clamp(t, 1e-7, 1 - 1e-7)
    return torch.log(t) - torch.log1p(-t)


class YOLOv3Loss(tnn.Module):
    """The YOLOv3 loss per level: BCE of x and y against the fractional
    target, L1 of w and h, each weighted by tscale; objectness BCE with the
    ignore mask (predicted boxes whose best IoU with any GT exceeds
    ``ignore_thresh`` are not negatives); class BCE at the positives; with
    ``ioups``, the IoU-aware BCE at the positives.  Each term summed per
    image and averaged over the batch."""

    def __init__(self, num_classes=80, ignore_thresh=0.7, label_smooth=False,
                 downsamples=DOWNSAMPLES):
        super().__init__()
        self.num_classes = num_classes
        self.ignore_thresh = ignore_thresh
        self.label_smooth = label_smooth
        self.downsamples = downsamples

    def forward(self, head_outs, targets_per_level, gt_boxes, anchors,
                ioups=None):
        total = 0.0
        for li, (p, t, anchor, ds) in enumerate(zip(
                head_outs, targets_per_level, anchors, self.downsamples)):
            ioup = None if ioups is None else ioups[li]
            total = total + self._level_loss(p, t, gt_boxes, anchor, ds,
                                             ioup=ioup)
        return total

    def _level_loss(self, p, t, gt_box, anchor, ds, ioup=None):
        b, h, w, _ = p.shape
        na = len(anchor)
        p = p.reshape(b, h, w, na, -1)
        x, y, pw, ph, obj = p[..., :5].unbind(-1)
        pcls = p[..., 5:]
        tx, ty, tw, th, tscale, tobj = t[..., :6].unbind(-1)
        tcls = t[..., 6:]
        tscale_obj = tscale * tobj

        loss_xy = tscale_obj * (_bce(x, tx) + _bce(y, ty))
        loss_xy = loss_xy.reshape(b, -1).sum(-1).mean()
        loss_wh = tscale_obj * (torch.abs(pw - tw) + torch.abs(ph - th))
        loss_wh = loss_wh.reshape(b, -1).sum(-1).mean()

        # objectness with the ignore mask: decoded boxes (no gradient)
        # against every GT
        with torch.no_grad():
            pbox = _decode_level(torch.stack([x, y, pw, ph], -1), anchor,
                                 ds, (h, w))
            iou = pairwise_iou(_xyxy(pbox.reshape(b, -1, 4)),
                               _xyxy(gt_box))              # [B, A, M]
            ignore = (iou.amax(-1) <= self.ignore_thresh).to(p.dtype)
        obj_flat = obj.reshape(b, -1)
        tobj_flat = tobj.reshape(b, -1)
        obj_mask = (tobj_flat > 0).to(p.dtype)
        loss_obj = _bce(obj_flat, obj_mask)
        loss_obj = loss_obj * tobj_flat + loss_obj * (1 - obj_mask) * ignore
        loss_obj = loss_obj.sum(-1).mean()

        if self.label_smooth:
            delta = min(1.0 / self.num_classes, 1.0 / 40)
            tcls = torch.where(tcls > 0, 1 - delta, delta)
        loss_cls = (_bce(pcls, tcls) * tobj[..., None]).reshape(
            b, -1).sum(-1).mean()
        total = loss_xy + loss_wh + loss_obj + loss_cls

        if ioup is not None:
            # IoU-aware branch: BCE(ioup, IoU(predicted box, target box))
            # at the positive cells, the IoU taken without gradient
            with torch.no_grad():
                tbox = _decode_level(
                    torch.stack([_logit(tx), _logit(ty), tw, th], -1),
                    anchor, ds, (h, w))
                pb, tb = pbox, tbox
                inter_xy = (torch.minimum(pb[..., :2] + pb[..., 2:] / 2,
                                          tb[..., :2] + tb[..., 2:] / 2)
                            - torch.maximum(pb[..., :2] - pb[..., 2:] / 2,
                                            tb[..., :2] - tb[..., 2:] / 2))
                inter = (inter_xy[..., 0].clamp_min(0)
                         * inter_xy[..., 1].clamp_min(0))
                union = (pb[..., 2] * pb[..., 3] + tb[..., 2] * tb[..., 3]
                         - inter + 1e-9)
                cell_iou = inter / union
            loss_iou_aware = _bce(ioup.reshape(b, h, w, na), cell_iou) * tobj
            total = total + loss_iou_aware.reshape(b, -1).sum(-1).mean()
        return total


class YOLOv3(tnn.Module):
    """The detector.  Eval: ``forward`` returns ``(dets [B, keep_top_k,
    6], counts [B])``, rows [label, score, x1, y1, x2, y2] in input-image
    pixels, invalid rows [-1, 0, 0, 0, 0, 0].  Train mode returns the
    reference's ``{"head_outs", "input_hw"}`` for ``loss_fn``.
    ``gt_iou_thresh`` < 1 turns on the extra same-level anchor positives of
    the target assignment (the PP-YOLO recipe)."""

    def __init__(self, num_classes=80, anchors=DEFAULT_ANCHORS,
                 anchor_masks=DEFAULT_MASKS, score_threshold=0.01,
                 nms_threshold=0.5, nms_top_k=1000, keep_top_k=100,
                 use_matrix_nms=False, iou_aware=False,
                 iou_aware_factor=0.4, gt_iou_thresh=1.0, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.use_matrix_nms = use_matrix_nms
        self.gt_iou_thresh = gt_iou_thresh
        self.backbone = DarkNet(**kw)
        self.neck = YOLOv3FPN(in_channels=self.backbone.out_channels, **kw)
        self.yolo_head = YOLOv3Head(
            in_channels=self.neck.out_channels, anchors=anchors,
            anchor_masks=anchor_masks, num_classes=num_classes,
            iou_aware=iou_aware, iou_aware_factor=iou_aware_factor, **kw)
        self.num_classes = num_classes
        self.anchors = anchors
        self.anchor_masks = anchor_masks
        self.downsamples = DOWNSAMPLES
        self.loss = YOLOv3Loss(num_classes=num_classes)
        self.nms_cfg = dict(score_threshold=score_threshold,
                            nms_threshold=nms_threshold, nms_top_k=nms_top_k,
                            keep_top_k=keep_top_k)

    def head_outputs(self, images):
        return self.yolo_head(self.neck(self.backbone(images)))

    def forward(self, images):
        outs = self.head_outputs(images)
        if self.training:
            return {"head_outs": outs, "input_hw": tuple(images.shape[1:3])}
        return self.post_process(outs, images.shape[1:3])

    def loss_fn(self, outputs, targets):
        """``outputs``: the train-mode forward's dict.  ``targets``: a dict
        with "boxes" [B, M, 4] normalised cxcywh (zero-size rows are
        padding), "class_labels" [B, M] and optionally "scores" [B, M]
        (default: 1 where the box has a width)."""
        gt_boxes = targets["boxes"]
        gt_score = targets.get("scores")
        if gt_score is None:
            gt_score = (gt_boxes[..., 2] > 0).float()
        tgt = gt2yolo_targets(
            gt_boxes, targets["class_labels"], gt_score, self.anchors,
            self.anchor_masks, self.loss.downsamples, outputs["input_hw"],
            self.num_classes, iou_thresh=self.gt_iou_thresh)
        head_outs = outputs["head_outs"]
        ioups = None
        if self.yolo_head.iou_aware:
            split = [self.yolo_head.split_ioup(o, i)
                     for i, o in enumerate(head_outs)]
            ioups = [sp[0] for sp in split]
            head_outs = [sp[1] for sp in split]
        return self.loss(head_outs, tgt, gt_boxes, self.yolo_head.anchors,
                         ioups=ioups)

    def decode(self, head_outs, input_hw):
        """Every level's ``yolo_box``, concatenated: boxes [B, A, 4] and
        scores [B, A, C] before NMS."""
        h, w = input_hw
        n = head_outs[0].shape[0]
        img_size = torch.tensor([[h, w]], dtype=torch.int32,
                                device=head_outs[0].device).expand(n, 2)
        boxes, scores = [], []
        for li, (out, mask_anchor, ds) in enumerate(zip(
                head_outs, self.yolo_head.mask_anchors, self.downsamples)):
            out = self.yolo_head.recombine_iou_aware(out, li)
            bx, sc = yolo_box(out, img_size, mask_anchor, self.num_classes,
                              conf_thresh=0.005, downsample_ratio=ds)
            boxes.append(bx)
            scores.append(sc)
        return torch.cat(boxes, dim=1), torch.cat(scores, dim=1)

    def nms(self, boxes, scores):
        """Matrix NMS (``use_matrix_nms``, the bench's route) or the
        class-aware greedy ``multiclass_nms``: ``(dets, counts)``."""
        if self.use_matrix_nms:
            return matrix_nms(boxes, scores,
                              score_threshold=self.nms_cfg["score_threshold"],
                              keep_top_k=self.nms_cfg["keep_top_k"])
        return multiclass_nms(boxes, scores, **self.nms_cfg)

    def post_process(self, head_outs, input_hw):
        return self.nms(*self.decode(head_outs, input_hw))
