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
GEMM, ``ops.cuda.matmul.int8_matmul_nt``: 75 launches per forward.

Training (``gt2yolo_targets``, ``YOLOv3Loss``, ``loss_fn``) belongs to the
training slice of the port.
"""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...core import init as I
from ...device import resolve_device
from ...ops.image import interpolate
from ...ops.nms import matrix_nms, multiclass_nms
from ...ops.yolo import yolo_box
from .backbones.darknet import ConvBNLayer, DarkNet

__all__ = ["YOLOv3", "YOLOv3FPN", "YOLOv3Head", "YoloDetBlock",
           "DEFAULT_ANCHORS", "DEFAULT_MASKS", "DOWNSAMPLES"]

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


class YOLOv3(tnn.Module):
    """The detector.  Eval: ``forward`` returns ``(dets [B, keep_top_k,
    6], counts [B])``, rows [label, score, x1, y1, x2, y2] in input-image
    pixels, invalid rows [-1, 0, 0, 0, 0, 0].  Train mode returns the
    reference's ``{"head_outs", "input_hw"}``.  The reference's
    ``gt_iou_thresh`` is read only by its training loss and comes with it."""

    def __init__(self, num_classes=80, anchors=DEFAULT_ANCHORS,
                 anchor_masks=DEFAULT_MASKS, score_threshold=0.01,
                 nms_threshold=0.5, nms_top_k=1000, keep_top_k=100,
                 use_matrix_nms=False, iou_aware=False,
                 iou_aware_factor=0.4, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.use_matrix_nms = use_matrix_nms
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
        raise NotImplementedError(
            "YOLOv3 training (gt2yolo_targets, YOLOv3Loss, loss_fn) is not "
            "ported yet: ROADMAP queue 1, item 5 (training path)")

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
