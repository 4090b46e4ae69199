"""TTFNet, the training-time-friendly network (counterpart of
``tlxcv_tpu/models/detection/ttfnet.py``), NHWC, to PaddleDetection's
``ttfnet_darknet53``: DarkNet-53's C3-C5, two up blocks (a 4x4 stride-2
``ConvTranspose2d`` plus a 1x1 lateral from the backbone, each with
BatchNorm, summed, ReLU) and a third deconv to stride 4; a heatmap head
(bias at the prior 0.01) and a head of four distances (left, top, right,
bottom, times ``wh_offset_base``) a cell.

Eval (``decode``) takes CenterNet's peaks (no NMS); the box of a peak is
its cell's distances.  Training returns the heads for ``loss_fn``: each
GT's elliptic Gaussian (sides ``alpha`` / 6 of the box's, peak 1 on the
grid) on its class's map with the penalty-reduced focal loss, and GIoU of
every cell in a GT's Gaussian against that GT, weighted by the Gaussian
and normalised per GT.

No kernel of ours runs here.
"""
from __future__ import annotations

import math

import torch
from torch import nn as tnn

from ... import nn
from ...core import init as I
from ...device import resolve_device
from ...ops.boxes import aligned_iou
from .backbones.darknet import DarkNet
from .centernet import _focal_heatmap_loss, _peak_scores, _select
from .fcos import _normal_001, ground_truth
from .yolox import _one_hot

__all__ = ["TTFNet", "ttfnet_darknet53"]


class _UpBlock(tnn.Module):
    """relu(BN(deconv 2x of x) + BN(1x1 of the lateral))."""

    def __init__(self, c_in, c_out, c_lateral, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.up = nn.ConvTranspose2d(c_in, c_out, 4, stride=2, padding=1,
                                     bias=False, **kw)
        self.bn = nn.BatchNorm(c_out, device=device)
        self.lat = nn.Conv2d(c_lateral, c_out, 1, bias=False, **kw)
        self.lat_bn = nn.BatchNorm(c_out, device=device)

    def forward(self, x, lateral):
        return nn.relu(self.bn(self.up(x)) + self.lat_bn(self.lat(lateral)))


class _Head(tnn.Module):
    """3x3 conv to ``mid``, ReLU, 1x1 prediction at normal(0.01)."""

    def __init__(self, c_in, mid, c_out, bias_val=0.0, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv = nn.Conv2d(c_in, mid, 3, padding=1, **kw)
        self.pred = nn.Conv2d(mid, c_out, 1, w_init=_normal_001,
                              b_init=lambda s, **k: I.constant(s, bias_val,
                                                               **k), **kw)

    def forward(self, x):
        return self.pred(nn.relu(self.conv(x)))


class TTFNet(tnn.Module):
    def __init__(self, num_classes=80, backbone=None, down_ratio=4,
                 wh_offset_base=16.0, alpha=0.54, top_k=100,
                 score_threshold=0.01, hm_weight=1.0, wh_weight=5.0,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.backbone = backbone if backbone is not None else DarkNet(**kw)
        chans = self.backbone.out_channels      # (256, 512, 1024): s8..s32
        self.up1 = _UpBlock(chans[2], 256, chans[1], **kw)
        self.up2 = _UpBlock(256, 128, chans[0], **kw)
        self.up3 = nn.ConvTranspose2d(128, 64, 4, stride=2, padding=1,
                                      bias=False, **kw)
        self.up3_bn = nn.BatchNorm(64, device=device)
        self.hm_head = _Head(64, 128, num_classes,
                             bias_val=-math.log((1 - 0.01) / 0.01), **kw)
        self.wh_head = _Head(64, 64, 4, **kw)
        self.num_classes = num_classes
        self.down_ratio = down_ratio
        self.wh_offset_base = wh_offset_base
        self.alpha = alpha
        self.top_k = top_k
        self.score_threshold = score_threshold
        self.hm_weight = hm_weight
        self.wh_weight = wh_weight

    def head_outputs(self, images):
        """(heatmap logits [N, H/4, W/4, C], distances [.., 4])."""
        c3, c4, c5 = self.backbone(images)
        x = self.up2(self.up1(c5, c4), c3)
        x = nn.relu(self.up3_bn(self.up3(x)))
        return self.hm_head(x), self.wh_head(x)

    def _decode_boxes(self, wh):
        """[N, H, W, 4] distances -> every cell's box [N, H, W, 4] xyxy
        pixels (f32)."""
        h, w = wh.shape[1:3]
        d = nn.relu(wh.float()) * self.wh_offset_base
        gy, gx = torch.meshgrid(
            (torch.arange(h, dtype=torch.float32, device=wh.device) + 0.5)
            * self.down_ratio,
            (torch.arange(w, dtype=torch.float32, device=wh.device) + 0.5)
            * self.down_ratio, indexing="ij")
        return torch.stack([gx - d[..., 0], gy - d[..., 1],
                            gx + d[..., 2], gy + d[..., 3]], -1)

    def forward(self, images):
        hm, wh = self.head_outputs(images)
        if self.training:
            return {"hm": hm, "wh": wh, "image_hw": tuple(images.shape[1:3])}
        return self.decode(hm, wh)

    def cells(self, hm, wh):
        """Every cell's box [N, H·W, 4] and its peak scores [N, H·W, C]."""
        return (self._decode_boxes(wh).reshape(wh.shape[0], -1, 4),
                _peak_scores(hm))

    def select(self, boxes, scores):
        return _select(boxes, scores, self.top_k, self.score_threshold)

    def decode(self, hm, wh):
        """The top ``top_k`` heatmap peaks -> ``(dets [N, K, 6], counts
        [N])``."""
        return self.select(*self.cells(hm, wh))

    def _targets(self, gt_boxes, gt_labels, gt_valid, hw):
        """Per image: the heatmap targets [H, W, C], each cell's GT box
        [H, W, 4] (the GT whose Gaussian is highest there) and its
        regression weight [H, W]."""
        h, w = hw
        dev = gt_boxes.device
        gx = torch.arange(w, dtype=torch.float32, device=dev)[None, :, None]
        gy = torch.arange(h, dtype=torch.float32, device=dev)[:, None, None]
        out = []
        for boxes, labels, valid in zip(gt_boxes, gt_labels, gt_valid):
            bx = boxes / self.down_ratio
            cx = (bx[:, 0] + bx[:, 2]) * 0.5
            cy = (bx[:, 1] + bx[:, 3]) * 0.5
            sx = (self.alpha * (bx[:, 2] - bx[:, 0]).clamp_min(1e-3)
                  / 6.0).clamp_min(1e-3)
            sy = (self.alpha * (bx[:, 3] - bx[:, 1]).clamp_min(1e-3)
                  / 6.0).clamp_min(1e-3)
            g = torch.exp(-(((gx - cx) ** 2 / (2 * sx ** 2))
                            + ((gy - cy) ** 2 / (2 * sy ** 2))))
            # each GT's Gaussian peaks at exactly 1 on the grid
            g = g / g.amax((0, 1), keepdim=True).clamp_min(1e-6)
            g = torch.where(valid > 0, g, 0.0)                  # [H, W, M]
            hm_t = (g[..., None] * _one_hot(labels, self.num_classes)).amax(2)
            wmax, own = g.amax(-1), g.argmax(-1)                # [H, W]
            # every GT's weights sum to 1 over the cells it owns
            gsum = torch.zeros(g.shape[-1], device=dev).index_add(
                0, own.reshape(-1), wmax.reshape(-1))
            norm = torch.where(valid > 0, 1.0 / gsum.clamp_min(1e-6), 0.0)
            wgt = wmax * norm[own] * torch.where(valid[own] > 0, 1.0, 0.0)
            out.append((hm_t, boxes[own], torch.where(wmax > 1e-4, wgt, 0.0)))
        return (torch.stack(t) for t in zip(*out))

    def loss_fn(self, outputs, targets):
        """targets: ``boxes`` [B, M, 4] xyxy pixels, ``class_labels`` [B,
        M], optional ``mask`` [B, M] (default: boxes of positive width)."""
        gt_boxes, gt_labels, gt_valid = ground_truth(targets)
        hm = outputs["hm"].float()
        with torch.no_grad():
            hm_t, box_t, wgt = self._targets(gt_boxes, gt_labels, gt_valid,
                                             hm.shape[1:3])
        hm_loss = _focal_heatmap_loss(hm, hm_t, 1e-4,
                                      gt_valid.sum().clamp_min(1.0))
        giou = 1.0 - aligned_iou(self._decode_boxes(outputs["wh"]), box_t,
                                 mode="giou")
        wh_loss = (giou * wgt).sum() / wgt.sum().clamp_min(1e-6)
        return self.hm_weight * hm_loss + self.wh_weight * wh_loss


def ttfnet_darknet53(num_classes=80, **kwargs):
    return TTFNet(num_classes=num_classes, **kwargs)
