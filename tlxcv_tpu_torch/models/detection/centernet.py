"""CenterNet, objects as points (counterpart of
``tlxcv_tpu/models/detection/centernet.py``), NHWC, to the ResNet + 3-deconv
CenterNet (PaddleDetection's ``centernet_r50``): C5 through three blocks
of a 3x3 conv and a 4x4 stride-2 ``ConvTranspose2d`` (256, 128, 64
channels; BatchNorm and ReLU after each) to stride 4, then a 3x3 + 1x1
head each for the class heatmap (bias at the prior 0.1), the box size and
the centre offset.

Eval (``decode``) takes no NMS: a 3x3 max-pool keeps each heatmap peak
(``cells``: every cell's box and peak scores), the top ``top_k`` peaks
over every class become ``(dets [B, top_k, 6], counts [B])`` (``select``),
those under ``score_threshold`` invalid.  Training returns
the heads for ``loss_fn``: a Gaussian per GT stamped on its class's map
(radius by ``gaussian_radius``), the penalty-reduced focal loss, and L1 on
the size and offset read at each GT's centre.

No kernel of ours runs here.
"""
from __future__ import annotations

import math

import torch
from torch import nn as tnn

from ... import nn
from ...core import init as I
from ...device import resolve_device
from ...ops.nms import top_k as _top_k
from ..classification.resnet import ResNet
from .fcos import _normal_001, ground_truth
from .yolox import _one_hot

__all__ = ["CenterNet", "centernet_r50", "gaussian_radius"]


def gaussian_radius(h, w, min_overlap=0.7):
    """CornerNet's radius: the least root of its three overlap cases, for
    tensors ``h``, ``w`` of box sides."""
    def root(a, b, c, sign):
        return (b + sign * torch.sqrt(torch.clamp_min(b ** 2 - 4 * a * c,
                                                      0.0))) / 2

    r1 = root(1.0, h + w, w * h * (1 - min_overlap) / (1 + min_overlap), -1)
    r2 = root(4.0, 2 * (h + w), (1 - min_overlap) * w * h, -1)
    r3 = root(4 * min_overlap, -2 * min_overlap * (h + w),
              (min_overlap - 1) * w * h, 1)
    return torch.clamp_min(torch.minimum(torch.minimum(r1, r2), r3), 0.0)


def _focal_heatmap_loss(hm, hm_t, pos_eps, num_pos):
    """The penalty-reduced focal loss of logits ``hm`` against the
    Gaussian targets ``hm_t``, positive where ``hm_t >= 1 - pos_eps``."""
    prob = torch.sigmoid(hm).clamp(1e-6, 1 - 1e-6)
    pos = hm_t >= 1.0 - pos_eps
    pos_loss = torch.where(pos, -((1 - prob) ** 2) * torch.log(prob), 0.0)
    neg_loss = torch.where(~pos, -((1 - hm_t) ** 4) * (prob ** 2)
                           * torch.log(1 - prob), 0.0)
    return (pos_loss.sum() + neg_loss.sum()) / num_pos


def _peak_scores(hm):
    """Sigmoid of the heatmap [N, H, W, C] where a 3x3 max-pool keeps it
    (its peaks), 0 elsewhere -> [N, H·W, C] f32."""
    prob = torch.sigmoid(hm.float())
    peaks = torch.where(prob >= nn.MaxPool2d(3, 1, 1)(prob), prob, 0.0)
    return peaks.reshape(hm.shape[0], -1, hm.shape[-1])


def _select(boxes, scores, k, threshold):
    """The top ``k`` of ``scores`` [N, P, C] over every cell and class, with
    their cells' ``boxes`` [N, P, 4] -> ``(dets [N, k, 6], counts [N])``:
    rows [label, score, x1, y1, x2, y2], those at or under ``threshold``
    [-1, 0, 0, 0, 0, 0]."""
    c = scores.shape[-1]
    top, idx = _top_k(scores.reshape(scores.shape[0], -1), k)
    cell = idx // c
    bx = boxes.gather(1, cell[..., None].expand(*cell.shape, 4))
    valid = top > threshold
    dets = torch.cat([(idx % c).float()[..., None], top[..., None], bx], -1)
    invalid = dets.new_tensor([-1, 0, 0, 0, 0, 0])
    return torch.where(valid[..., None], dets, invalid), valid.sum(-1)


class _DeconvBlock(tnn.Module):
    def __init__(self, c_in, c_out, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv = nn.Conv2d(c_in, c_out, 3, padding=1, bias=False, **kw)
        self.bn1 = nn.BatchNorm(c_out, device=device)
        self.up = nn.ConvTranspose2d(c_out, c_out, 4, stride=2, padding=1,
                                     bias=False, **kw)
        self.bn2 = nn.BatchNorm(c_out, device=device)

    def forward(self, x):
        x = nn.relu(self.bn1(self.conv(x)))
        return nn.relu(self.bn2(self.up(x)))


class _Head(tnn.Module):
    """3x3 conv to 64, ReLU, 1x1 prediction at normal(0.01)."""

    def __init__(self, c_in, c_out, bias_val=0.0, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv = nn.Conv2d(c_in, 64, 3, padding=1, **kw)
        self.pred = nn.Conv2d(64, c_out, 1, w_init=_normal_001,
                              b_init=lambda s, **k: I.constant(s, bias_val,
                                                               **k), **kw)

    def forward(self, x):
        return self.pred(nn.relu(self.conv(x)))


def _gather2(m, pix):
    """m [N, H, W, 2] read at cells pix [N, K] -> [N, K, 2] f32."""
    return m.float().reshape(m.shape[0], -1, 2).gather(
        1, pix[..., None].expand(*pix.shape, 2))


class CenterNet(tnn.Module):
    def __init__(self, num_classes=80, backbone=None, down_ratio=4,
                 top_k=100, score_threshold=0.1, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.backbone = backbone if backbone is not None else ResNet(
            depth=50, num_classes=0, with_pool=False, **kw)
        c5 = self.backbone.feat_channels[-1]
        self.deconvs = tnn.ModuleList([_DeconvBlock(c5, 256, **kw),
                                       _DeconvBlock(256, 128, **kw),
                                       _DeconvBlock(128, 64, **kw)])
        self.hm_head = _Head(64, num_classes,
                             bias_val=-math.log((1 - 0.1) / 0.1), **kw)
        self.wh_head = _Head(64, 2, **kw)
        self.off_head = _Head(64, 2, **kw)
        self.num_classes = num_classes
        self.down_ratio = down_ratio
        self.top_k = top_k
        self.score_threshold = score_threshold

    def head_outputs(self, images):
        """(heatmap logits [N, H/4, W/4, C], size [.., 2], offset [.., 2])."""
        x = self.backbone.features(images)[-1]
        for d in self.deconvs:
            x = d(x)
        return self.hm_head(x), self.wh_head(x), self.off_head(x)

    def forward(self, images):
        hm, wh, off = self.head_outputs(images)
        if self.training:
            return {"hm": hm, "wh": wh, "off": off,
                    "image_hw": tuple(images.shape[1:3])}
        return self.decode(hm, wh, off)

    def cells(self, hm, wh, off):
        """Every cell's box [N, H·W, 4] in input pixels (its centre plus
        offset, its size) and its peak scores [N, H·W, C]."""
        n, h, w = hm.shape[:3]
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=hm.device),
            torch.arange(w, dtype=torch.float32, device=hm.device),
            indexing="ij")
        o, s = off.float(), wh.float()
        r = self.down_ratio
        cx, cy = (gx + o[..., 0]) * r, (gy + o[..., 1]) * r
        bw, bh = s[..., 0] * r, s[..., 1] * r
        boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                             cy + bh / 2], -1)
        return boxes.reshape(n, -1, 4), _peak_scores(hm)

    def select(self, boxes, scores):
        return _select(boxes, scores, self.top_k, self.score_threshold)

    def decode(self, hm, wh, off):
        """The top ``top_k`` heatmap peaks -> ``(dets [N, K, 6], counts
        [N])``, boxes in input pixels."""
        return self.select(*self.cells(hm, wh, off))

    def _targets(self, gt_boxes, gt_labels, gt_valid, hw):
        """Per image: the heatmap targets [H, W, C] (each GT's Gaussian at
        its centre cell on its class's map, 1 at the cell), each GT's cell,
        size and sub-cell offset, in output cells."""
        h, w = hw
        dev = gt_boxes.device
        gx = torch.arange(w, dtype=torch.float32, device=dev)[None, :, None]
        gy = torch.arange(h, dtype=torch.float32, device=dev)[:, None, None]
        out = []
        for boxes, labels, valid in zip(gt_boxes, gt_labels, gt_valid):
            bx = boxes / self.down_ratio
            cx = (bx[:, 0] + bx[:, 2]) * 0.5
            cy = (bx[:, 1] + bx[:, 3]) * 0.5
            bw, bh = bx[:, 2] - bx[:, 0], bx[:, 3] - bx[:, 1]
            ix = torch.floor(cx).clamp(0, w - 1)
            iy = torch.floor(cy).clamp(0, h - 1)
            rad = gaussian_radius(torch.ceil(bh), torch.ceil(bw))
            sigma = ((2 * rad + 1) / 6.0).clamp_min(1e-3)
            g = torch.exp(-(((gx - ix) ** 2 + (gy - iy) ** 2)
                            / (2 * sigma ** 2)))                # [H, W, M]
            g = torch.where(valid > 0, g, 0.0)
            hm_t = (g[..., None] * _one_hot(labels, self.num_classes)).amax(2)
            pix = (iy * w + ix).long()
            ind = torch.zeros(h * w + 1, self.num_classes, device=dev)
            ind[torch.where(valid > 0, pix, h * w), labels] = 1.0
            hm_t = torch.maximum(hm_t, ind[:h * w].reshape(h, w, -1))
            out.append((hm_t, pix, torch.stack([bw, bh], -1),
                        torch.stack([cx - ix, cy - iy], -1)))
        return (torch.stack(t) for t in zip(*out))

    def loss_fn(self, outputs, targets):
        """targets: ``boxes`` [B, M, 4] xyxy pixels, ``class_labels`` [B,
        M], optional ``mask`` [B, M] (default: boxes of positive width)."""
        gt_boxes, gt_labels, gt_valid = ground_truth(targets)
        hm = outputs["hm"].float()
        with torch.no_grad():
            hm_t, pix, wh_t, off_t = self._targets(gt_boxes, gt_labels,
                                                   gt_valid, hm.shape[1:3])
        num_pos = gt_valid.sum().clamp_min(1.0)
        vw = gt_valid[..., None]
        wh_loss = ((_gather2(outputs["wh"], pix) - wh_t).abs() * vw).sum()
        off_loss = ((_gather2(outputs["off"], pix) - off_t).abs() * vw).sum()
        return (_focal_heatmap_loss(hm, hm_t, 1e-6, num_pos)
                + (0.1 * wh_loss + off_loss) / num_pos)


def centernet_r50(num_classes=80, **kwargs):
    return CenterNet(num_classes=num_classes, **kwargs)
