"""SSD-MobileNetV1, the serving half (counterpart of
``tlxcv_tpu/models/detection/ssd.py``): MobileNetV1's conv11 and conv13
features and four extra blocks, 1x1 box and score convs, the prior-box
decode, the softmax without the background class and the class-aware
``multiclass_nms``.  NHWC images, the JAX model's attribute names, static
output shapes: ``keep_top_k`` detection rows per image padded with label
-1, and a count.

No hand-written kernel sits on this path: the convolutions (depthwise ones
included) are cuDNN's.  The priors are built in numpy once per feature
size and device and kept on the device.  Training (matching and
hard-negative mining, ``SSDLoss``) belongs to the training slice.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn as tnn

from ... import nn
from ...core import init as I
from ...device import resolve_device
from ...ops.anchors import ssd_prior_box
from ...ops.nms import multiclass_nms
from ..classification.mobilenetv1 import ConvBNReLU, MobileNetV1

__all__ = ["SSD", "SSDHead", "SSDMobileNetBackbone", "ExtraBlock",
           "build_ssd_priors", "ssd_decode"]


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
        raise NotImplementedError(
            "SSD training (prior matching, hard-negative mining, SSDLoss) is "
            "not ported yet: ROADMAP queue 1, item 5 (training path)")
