"""RetinaFace on ResNet-50 (counterpart of
``tlxcv_tpu/models/face_recognition/retinaface.py``), NHWC.

The FPN's two top-down merges go through ``ops.image.upsample_add`` with
``mode="nearest"``: on the card each is one launch of the hand-written
upsample-add kernel (``csrc/upsample_add.cu``), two a forward.  Its
nearest rule is torch's legacy floor(i * in / out), which is also the
reference's at 2x and at the other ratios a frame whose side is not a
multiple of 32 gives (38 -> 75 at 600 px).

``multi_box_loss`` ranks the negatives for hard-negative mining with a
stable sort, as the reference's ``argsort`` is stable: many losses tie
at 0, and another order of the ties would choose other negatives.
"""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...core import init as I
from ...device import resolve_device
from ...ops.image import upsample_add
from ..classification.resnet import ResNet

__all__ = ["RetinaFace", "multi_box_loss", "hard_negatives"]


class ConvUnit(tnn.Module):
    def __init__(self, cin, cout, k, s, act=None, device=None,
                 generator=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=s, padding=(k - 1) // 2,
                              bias=False, w_init=I.kaiming_normal,
                              device=device, generator=generator)
        self.bn = nn.BatchNorm(cout, device=device)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        if self.act == "relu":
            return nn.relu(x)
        if self.act == "lrelu":
            return nn.leaky_relu(x, 0.1)
        return x


class FPN(tnn.Module):
    def __init__(self, in_channels, out_ch, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        act = "lrelu" if out_ch <= 64 else "relu"
        self.outputs = tnn.ModuleList([ConvUnit(c, out_ch, 1, 1, act, **kw)
                                       for c in in_channels])
        self.merge1 = ConvUnit(out_ch, out_ch, 3, 1, act, **kw)
        self.merge2 = ConvUnit(out_ch, out_ch, 3, 1, act, **kw)

    def forward(self, feats):
        out1, out2, out3 = [conv(f) for conv, f in zip(self.outputs, feats)]
        out2 = self.merge2(upsample_add(out3, out2, mode="nearest"))
        out1 = self.merge1(upsample_add(out2, out1, mode="nearest"))
        return out1, out2, out3


class SSH(tnn.Module):
    def __init__(self, ch, out_ch, device=None, generator=None):
        super().__init__()
        if out_ch % 4:
            raise ValueError(f"SSH width {out_ch} is not a multiple of 4")
        kw = dict(device=device, generator=generator)
        act = "lrelu" if out_ch <= 64 else "relu"
        q = out_ch // 4
        self.conv_3x3 = ConvUnit(ch, out_ch // 2, 3, 1, None, **kw)
        self.conv_5x5_1 = ConvUnit(ch, q, 3, 1, act, **kw)
        self.conv_5x5_2 = ConvUnit(q, q, 3, 1, None, **kw)
        self.conv_7x7_2 = ConvUnit(q, q, 3, 1, act, **kw)
        self.conv_7x7_3 = ConvUnit(q, q, 3, 1, None, **kw)

    def forward(self, x):
        c3 = self.conv_3x3(x)
        c51 = self.conv_5x5_1(x)
        c5 = self.conv_5x5_2(c51)
        c7 = self.conv_7x7_3(self.conv_7x7_2(c51))
        return nn.relu(torch.cat([c3, c5, c7], -1))


class _Head(tnn.Module):
    """1x1 conv to ``num_anchor * out`` channels, as ``[B, H*W*A, out]``
    (anchors fastest, then columns, then rows)."""

    def __init__(self, ch, num_anchor, out_per_anchor, device=None,
                 generator=None):
        super().__init__()
        self.conv = nn.Conv2d(ch, num_anchor * out_per_anchor, 1,
                              device=device, generator=generator)
        self.out = out_per_anchor

    def forward(self, x):
        y = self.conv(x)
        return y.reshape(y.shape[0], -1, self.out)


def _smooth_l1(y_true, y_pred):
    t = (y_pred - y_true).abs()
    return torch.where(t < 1, 0.5 * t * t, t - 0.5)


def _masked_mean(x, m):
    m = m.to(x.dtype)
    while m.ndim < x.ndim:
        m = m[..., None]
    return (x * m).sum() / m.expand(x.shape).sum().clamp_min(1.0)


def hard_negatives(class_pred, mask_pos, mask_neg, neg_pos_ratio=3):
    """The priors chosen as hard negatives [B, A]: the ``neg_pos_ratio``
    times as many as the positives (at most A - 1) with the largest
    ``1 - p(background)`` among the negatives, the others counting 0.
    Ties are taken in prior order: a stable sort of the negated losses,
    every tie at +0."""
    neg_loss = torch.where(mask_neg, class_pred[..., 0] - 1,
                           torch.zeros_like(class_pred[..., 0]))
    idx = torch.sort(neg_loss, dim=1, stable=True).indices
    num_prior = idx.shape[1]
    rank = torch.empty_like(idx).scatter_(
        1, idx, torch.arange(num_prior, device=idx.device).expand_as(idx))
    num_pos = mask_pos.sum(1, keepdim=True).clamp_min(1)
    return rank < torch.clamp(neg_pos_ratio * num_pos, max=num_prior - 1)


def multi_box_loss(y_true, y_pred, neg_pos_ratio=3):
    """Smooth-L1 box and landmark losses over the positive priors, and a
    cross-entropy over the positives and the hardest negatives (at most
    ``neg_pos_ratio`` a positive), each a masked mean.  ``y_true`` [B, A,
    16] = (loc 4, landmarks 10, landmark valid, class); ``y_pred`` = (loc,
    landmarks, class probabilities)."""
    loc_pred, landm_pred, class_pred = y_pred
    loc_true = y_true[..., 0:4]
    landm_true = y_true[..., 4:14]
    landm_valid = y_true[..., 14]
    class_true = y_true[..., 15]
    mask_pos = class_true == 1
    mask_neg = class_true == 0
    mask_landm = (landm_valid == 1) & mask_pos
    loss_landm = _masked_mean(_smooth_l1(landm_true, landm_pred), mask_landm)
    loss_loc = _masked_mean(_smooth_l1(loc_true, loc_pred), mask_pos)

    sel = mask_pos | hard_negatives(class_pred, mask_pos, mask_neg,
                                    neg_pos_ratio)
    logp = torch.log(class_pred.clamp(1e-6, 1.0))
    ce = -logp.gather(-1, mask_pos.long()[..., None])[..., 0]
    loss_class = (ce * sel).sum() / sel.sum().clamp_min(1).to(ce.dtype)
    return loss_loc, loss_landm, loss_class


class RetinaFace(tnn.Module):
    """Returns (boxes [B, A, 4], landmarks [B, A, 10], class probabilities
    [B, A, 2]) over the priors of ``tasks.face_recognition.prior_box``."""

    def __init__(self, input_size=640, out_channel=256,
                 min_sizes=((16, 32), (64, 128), (256, 512)), iou_th=0.4,
                 score_th=0.02, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.input_size = input_size
        self.num_anchor = len(min_sizes[0])
        self.min_sizes = min_sizes
        self.iou_th = iou_th
        self.score_th = score_th
        self.backbone = ResNet(depth=50, num_classes=0, with_pool=False,
                               **kw)
        in_chs = self.backbone.feat_channels[1:]  # C3, C4, C5
        self.fpn = FPN(in_chs, out_channel, **kw)
        self.ssh = tnn.ModuleList([SSH(out_channel, out_channel, **kw)
                                   for _ in range(3)])
        heads = lambda n: tnn.ModuleList([  # noqa: E731
            _Head(out_channel, self.num_anchor, n, **kw) for _ in range(3)])
        self.bboxheads = heads(4)
        self.landheads = heads(10)
        self.classheads = heads(2)

    def forward(self, x):
        feats = self.fpn(self.backbone.features(x)[1:])  # C3, C4, C5
        feats = [ssh(f) for ssh, f in zip(self.ssh, feats)]
        cat = lambda heads: torch.cat(  # noqa: E731
            [h(f) for h, f in zip(heads, feats)], 1)
        return (cat(self.bboxheads), cat(self.landheads),
                torch.softmax(cat(self.classheads), -1))

    def loss_fn(self, predictions, labels):
        w = h = self.input_size
        loc, landm, cls = predictions
        loc = loc * loc.new_tensor([w, h] * 2)
        landm = landm * landm.new_tensor([w, h] * 5)
        l_loc, l_landm, l_cls = multi_box_loss(labels, (loc, landm, cls))
        return l_loc + l_landm + l_cls
