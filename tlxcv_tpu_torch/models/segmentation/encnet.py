"""EncNet: context-encoding segmentation on ResNet-vD (counterpart of
``tlxcv_tpu/models/segmentation/encnet.py``), NHWC.  Shares FastFCN's
encoding head."""
from __future__ import annotations

from torch import nn as tnn

from ...device import resolve_device
from ...ops.image import interpolate
from ..backbones.resnet_vd import resnet50_vd
from .fastfcn import EncHead
from .layers import AuxLayer

__all__ = ["ENCNet"]


class ENCNet(tnn.Module):
    """Logits at the input's size.  In training with
    ``enable_auxiliary_loss``, the list of those, the auxiliary head's
    logits over C4 and (with ``use_se_loss``) the semantic-encoding
    logits."""

    def __init__(self, num_classes=19, backbone=None, num_codes=32,
                 enable_auxiliary_loss=False, use_se_loss=True, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.backbone = backbone if backbone is not None else resnet50_vd(
            **kw)
        self.head = EncHead(self.backbone.feat_channels[-1], num_classes,
                            num_codes, use_se_loss=use_se_loss, **kw)
        self.aux = (AuxLayer(self.backbone.feat_channels[2], 256,
                             num_classes, **kw)
                    if enable_auxiliary_loss else None)
        self.enable_aux = enable_auxiliary_loss

    def forward(self, x):
        size = x.shape[1:3]
        feats = self.backbone(x)
        head_out = self.head(feats[-1])
        logits, se = head_out if isinstance(head_out, tuple) \
            else (head_out, None)
        logits = interpolate(logits, size=size, mode="bilinear")
        if self.training and self.enable_aux:
            outs = [logits, interpolate(self.aux(feats[2]), size=size,
                                        mode="bilinear")]
            return outs + ([se] if se is not None else [])
        return logits
