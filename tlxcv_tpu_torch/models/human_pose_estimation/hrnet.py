"""Pose HRNet (counterpart of
``tlxcv_tpu/models/human_pose_estimation/hrnet.py``): HRNet-W32 with a 1x1
head on its highest-resolution branch, one heatmap per joint (17 COCO
joints), NHWC, and the per-joint weighted heatmap MSE.  No kernel of this
port is on its path: the convolutions are cuDNN's, the branch fusions'
resizes torch ops."""
from __future__ import annotations

import torch
from torch import nn

from ...core import init as I
from ...device import resolve_device
from ...nn.layers import Conv2d
from ..backbones.hrnet import HRNet, hrnet_w32

__all__ = ["PoseHighResolutionNet", "pose_hrnet_w32", "heatmap_mse_loss"]


def heatmap_mse_loss(output, target, target_weight=None):
    """Per-joint weighted heatmap MSE: ``0.5 * mean((pred - gt)**2) * J``.

    output, target: [B, H, W, J]; target_weight: [B, J] or [B, J, 1]."""
    b, h, w, j = output.shape
    pred = output.reshape(b, -1, j)
    gt = target.reshape(b, -1, j)
    if target_weight is not None:
        tw = target_weight.reshape(b, 1, j)
        pred = pred * tw
        gt = gt * tw
    return 0.5 * torch.mean((pred - gt) ** 2) * j


class PoseHighResolutionNet(nn.Module):
    """HRNet backbone (``hrnet_w32`` unless given one) and ``final_layer``,
    a 1x1 conv from the first branch's channels to ``num_joints``.  The
    final layer is drawn normal(0.001) from the caller's generator, the
    MMPose convention: kaiming fan_out on a J-channel 1x1 conv gives std
    ~0.6 and a huge initial heatmap MSE.  ``width`` is the reference's
    argument; as there, the default backbone is W32 whatever it says."""

    def __init__(self, num_joints=17, width=32, backbone: HRNet = None,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.backbone = backbone if backbone is not None else hrnet_w32(
            device=device, generator=generator)
        self.final_layer = Conv2d(
            self.backbone.branch_channels[0], num_joints, 1,
            w_init=lambda s, **kw: I.normal(s, std=0.001, **kw),
            device=device, generator=generator)
        self.num_joints = num_joints

    def forward(self, x):
        return self.final_layer(self.backbone(x)[0])

    def loss_fn(self, output, target, target_weight=None):
        """``target`` is the heatmaps, a (heatmaps, weights) tuple or list,
        or a dict with "target" and, optionally, "target_weight"."""
        if isinstance(target, (tuple, list)):
            target, target_weight = target
        elif isinstance(target, dict):
            target_weight = target.get("target_weight")
            target = target["target"]
        return heatmap_mse_loss(output, target, target_weight)


def pose_hrnet_w32(num_joints=17, **kw):
    return PoseHighResolutionNet(num_joints=num_joints, width=32, **kw)
