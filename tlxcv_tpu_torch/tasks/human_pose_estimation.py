"""Human pose estimation task (counterpart of
``tlxcv_tpu/tasks/human_pose_estimation.py``): the task module, heatmap
targets on any device (``generate_heatmap_target``, torch) or per sample
on the host (``GenerateTarget``, numpy, the same arithmetic), the argmax
decode and the PCK metric."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..models.human_pose_estimation.hrnet import heatmap_mse_loss
from ..utils.metrics import Metric, as_numpy

__all__ = ["HumanPoseEstimation", "generate_heatmap_target", "GenerateTarget",
           "get_max_preds", "PCK"]


class HumanPoseEstimation(nn.Module):
    def __init__(self, backbone: nn.Module):
        super().__init__()
        self.backbone = backbone

    def loss_fn(self, output, target):
        """``target``: the heatmaps, or (heatmaps, joint weights)."""
        if isinstance(target, (tuple, list)):
            target, target_weight = target[0], target[1]
        else:
            target_weight = None
        return heatmap_mse_loss(output, target, target_weight)

    def forward(self, inputs):
        return self.backbone(inputs)

    def predict(self, inputs):
        return self.backbone(inputs)


def generate_heatmap_target(keypoints, input_size=(256, 256),
                            heatmap_size=(64, 64), sigma=2.0):
    """Gaussian heatmap targets in one broadcast expression, on the
    keypoints' device.

    keypoints: [..., J, 3] (x, y, visibility) in input-image pixels.
    Returns (target [..., Hh, Hw, J], target_weight [..., J]), f32."""
    kp = torch.as_tensor(keypoints, dtype=torch.float32)
    hh, hw = heatmap_size
    stride = (torch.tensor(input_size, dtype=torch.float32)
              / torch.tensor(heatmap_size, dtype=torch.float32)).to(
        kp.device)  # (sy, sx); tensor divisors: true division on any device
    mu_x = torch.floor(kp[..., 0] / stride[1] + 0.5)
    mu_y = torch.floor(kp[..., 1] / stride[0] + 0.5)
    vis = torch.clamp_max(kp[..., 2], 1.0)
    tmp = 3 * sigma
    inside = ((mu_x - tmp < hw) & (mu_y - tmp < hh)
              & (mu_x + tmp + 1 >= 0) & (mu_y + tmp + 1 >= 0))
    weight = torch.where(inside, vis, 0.0)
    ys = torch.arange(hh, dtype=torch.float32, device=kp.device)[:, None]
    xs = torch.arange(hw, dtype=torch.float32, device=kp.device)[None, :]
    d2 = ((xs - mu_x[..., None, None]) ** 2
          + (ys - mu_y[..., None, None]) ** 2)          # [..., J, Hh, Hw]
    g = torch.exp(-d2 / d2.new_full((), 2 * sigma ** 2))
    g = g * (weight[..., None, None] > 0.5)
    return torch.movedim(g, -3, -1), weight


class GenerateTarget:
    """Per-sample transform on the host, numpy in and out: ``(image,
    keypoints [J, 3])`` -> ``(image, (target [Hh, Hw, J], weight [J]))``,
    the arithmetic of ``generate_heatmap_target``."""

    def __init__(self, size=(256, 256), num_of_joints=17,
                 heatmap_size=(64, 64), sigma=2):
        self.size = size
        self.num_of_joints = num_of_joints
        self.heatmap_size = heatmap_size
        self.sigma = sigma

    def __call__(self, data):
        image, label = data
        kp = np.asarray(label, np.float32)
        if kp.shape[-2] != self.num_of_joints:
            raise ValueError(
                f"expected {self.num_of_joints} joints, got {kp.shape}")
        hh, hw = self.heatmap_size
        sy = self.size[0] / self.heatmap_size[0]
        sx = self.size[1] / self.heatmap_size[1]
        mu_x = np.floor(kp[..., 0] / sx + 0.5)
        mu_y = np.floor(kp[..., 1] / sy + 0.5)
        vis = np.minimum(kp[..., 2], 1.0)
        tmp = 3 * self.sigma
        inside = ((mu_x - tmp < hw) & (mu_y - tmp < hh)
                  & (mu_x + tmp + 1 >= 0) & (mu_y + tmp + 1 >= 0))
        weight = np.where(inside, vis, 0.0).astype(np.float32)
        ys, xs = np.mgrid[0:hh, 0:hw].astype(np.float32)
        d2 = ((xs - mu_x[..., None, None]) ** 2
              + (ys - mu_y[..., None, None]) ** 2)
        g = np.exp(-d2 / (2 * self.sigma ** 2))
        g = g * (weight[..., None, None] > 0.5)
        target = np.moveaxis(g, -3, -1).astype(np.float32)
        return image, (target, weight)


def get_max_preds(heatmap):
    """Argmax decode of NHWC heatmaps: ((x, y) [B, J, 2] f32, with -1
    where the peak is <= 0; the peak values [B, J])."""
    heatmap = np.asarray(heatmap)
    b, h, w, j = heatmap.shape
    flat = heatmap.reshape(b, -1, j)
    idx = np.argmax(flat, axis=1)
    maxval = np.amax(flat, axis=1)
    x, y = idx % w, idx // w
    preds = np.dstack((x, y)).astype(np.float32)
    preds[maxval <= 0] = -1
    return preds, maxval


class PCK(Metric):
    """Percentage of correct keypoints: decoded peaks within ``threshold``
    of the target's, in heatmap-normalised units, over the joints whose
    target has a peak."""

    def __init__(self, threshold=0.05):
        self.threshold = threshold
        self.reset()

    def update(self, y_pred, y_true):
        if isinstance(y_true, (tuple, list)):
            y_true = y_true[0]
        pred_hm = as_numpy(y_pred)
        true_hm = as_numpy(y_true)
        _, h, w, _ = pred_hm.shape
        pred, _ = get_max_preds(pred_hm)
        target, _ = get_max_preds(true_hm)
        pred = pred / (w, h)
        target_n = target / (w, h)
        dist = np.linalg.norm(pred - target_n, axis=-1)
        mask = (target >= 0).all(axis=-1)
        self.correct += int((dist[mask] < self.threshold).sum())
        self.total += int(mask.sum())

    def result(self):
        return self.correct / max(self.total, 1)

    def reset(self):
        self.correct = 0
        self.total = 0

