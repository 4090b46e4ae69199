"""PFLD facial landmarks (counterpart of
``tlxcv_tpu/models/facial_landmark_detection/pfld.py``): NHWC, 112x112
input, 68 points (136 outputs), an auxiliary Euler-angle head read only by
the loss.  No kernel of this port is on its path."""
from __future__ import annotations

import torch
from torch import nn

from ...device import resolve_device
from ...nn.layers import Activation, BatchNorm, Conv2d, Linear, Sequential, relu

__all__ = ["PFLD", "PFLDBackbone", "AuxiliaryNet", "ConvBN",
           "InvertedResidual", "pfld_loss"]


def pfld_loss(landmarks, angle, landmark_gt, euler_angle_gt,
              attribute_gt=None):
    """Landmark L2 weighted by the angle error, ``sum(1 - cos(angle -
    euler))``, and by attribute rarity (the inverse of each attribute's
    share of the batch, the batch size where none has it)."""
    b = landmarks.shape[0]
    landmarks = landmarks.reshape(b, -1)
    landmark_gt = landmark_gt.reshape(b, -1)
    weight_angle = torch.sum(1.0 - torch.cos(angle - euler_angle_gt), dim=1)
    if attribute_gt is not None:
        attr = attribute_gt.float()
        ratio = attr.mean(0)
        ratio = torch.where(ratio > 0, 1.0 / torch.clamp_min(ratio, 1e-9),
                            float(b))
        weight_attribute = torch.sum(attr * ratio, dim=1)
    else:
        weight_attribute = 1.0
    l2 = torch.sum((landmark_gt - landmarks) ** 2, dim=1)
    return torch.mean(weight_angle * weight_attribute * l2)


class ConvBN(nn.Module):
    """Conv (no bias), BatchNorm, ReLU; "same" pads (k - 1) // 2, "VALID"
    nothing."""

    def __init__(self, cin, cout, k, stride, padding="same", device=None,
                 generator=None):
        super().__init__()
        pad = 0 if padding == "VALID" else (k - 1) // 2
        self.conv = Conv2d(cin, cout, k, stride=stride, padding=pad,
                           bias=False, device=device, generator=generator)
        self.bn = BatchNorm(cout, device=device)

    def forward(self, x):
        return relu(self.bn(self.conv(x)))


class InvertedResidual(nn.Module):
    def __init__(self, inp, oup, stride, use_res, expand_ratio=6,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        mid = inp * expand_ratio
        self.use_res = use_res
        self.conv = Sequential(
            Conv2d(inp, mid, 1, bias=False, **kw), BatchNorm(mid, device=device),
            Activation("relu"),
            Conv2d(mid, mid, 3, stride=stride, padding=1, groups=mid,
                   bias=False, **kw),
            BatchNorm(mid, device=device), Activation("relu"),
            Conv2d(mid, oup, 1, bias=False, **kw),
            BatchNorm(oup, device=device))

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class PFLDBackbone(nn.Module):
    """Returns (landmarks [B, 2 * num_landmarks], the 28x28 features the
    auxiliary net reads).  ``fc`` reads the three scales flattened in NHWC
    order, as the reference's (14 * 14 * 16 + 7 * 7 * 32 + 128 = 4,832
    inputs at 112^2); ``conv8`` is a 7x7 conv with no padding."""

    def __init__(self, num_landmarks=68, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.conv1 = Conv2d(3, 64, 3, stride=2, padding=1, bias=False, **kw)
        self.bn1 = BatchNorm(64, device=device)
        self.conv2 = Conv2d(64, 64, 3, padding=1, bias=False, **kw)
        self.bn2 = BatchNorm(64, device=device)
        self.conv3_1 = InvertedResidual(64, 64, 2, False, 2, **kw)
        self.blocks3 = nn.ModuleList(
            InvertedResidual(64, 64, 1, True, 2, **kw) for _ in range(4))
        self.conv4_1 = InvertedResidual(64, 128, 2, False, 2, **kw)
        self.conv5_1 = InvertedResidual(128, 128, 1, False, 4, **kw)
        self.blocks5 = nn.ModuleList(
            InvertedResidual(128, 128, 1, True, 4, **kw) for _ in range(5))
        self.conv6_1 = InvertedResidual(128, 16, 1, False, 2, **kw)
        self.conv7 = ConvBN(16, 32, 3, 2, **kw)
        self.conv8 = Conv2d(32, 128, 7, **kw)
        self.bn8 = BatchNorm(128, device=device)
        self.fc = Linear(14 * 14 * 16 + 7 * 7 * 32 + 128, num_landmarks * 2,
                         **kw)

    def forward(self, x):
        x = relu(self.bn1(self.conv1(x)))
        x = relu(self.bn2(self.conv2(x)))
        x = self.conv3_1(x)
        for blk in self.blocks3:
            x = blk(x)
        features = x  # [B, 28, 28, 64]
        x = self.conv4_1(features)
        x = self.conv5_1(x)
        for blk in self.blocks5:
            x = blk(x)
        x = self.conv6_1(x)
        x1 = x.reshape(x.shape[0], -1)  # NHWC order, as the reference
        x = self.conv7(x)
        x2 = x.reshape(x.shape[0], -1)
        x = relu(self.conv8(x))
        x3 = x.reshape(x.shape[0], -1)
        landmarks = self.fc(torch.cat([x1, x2, x3], 1))
        return landmarks, features


class AuxiliaryNet(nn.Module):
    """Euler angles (3) from the backbone's 28x28 features."""

    def __init__(self, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.conv1 = ConvBN(64, 128, 3, 2, **kw)
        self.conv2 = ConvBN(128, 128, 3, 1, **kw)
        self.conv3 = ConvBN(128, 32, 3, 2, **kw)
        self.conv4 = ConvBN(32, 128, 7, 1, padding="VALID", **kw)
        self.fc1 = Linear(128, 32, **kw)
        self.fc2 = Linear(32, 3, **kw)

    def forward(self, x):
        x = self.conv4(self.conv3(self.conv2(self.conv1(x))))
        return self.fc2(self.fc1(x.reshape(x.shape[0], -1)))


class PFLD(nn.Module):
    """``forward`` returns the backbone's (landmarks, features);
    ``loss_fn`` runs the auxiliary net on the features and takes (landmarks,
    euler angles[, attributes]) as its target."""

    def __init__(self, num_landmarks=68, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.backbone = PFLDBackbone(num_landmarks, device=device,
                                     generator=generator)
        self.auxiliarynet = AuxiliaryNet(device=device, generator=generator)

    def forward(self, x):
        return self.backbone(x)

    def loss_fn(self, output, target):
        landmarks, features = output
        angle = self.auxiliarynet(features)
        attributes = target[2] if len(target) == 3 else None
        return pfld_loss(landmarks, angle, target[0], target[1], attributes)
