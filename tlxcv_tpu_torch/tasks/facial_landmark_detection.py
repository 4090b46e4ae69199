"""Facial landmark detection task and the NME metric (counterpart of
``tlxcv_tpu/tasks/facial_landmark_detection.py``)."""
from __future__ import annotations

import numpy as np
from torch import nn

from ..utils.metrics import Metric, as_numpy

__all__ = ["FacialLandmarkDetection", "NME", "draw_landmarks"]


class FacialLandmarkDetection(nn.Module):
    def __init__(self, backbone: nn.Module):
        super().__init__()
        self.backbone = backbone

    def loss_fn(self, output, target):
        return self.backbone.loss_fn(output, target)

    def forward(self, inputs):
        return self.backbone(inputs)

    def predict(self, inputs):
        """The landmarks alone, [B, 2 * points]."""
        landmarks, _ = self.backbone(inputs)
        return landmarks


def draw_landmarks(image, landmarks, color=(0, 255, 0), radius=2):
    """Host-side drawing with OpenCV, imported here so that the package
    does not need it."""
    import cv2

    img = np.ascontiguousarray(as_numpy(image))
    pts = as_numpy(landmarks).reshape(-1, 2)
    for x, y in pts:
        cv2.circle(img, (int(x), int(y)), radius, color, -1)
    return img


class NME(Metric):
    """Normalised mean error: the mean point distance over the
    inter-ocular distance (outer eye corners 36 and 45) for 68 points,
    over sqrt(points) otherwise."""

    def __init__(self, num_points=68):
        self.num_points = num_points
        self.reset()

    def update(self, y_pred, y_true):
        if isinstance(y_pred, (tuple, list)):
            y_pred = y_pred[0]  # the model's (landmarks, features)
        if isinstance(y_true, (tuple, list)):
            y_true = y_true[0]
        pred = as_numpy(y_pred)
        true = as_numpy(y_true)
        pred = pred.reshape(pred.shape[0], -1, 2)
        true = true.reshape(true.shape[0], -1, 2)
        for p, t in zip(pred, true):
            if self.num_points == 68:
                norm = np.linalg.norm(t[36] - t[45])
            else:
                norm = np.sqrt(t.shape[0])
            dist = np.mean(np.linalg.norm(p - t, axis=1))
            self.errors.append(dist / max(norm, 1e-6))

    def result(self):
        return float(np.mean(self.errors)) if self.errors else 0.0

    def reset(self):
        self.errors = []

