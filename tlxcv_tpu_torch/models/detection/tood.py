"""TOOD's deformable sampling step (counterpart of
``tlxcv_tpu/models/detection/tood.py``), NHWC: only ``_bilinear_sample``,
which ``deform.DeformConv2d`` imports.  The rest of TOOD (its task
decomposition, alignment head and loss) comes with RetinaNet and GFL, the
next detectors to port."""
from __future__ import annotations

import torch

__all__ = []


def _bilinear_sample(feat, xs, ys):
    """Sample ``feat`` [N, H, W, C] at fractional pixel coordinates ``xs``,
    ``ys`` [N, h, w] (any h, w) -> [N, h, w, C], clamped to the border
    (a sample outside the map takes the nearest edge's value, not zero):
    four corner gathers, blended along x, then along y."""
    n, h, w, c = feat.shape
    xs = xs.clamp(0.0, w - 1.0)
    ys = ys.clamp(0.0, h - 1.0)
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    x1 = torch.clamp_max(x0 + 1, w - 1.0)
    y1 = torch.clamp_max(y0 + 1, h - 1.0)
    wx = (xs - x0)[..., None]
    wy = (ys - y0)[..., None]
    flat = feat.reshape(n, h * w, c)
    rows = torch.arange(n, device=feat.device)[:, None]

    def g(yi, xi):
        idx = (yi * w + xi).to(torch.int64).reshape(n, -1)
        return flat[rows, idx].reshape(*xs.shape, c)

    top = g(y0, x0) * (1 - wx) + g(y0, x1) * wx
    bot = g(y1, x0) * (1 - wx) + g(y1, x1) * wx
    return top * (1 - wy) + bot * wy
