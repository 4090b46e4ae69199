"""Modulated deformable convolution (counterpart of
``tlxcv_tpu/models/detection/deform.py``), NHWC, in plain torch: k·k
bilinear samples of the input at learned offsets (``tood.
_bilinear_sample``: four corner gathers each, clamped to the border),
each scaled by its sigmoid mask, stacked, and one 1x1 conv over the
stacked taps.  This is not torchvision's DCN, which reads zeros outside
the map.  No kernel of ours runs here; the sampler is a candidate for one
(``PERF.md`` §7)."""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...core import init as I
from ...device import resolve_device
from .tood import _bilinear_sample

__all__ = ["DeformConv2d"]


class DeformConv2d(tnn.Module):
    """k x k modulated deformable conv (DCNv2), stride 1, 'same' size.

    ``offset_conv`` (zero-initialised, weights and bias, so the layer
    starts as a dense conv with every tap at half weight) gives for tap t
    (row-major over the window) its y offset in channel 2t, its x offset
    in 2t + 1 and, with ``modulated``, its mask logit in 2k² + t.  The
    samples are taken in f32 and cast to x's dtype before ``proj``, the
    [k·k·C_in -> C_out] 1x1 conv whose input channels run tap-major."""

    def __init__(self, c_in, c_out, kernel_size=3, modulated=True,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        k = kernel_size
        self.k = k
        self.modulated = modulated
        out_off = 2 * k * k + (k * k if modulated else 0)
        self.offset_conv = nn.Conv2d(c_in, out_off, 3, padding=1,
                                     w_init=I.zeros, b_init=I.zeros,
                                     device=device)
        self.proj = nn.Conv2d(k * k * c_in, c_out, 1, device=device,
                              generator=generator)

    def sample(self, x):
        """The stacked taps [N, H, W, k·k·C_in] in x's dtype: the sampler,
        everything but ``proj``."""
        n, h, w, _ = x.shape
        k = self.k
        half = (k - 1) // 2
        off = self.offset_conv(x).float()
        xf = x.float()
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=x.device),
            torch.arange(w, dtype=torch.float32, device=x.device),
            indexing="ij")
        taps = []
        for t in range(k * k):
            dy, dx = t // k - half, t % k - half
            v = _bilinear_sample(xf, gx + dx + off[..., 2 * t + 1],
                                 gy + dy + off[..., 2 * t])
            if self.modulated:
                v = v * torch.sigmoid(off[..., 2 * k * k + t])[..., None]
            taps.append(v)
        return torch.cat(taps, -1).to(x.dtype)

    def forward(self, x):
        return self.proj(self.sample(x))
