"""Space-to-depth rewrites (counterpart of
``tlxcv_tpu/ops/space_to_depth.py``).

Exact layout rewrites, with no retraining:

- the 7x7 stride-2 pad-3 stem conv becomes a 4x4 stride-1 VALID conv over
  the image blocked 2x2 into channels (``SpaceToDepthStem``):

      y[i,j] = sum_{d,e} w7[d,e] x[2i+d-3, 2j+e-3]          (pad 3)
             = sum_{u,v,a,b} w8[2u+a, 2v+b] z[i+u, j+v, (a,b,c)]

  with w8 = w7 zero-padded by one row and column at the top and left, and
  z the space-to-depth of x padded (4, 2) per axis, so that the VALID
  conv gives exactly H/2 x W/2 and no slice sits between the conv and the
  BatchNorm after it (``ops.quant``'s fold keeps working);
- a 3x3 stride-1 SAME conv becomes a 3x3 SAME conv on the (ph, pw)-blocked
  layout (``remap_conv3x3_s1``, used by HRNet's ``SpaceToDepthBranch``).

Both were TPU layout tricks (channels widened toward the MXU's lane
width); on the card they are kept because they are exact, and whether
cuDNN gains from them is measured, not assumed.  The weight remaps are
numpy on HWIO kernels, as in the reference; the port's convs hold OIHW and
convert at the boundary.  Apply them before quantization.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import Conv2d

__all__ = ["SpaceToDepthStem", "convert_stem_to_space_to_depth",
           "block_space_to_depth", "unblock_space_to_depth",
           "remap_conv3x3_s1"]


def block_space_to_depth(x, ph, pw):
    """NHWC -> [N, H/ph, W/pw, ph*pw*C], channel order (a, b, c)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ph, ph, w // pw, pw, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // ph, w // pw,
                                               ph * pw * c)


def unblock_space_to_depth(z, ph, pw, c):
    """Inverse of :func:`block_space_to_depth`."""
    b, hh, ww, _ = z.shape
    return z.reshape(b, hh, ww, ph, pw, c).permute(0, 1, 3, 2, 4, 5) \
            .reshape(b, ph * hh, pw * ww, c)


def remap_conv3x3_s1(w, ph, pw):
    """Exact blocked twin of a stride-1 3x3 SAME conv kernel (HWIO numpy).

    A 3x3 SAME conv on [H, W, c] equals a 3x3 SAME conv on the
    (ph, pw)-blocked layout with kernel (zero where d or e leave [0, 2]):

        W_blk[u+1, v+1, (a,b,c), (α,β,o)] = w[ph*u+a+1-α, pw*v+b+1-β, c, o]

    The padded block border multiplies only structural zeros, so SAME
    padding in block space reproduces SAME padding in pixel space exactly
    for H % ph == W % pw == 0.
    """
    w = np.asarray(w)
    if w.shape[:2] != (3, 3):
        raise ValueError(f"3x3 kernels only, got {w.shape}")
    c, o = w.shape[2], w.shape[3]
    wb = np.zeros((3, 3, ph, pw, c, ph, pw, o), w.dtype)
    for U in range(3):
        for a in range(ph):
            for al in range(ph):
                d = ph * (U - 1) + a + 1 - al
                if not 0 <= d <= 2:
                    continue
                for V in range(3):
                    for bb in range(pw):
                        for be in range(pw):
                            e = pw * (V - 1) + bb + 1 - be
                            if 0 <= e <= 2:
                                wb[U, V, a, bb, :, al, be, :] = w[d, e]
    return wb.reshape(3, 3, ph * pw * c, ph * pw * o)


def oihw_to_hwio(w):
    return w.detach().cpu().numpy().transpose(2, 3, 1, 0)


def conv_from_hwio(w_hwio, cin, cout, kernel, padding, bias, device):
    """A Conv2d whose weight is ``w_hwio`` (numpy HWIO), taken as its
    initial value: no random number is drawn, so building it moves no
    generator."""
    w = torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))
    return Conv2d(cin, cout, kernel, stride=1, padding=padding, bias=bias,
                  w_init=lambda shape, **kw: w.to(kw["device"]),
                  device=device)


class SpaceToDepthStem(nn.Module):
    """Drop-in replacement for a 7x7/2 pad-3 stem ``Conv2d``."""

    def __init__(self, conv: Conv2d):
        super().__init__()
        w = conv.weight
        if tuple(w.shape[2:]) != (7, 7) or tuple(conv.stride) != (2, 2):
            raise ValueError(f"not a 7x7/2 stem conv: {tuple(w.shape)}, "
                             f"stride {conv.stride}")
        if conv.padding != ((3, 3), (3, 3)):
            raise ValueError(f"stem must be pad-3, got {conv.padding}")
        if conv.groups != 1 or tuple(conv.dilation) != (1, 1):
            raise ValueError("grouped/dilated stems not supported")
        if w.dtype == torch.int8:
            raise ValueError("apply space-to-depth BEFORE quantization")
        w7 = oihw_to_hwio(w)
        c, o = w7.shape[2], w7.shape[3]
        w8 = np.zeros((8, 8, c, o), w7.dtype)
        w8[1:, 1:] = w7
        # [8,8,C,O] -> (u,a,v,b,C,O) -> (u,v,a,b,C,O) -> [4,4,4C,O]; the
        # channel order (a,b,c) is the reshape-based space-to-depth's below
        w4 = w8.reshape(4, 2, 4, 2, c, o).transpose(0, 2, 1, 3, 4, 5) \
               .reshape(4, 4, 4 * c, o)
        self.in_channels = c
        self.conv = conv_from_hwio(w4, 4 * c, o, 4, 0, conv.bias is not None,
                                   w.device)
        if conv.bias is not None:
            self.conv.bias = conv.bias

    def forward(self, x):
        b, h, w, c = x.shape
        # (4, 2|3) padding: left 4 realigns the pad-3 window to even
        # offsets; right 2 (3 for odd sizes) lands the VALID conv on exactly
        # ceil(H/2) outputs with no trailing slice
        x = F.pad(x, (0, 0, 4, 2 + w % 2, 4, 2 + h % 2))
        return self.conv(block_space_to_depth(x, 2, 2))


def convert_stem_to_space_to_depth(model, attr="conv1"):
    """Swap ``model.<attr>`` (a 7x7/2 stem conv) for its exact
    space-to-depth rewrite.  Returns the model."""
    conv = getattr(model, attr)
    if isinstance(conv, SpaceToDepthStem):
        return model
    setattr(model, attr, SpaceToDepthStem(conv))
    return model
